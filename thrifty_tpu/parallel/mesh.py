"""Device mesh construction for sharded detection.

The workload's two natural parallel axes (SURVEY.md section 2.4):

- ``rx``: receivers are independent until matchmaking -- a pure data
  parallel axis (the reference runs receivers on separate machines).
- ``time``: the sample stream is split into overlap-save blocks; blocks
  are independent given a history halo -- the time axis shards across
  devices with a halo exchange (the reference's block decomposition,
  thrifty/block_data.py:70-98, mapped onto collectives).
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


AXIS_RX = "rx"
AXIS_TIME = "time"


def make_mesh(num_rx: int = 1, num_time: int = None, devices=None) -> Mesh:
    """Build an (rx, time) mesh over the available devices.

    ``num_time`` defaults to devices/num_rx.  The rx axis is the outer
    axis.  The cards of a host are joined all to all, so the layout
    follows the algorithm: receivers are independent, and the
    time-halo exchange runs between neighbours on the inner axis.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if num_time is None:
        if n % num_rx:
            raise ValueError("device count not divisible by num_rx")
        num_time = n // num_rx
    if num_rx * num_time > n:
        raise ValueError(
            "mesh ({} x {}) larger than device count {}".format(
                num_rx, num_time, n))
    grid = np.asarray(devices[: num_rx * num_time]).reshape(
        num_rx, num_time)
    return Mesh(grid, (AXIS_RX, AXIS_TIME))
