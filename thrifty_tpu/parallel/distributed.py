"""Multi-process runtime initialisation.

Several processes (one per card, or one per host) can drive one
(rx, time) mesh: `jax.distributed` stitches them into one logical
device set.  The cards of one host are joined all to all, so the mesh
follows the algorithm alone: the frequent collective -- the
4920-sample history halo between time-neighbouring shards -- and the
final detection all-gather cost the same on any pair of cards.

The sharded programs this feeds are validated on virtual multi-device
meshes (tests/test_sharded.py, tests/test_multihost.py,
__graft_entry__.dryrun_multichip).
"""

from __future__ import annotations

import jax


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, **kwargs):
    """Initialise the multi-host runtime (idempotent wrapper).

    Arguments as ``jax.distributed.initialize``; a single machine
    gives no cluster environment, so pass ``coordinator_address``
    (``localhost:<port>``), ``num_processes`` and ``process_id``.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            **kwargs,
        )
    except RuntimeError as e:
        # Only repeat-initialization is ok.  jax has phrased that error
        # both as "...is already initialized" and as "...should only be
        # called once." across versions; match both.
        msg = str(e)
        if "already" not in msg and "only be called once" not in msg:
            raise  # genuinely failed
