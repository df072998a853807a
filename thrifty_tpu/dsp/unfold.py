"""Device-side overlap-save unfold of a contiguous sample stream.

Shared by the single-device detector (`BatchDetector.detect_raw_stream`)
and the capture carrier gate (`CarrierGate.gate_stream`): both ship
the stream's NEW samples (packed uint16 I/Q byte pairs) plus a
device-resident history carry, and rebuild the overlap-save rows on
device (reference geometry: fastcard/raw_reader.c:22-30).
"""

from __future__ import annotations

import jax.numpy as jnp


ZERO_SIGNAL_U16 = 0x8080  # two 0x80 raw bytes = one zero-amplitude sample


class StreamCarry:
    """Host-side device-carry protocol for streaming overlap-save.

    Owns the uint16 history carry (pre-stream state = zero-signal
    ``0x8080`` byte pairs) and the uint8 -> packed-uint16
    little-endian view that matches the device bitcast unpacking --
    ONE implementation shared by the detector
    (``BatchDetector.detect_raw_stream``) and the capture gate
    (``CarrierGate.gate_stream``), so the carry convention can never
    bifurcate between capture gating and detection numerics.
    """

    def __init__(self, history_len):
        self.history_len = history_len
        self.carry = None  # device array once streaming starts

    def reset(self):
        """Back to the zero-signal pre-stream state."""
        self.carry = jnp.full((self.history_len,), ZERO_SIGNAL_U16,
                              dtype=jnp.uint16)

    def call(self, stream_fn, new_raw, new_len=None):
        """Run jitted ``(new_u16, carry) -> (out, new_carry)``,
        advancing the carry.  ``new_len``: optional whole-number-of-
        blocks validation for the byte count."""
        import numpy as np

        new_raw = np.asarray(new_raw, dtype=np.uint8)
        if new_len is not None and new_raw.size % (2 * new_len):
            raise ValueError("stream bytes must be a whole number of "
                             "blocks (pad the final batch)")
        if self.carry is None:
            self.reset()
        out, self.carry = stream_fn(new_raw.view(np.uint16), self.carry)
        return out


def overlap_rows(full, block_len, history_len):
    """Pure-reshape overlap-save: [..., history + B*new] -> [..., B, block].

    Row s spans ``full[..., s*new : s*new + block]`` -- the one unfold
    trick shared by the device stream carry (:func:`unfold_stream`),
    the shard_map halo path, and the GSPMD twin
    (parallel/sharded.py); requires ``history_len <= new`` (true for
    any usable unique-window geometry).
    """
    new = block_len - history_len
    lead = full.shape[:-1]
    b = (full.shape[-1] - history_len) // new
    head = full[..., : b * new].reshape(lead + (b, new))
    pad = [(0, 0)] * len(lead) + [(0, new - history_len)]
    tail = jnp.pad(full[..., new:], pad).reshape(
        lead + (b, new))[..., :history_len]
    return jnp.concatenate([head, tail], axis=-1)


def unfold_stream(new_u16, carry_u16, block_len, history_len):
    """uint16 new samples [B*new_len] + carry [history_len] ->
    (rows [B, block_len], new_carry [history_len]).

    Row s spans ``full[s*new : s*new + block]`` where ``full`` is the
    carry-prefixed stream -- i.e. ``[history | new]`` per block, the
    standard overlap-save layout.  When history <= advance (true for
    any usable unique-window geometry) the unfold is pure reshapes
    (same trick as the sharded streaming program,
    parallel/sharded.py); other geometries fall back to a gather.
    """
    new = block_len - history_len
    if new_u16.shape[0] == 0 or new_u16.shape[0] % new:
        # Shapes are static at trace time, so validate HERE rather
        # than relying on the caller's optional host-side check: a
        # floored-away remainder would silently skip those samples as
        # any block's unique region while the carry advanced past
        # them (undetected transmissions + misaligned stream).
        raise ValueError(
            "stream must carry a whole positive number of blocks: "
            "{} samples is not a multiple of new_len={} (pad the "
            "final batch)".format(new_u16.shape[0], new))
    stream = jnp.concatenate([carry_u16, new_u16])
    b = new_u16.shape[0] // new
    if history_len <= new:
        rows = overlap_rows(stream, block_len, history_len)
    else:
        idx = (jnp.arange(b, dtype=jnp.int32)[:, None] * new
               + jnp.arange(block_len, dtype=jnp.int32)[None, :])
        rows = jnp.take(stream, idx, axis=0)
    return rows, stream[stream.shape[0] - history_len:]
