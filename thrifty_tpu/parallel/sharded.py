"""Sharded detection over a device mesh.

Two levels of parallel execution, replacing the reference's
process/machine-level distribution (SURVEY.md section 2.4):

1. :func:`batch_detect_sharded` -- blocks already carry their history
   halo (e.g. read from a .card file), so the batch axis is
   embarrassingly parallel: shard [B, N] over every mesh device.

2. :func:`make_stream_detector` -- the sharded replacement for the
   reference's overlap-save readers: each device holds a *contiguous
   chunk of new samples*; the 4920-sample history halo is exchanged
   between time-neighbor devices with a single ``lax.ppermute``
   (the collective analog of fastcard's memcpy of the previous block's
   tail, fastcard/raw_reader.c:22-30), then each device unfolds its
   chunk into overlapped blocks locally and runs the batched detector.
   Detections can be all-gathered for matchmaking (the reference ships
   .toad files to a server; here it is one collective).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from thrifty_tpu.dsp import unfold as unfold_mod
from thrifty_tpu.parallel.mesh import AXIS_RX, AXIS_TIME


def batch_detect_sharded(detector, mesh):
    """Jit the batched detector with the block axis sharded over the mesh.

    Returns a function blocks [B, N] -> output dict, with B sharded over
    every device (both mesh axes).  Each block carries its own halo, so
    no communication is needed -- pure data parallelism.
    """
    data_spec = P((AXIS_RX, AXIS_TIME), None)
    in_sharding = NamedSharding(mesh, data_spec)
    out_sharding = NamedSharding(mesh, P((AXIS_RX, AXIS_TIME)))
    return jax.jit(
        detector._detect_batch,
        in_shardings=in_sharding,
        out_shardings=out_sharding,
    )


def make_stream_detector(detector, num_rx, blocks_per_shard, mesh,
                         gather=False):
    """Build a jitted halo-exchange streaming detector.

    The returned function takes ``streams`` of shape
    ``[num_rx, T*blocks_per_shard*new_len]`` complex64 -- the raw
    contiguous sample streams (new samples only, no halos) -- sharded
    ``P(rx, time)``, and returns the detector's output dict with arrays
    shaped ``[num_rx, total_blocks]``.

    With ``gather=True`` the outputs are all-gathered inside the same
    program (replicated outputs), modelling the detect->server edge.
    """
    cfg = detector.config
    n = cfg.block_len
    history = cfg.history_len
    new_len = n - history
    num_time = mesh.shape[AXIS_TIME]
    if mesh.shape[AXIS_RX] != num_rx:
        raise ValueError("mesh rx axis ({}) != num_rx ({})".format(
            mesh.shape[AXIS_RX], num_rx))
    if blocks_per_shard < 1:
        raise ValueError("blocks_per_shard must be >= 1")
    if history > new_len:
        # (This also guarantees history <= the per-shard chunk, since
        # chunk_len = blocks_per_shard * new_len >= new_len.)
        raise ValueError(
            "history ({}) exceeds new samples per block ({}): the "
            "unique-lag window would be empty".format(history, new_len))

    def local_detect(chunk):
        # chunk: [rx_local, chunk_len] new samples of this time shard.
        rx_local = chunk.shape[0]
        # Halo exchange: receive the previous shard's tail.  Time-shard 0
        # has no predecessor; ppermute leaves its halo zero (matching the
        # zero-padded first block of the reference readers).
        perm = [(i, i + 1) for i in range(num_time - 1)]
        # Explicit start offset: `[:, -history:]` with history 0 would
        # select the WHOLE chunk as the halo (same -0 pitfall defended
        # in io/stream.py's splice).
        tail = chunk[:, chunk.shape[1] - history:]
        halo = lax.ppermute(tail, AXIS_TIME, perm) if num_time > 1 \
            else jnp.zeros_like(tail)
        full = jnp.concatenate([halo, chunk], axis=1)
        # Local overlap-save unfold as pure reshapes (the shared trick,
        # dsp/unfold.overlap_rows).
        blocks = unfold_mod.overlap_rows(full, n, history)
        out = detector._detect_batch(
            blocks.reshape(rx_local * blocks_per_shard, n))
        out = jax.tree.map(
            lambda a: a.reshape((rx_local, blocks_per_shard) + a.shape[1:]),
            out)
        # Global block index of each local block.
        t = lax.axis_index(AXIS_TIME)
        out["block_idx"] = jnp.broadcast_to(
            t * blocks_per_shard + jnp.arange(blocks_per_shard),
            (rx_local, blocks_per_shard)).astype(jnp.int32)
        if gather:
            # Ship every shard's detection table to every device (the
            # detect -> matchmaking edge; one collective instead of scp).
            out = jax.tree.map(
                lambda a: _gather_2d(a), out)
        return out

    def _gather_2d(a):
        a = lax.all_gather(a, AXIS_TIME, axis=1, tiled=True)
        return lax.all_gather(a, AXIS_RX, axis=0, tiled=True)

    out_spec = P() if gather else P(AXIS_RX, AXIS_TIME)
    shmapped = jax.shard_map(
        local_detect,
        mesh=mesh,
        in_specs=P(AXIS_RX, AXIS_TIME),
        out_specs=out_spec,
        # gather=True returns value-replicated outputs (all_gather over
        # both axes); the varying-mesh-axes check cannot see that.
        check_vma=not gather,
    )
    return jax.jit(shmapped)


def make_stream_detector_gspmd(detector, total_blocks, mesh):
    """GSPMD variant of the streaming detector: no shard_map.

    The same unfold+detect program is written as one global jit with
    sharding annotations (streams in P(rx, time), outputs in
    P(rx, time)); XLA's SPMD partitioner inserts the history halo
    exchange itself where the overlapped reshape crosses shard
    boundaries.  This is the "annotate shardings, let XLA insert
    collectives" formulation -- semantically identical to
    :func:`make_stream_detector`, and the fast path on backends where
    manual shard_map programs are poorly supported.

    Takes streams [num_rx, total_blocks*new_len] and returns the
    detector output dict shaped [num_rx, total_blocks] plus block_idx.
    """
    cfg = detector.config
    n = cfg.block_len
    history = cfg.history_len
    new_len = n - history
    if history > new_len:
        raise ValueError("history exceeds new samples per block")

    def global_detect(streams):
        num_rx = streams.shape[0]
        s = total_blocks
        full = jnp.concatenate(
            [jnp.zeros((num_rx, history), streams.dtype), streams],
            axis=1)
        blocks = unfold_mod.overlap_rows(full, n, history)
        out = detector._detect_batch(blocks.reshape(num_rx * s, n))
        out = jax.tree.map(
            lambda a: a.reshape((num_rx, s) + a.shape[1:]), out)
        out["block_idx"] = jnp.broadcast_to(
            jnp.arange(s, dtype=jnp.int32)[None, :], (num_rx, s))
        return out

    in_sharding = NamedSharding(mesh, P(AXIS_RX, AXIS_TIME))
    out_sharding = NamedSharding(mesh, P(AXIS_RX, AXIS_TIME))
    return jax.jit(global_detect, in_shardings=in_sharding,
                   out_shardings=out_sharding)


def shard_stream(streams, mesh):
    """Place host stream arrays [R, L] onto the mesh with P(rx, time).

    Works in multi-controller (jax.distributed) runs too: every
    process passes the SAME global array and contributes only the
    shards its own devices address (each process feeds the receivers
    it serves; here the full array stands in for deterministic
    test/bench streams).
    """
    import numpy as np

    sharding = NamedSharding(mesh, P(AXIS_RX, AXIS_TIME))
    if jax.process_count() > 1:
        arr = np.asarray(streams)
        return jax.make_array_from_callback(
            arr.shape, sharding, lambda idx: arr[idx])
    return jax.device_put(streams, sharding)
