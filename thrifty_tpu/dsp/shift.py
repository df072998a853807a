"""Batched carrier removal (frequency shift).

Two modes, matching the reference's two numerical variants:

- ``fractional``: shift by a fractional number of bins using the shift
  theorem -- multiply the time-domain block by a phase ramp, then FFT
  (reference thrifty/carrier_sync.py:222-238).  Batched: one fused
  elementwise ramp multiply + one batched FFT.

- ``integer``: circular roll of the FFT by the integer peak bin
  (fastdet/corr_detector.cpp:13-17,178-182).  Batched as a gather --
  no second FFT, the fastest mode.
"""

from __future__ import annotations

import jax.numpy as jnp


def fractional_shift_fft(blocks, shift, impl="auto",
                         precision="highest", ramp="full"):
    """FFT of blocks shifted by a (fractional) number of bins.

    ``blocks``: [..., N] complex time-domain samples.
    ``shift``: [...] float, number of bins to shift by (positive moves
    energy to higher bins).  Uses ramp exp(2j*pi*shift*(n/N - 0.5)); the
    -0.5 term only contributes a constant phase and keeps parity with the
    reference formula.  ``impl``: FFT implementation (dsp.mxu_fft).
    ``ramp='separable'`` evaluates the ramp in factored form fused
    into the four-step transform (mxu_fft.fft_ramped: 128x fewer exp
    evaluations, no materialized [..., N] ramp array); 'full' is the
    explicit reference-shaped product.
    """
    from thrifty_tpu.dsp import mxu_fft

    # Both forms live in mxu_fft.fft_ramped -- ONE implementation of
    # the parity-critical reference ramp formula (its full-ramp branch
    # is also the separable path's non-four-step fallback).
    return mxu_fft.fft_ramped(blocks, shift, impl, precision,
                              separable=(ramp == "separable"))


def integer_roll_fft(fft, shift, max_start=None):
    """Batched circular roll of FFT arrays by per-element integer shifts.

    ``out[..., k] = fft[..., (k - shift) % N]`` -- same as np.roll along
    the last axis with a per-batch shift.

    Implementation note: formulated as a per-row ``lax.dynamic_slice``
    of the row extended by its own wrapped head -- one contiguous
    N-element block copy at a dynamic offset -- NOT an elementwise
    ``take_along_axis`` gather (chosen for a compiler that lowered the
    gather to scalar loads; not yet re-measured on the GPU).  The slice
    form is a permutation, so results stay BITWISE identical to
    np.roll (the fastdet golden contract).

    ``max_start``: static upper bound (exclusive) on ``(-shift) % N``,
    when the caller can prove one -- carrier rolls are bounded by the
    carrier window's top FFT index, so the wrapped extension shrinks
    from N columns to ~the window width.  Out-of-bound starts cannot
    read out of range (dynamic_slice clamps); the bound is the
    caller's correctness contract.
    """
    import jax
    from jax import lax

    n = fft.shape[-1]
    lead = fft.shape[:-1]
    flat = fft.reshape((-1, n))
    s = jnp.broadcast_to(shift, lead).reshape((-1,)).astype(jnp.int32)
    start = (-s) % n  # out[k] = extended[start + k]
    pad = n if max_start is None else min(int(max_start), n)
    extended = jnp.concatenate([flat, flat[:, :pad]], axis=-1)
    out = jax.vmap(
        lambda row, a: lax.dynamic_slice(row, (a,), (n,)))(extended,
                                                           start)
    return out.reshape(fft.shape)
