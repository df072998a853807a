"""Sub-bin carrier frequency interpolation by Dirichlet-kernel fitting.

The carrier is a finite-duration sinusoid, so its DFT magnitude around the
peak follows |A * D(x - delta)| where D is the Dirichlet kernel.  The
reference fits (A, delta) per detection with scipy curve_fit
(thrifty/carrier_sync.py:150-196) -- an iterative host-side solver that
cannot run under jit.  Here the fit is re-designed as a *fixed-iteration
damped Gauss-Newton solve with an analytic Jacobian*, vectorized over the
whole batch: every iteration is a handful of [B, width] element-wise ops
and a closed-form 2x2 linear solve, which XLA fuses into a few VPU loops.

Simpler batched interpolators (parabolic / quadratic-polyfit, cf.
thrifty/carrier_sync.py:199-219) are provided as alternatives.
"""

from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp
from jax import lax


def dirichlet_kernel(x, block_len, carrier_len):
    """Dirichlet kernel D(x) = sin(pi*W*x/N) / (W * sin(pi*x/N)).

    D(0) = 1; near x=0 a Taylor form is used for numerical stability.
    Works on numpy or jax arrays.
    """
    xp = jnp if isinstance(x, jnp.ndarray) else np
    n, w = block_len, carrier_len
    a = np.pi / n
    x = xp.asarray(x)
    num = xp.sin(a * w * x)
    den = xp.sin(a * x)
    # Taylor about 0: D(x) ~= 1 - a^2 x^2 (W^2-1)/6
    taylor = 1.0 - (a * a) * x * x * (w * w - 1.0) / 6.0
    safe_den = xp.where(xp.abs(x) < 1e-2, 1.0, den)
    return xp.where(xp.abs(x) < 1e-2, taylor, num / (w * safe_den))


def dirichlet_kernel_deriv(x, block_len, carrier_len):
    """Analytic derivative dD/dx of the Dirichlet kernel."""
    xp = jnp if isinstance(x, jnp.ndarray) else np
    n, w = block_len, carrier_len
    a = np.pi / n
    x = xp.asarray(x)
    sin_wx, cos_wx = xp.sin(a * w * x), xp.cos(a * w * x)
    sin_x, cos_x = xp.sin(a * x), xp.cos(a * x)
    num = a * w * cos_wx * sin_x - a * sin_wx * cos_x
    den = w * sin_x * sin_x
    # Taylor about 0: D'(x) ~= -a^2 x (W^2-1)/3
    taylor = -(a * a) * x * (w * w - 1.0) / 3.0
    safe_den = xp.where(xp.abs(x) < 1e-2, 1.0, den)
    return xp.where(xp.abs(x) < 1e-2, taylor, num / safe_den)


def dirichlet_weights(filter_len: int, block_len: int, carrier_len: int):
    """Unit-energy Dirichlet-shaped weights for peak matched filtering."""
    rel = np.arange(-(filter_len // 2), filter_len // 2 + 1)
    coeffs = dirichlet_kernel(rel, block_len, carrier_len)
    return coeffs / np.sqrt(np.sum(coeffs**2))


def gather_neighborhood(values, peak_idx, offsets):
    """Gather values[..., peak_idx + k] for k in offsets, with wrap.

    Works on magnitude or complex arrays (the detector's kernel path
    gathers complex neighborhoods and takes |.| afterwards).
    """
    n = values.shape[-1]
    idx = (peak_idx[..., None] + offsets) % n
    return jnp.take_along_axis(values, idx, axis=-1)




def make_dirichlet_interpolator(
    block_len: int,
    carrier_len: int,
    width: int = 6,
    iters: int = 12,
    damping: float = 1e-4,
    return_amplitude: bool = False,
):
    """Build a batched sub-bin interpolator fitting |A*D(x-delta)|.

    Returns a function ``interp(fft_mag[..., N], peak_idx[...]) -> delta``
    (or ``(amplitude, delta)``).  The fit uses ``width+1`` points centred
    on the peak and a fixed number of damped Gauss-Newton iterations --
    jit/vmap/shard_map friendly (no data-dependent control flow).
    """
    xs = np.arange(-(width // 2), width // 2 + 1).astype(np.float64)

    kernel = functools.partial(
        dirichlet_kernel, block_len=block_len, carrier_len=carrier_len
    )
    kernel_deriv = functools.partial(
        dirichlet_kernel_deriv, block_len=block_len, carrier_len=carrier_len
    )

    def interpolate(fft_mag, peak_idx, values=None):
        # ``values`` bypasses the gather with a precomputed [..., P]
        # magnitude neighborhood (used when |FFT| is never materialized).
        if values is None:
            offs = jnp.asarray(xs.astype(np.int64))
            y = gather_neighborhood(fft_mag, peak_idx, offs)  # [..., P]
        else:
            y = values
        dtype = y.dtype
        xgrid = jnp.asarray(xs, dtype=dtype)

        amp0 = y[..., len(xs) // 2]
        delta0 = jnp.zeros_like(amp0)

        def body(carry, _):
            amp, delta = carry
            u = xgrid - delta[..., None]
            d = kernel(u)
            absd = jnp.abs(d)
            resid = y - amp[..., None] * absd
            # Jacobian of the model m = A*|D(x-delta)|:
            #   dm/dA = |D|,  dm/ddelta = -A * sign(D) * D'(x-delta)
            j_a = absd
            j_d = -amp[..., None] * jnp.sign(d) * kernel_deriv(u)
            # Damped normal equations, closed-form 2x2 solve per batch elem.
            a11 = jnp.sum(j_a * j_a, axis=-1) * (1.0 + damping)
            a22 = jnp.sum(j_d * j_d, axis=-1) * (1.0 + damping) + 1e-20
            a12 = jnp.sum(j_a * j_d, axis=-1)
            b1 = jnp.sum(j_a * resid, axis=-1)
            b2 = jnp.sum(j_d * resid, axis=-1)
            det = a11 * a22 - a12 * a12
            det = jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
            step_a = (a22 * b1 - a12 * b2) / det
            step_d = (a11 * b2 - a12 * b1) / det
            # The true offset is sub-bin; clamp to keep iterates in-basin.
            new_delta = jnp.clip(delta + step_d, -1.0, 1.0)
            return (amp + step_a, new_delta), None

        (amp, delta), _ = lax.scan(body, (amp0, delta0), None, length=iters)
        if return_amplitude:
            return amp, delta
        return delta

    return interpolate


def parabolic_interpolate(mag, peak_idx, clip=None, values=None):
    """Batched 3-point parabolic sub-bin interpolation.

    offset = (c - a) / (4b - 2a - 2c) on neighbours (a, b, c)
    (reference thrifty/carrier_sync.py:199-204).  ``clip`` bounds the
    offset to +-clip; fastdet clips its carrier offset to +-0.5
    (fastdet/corr_detector.cpp:88-101), the Python reference does not.
    ``values`` bypasses the gather with a precomputed [..., 3]
    neighborhood (carrier bins wrap circularly, so no bounds mask).
    """
    if values is None:
        offs = jnp.asarray([-1, 0, 1])
        y = gather_neighborhood(mag, peak_idx, offs)
    else:
        y = values
    a, b, c = y[..., 0], y[..., 1], y[..., 2]
    den = 4.0 * b - 2.0 * a - 2.0 * c
    den = jnp.where(jnp.abs(den) < 1e-30,
                    jnp.where(den < 0.0, -1e-30, 1e-30), den)
    offset = (c - a) / den
    if clip is not None:
        offset = jnp.clip(offset, -clip, clip)
    return offset


def gaussian_interpolate(mag, peak_idx, clip=None, values=None):
    """Batched 3-point Gaussian (log-parabolic) sub-bin interpolation.

    offset = (ln c - ln a) / (4 ln b - 2 ln a - 2 ln c) on neighbours
    (a, b, c) -- the reference's experimental carrier interpolator
    (thrifty/experimental/carrier_interpolators.py:48-54).

    Deliberately NOT shared with xcorr.gaussian_interpolate: the
    carrier surface wraps FFT bins (circular gather) and follows the
    carrier_interpolators.py guards, while the correlation surface
    clamps at array edges with soa_estimator.py's clip/bounds rules --
    both variants are pinned by golden tests against the reference.
    ``values`` bypasses the gather with a precomputed [..., 3]
    neighborhood.
    """
    if values is None:
        offs = jnp.asarray([-1, 0, 1])
        y = gather_neighborhood(mag, peak_idx, offs)
    else:
        y = values
    y = jnp.maximum(y, 1e-30)
    la, lb, lc = (jnp.log(y[..., 0]), jnp.log(y[..., 1]),
                  jnp.log(y[..., 2]))
    den = 4.0 * lb - 2.0 * la - 2.0 * lc
    den = jnp.where(jnp.abs(den) < 1e-30,
                    jnp.where(den < 0.0, -1e-30, 1e-30), den)
    offset = (lc - la) / den
    if clip is not None:
        offset = jnp.clip(offset, -clip, clip)
    return offset


def cosine_interpolate(mag, peak_idx, values=None):
    """Batched 3-point cosine-fit sub-bin interpolation.

    Fits y_k = A cos(w k + theta) through the peak's neighbours
    (reference thrifty/experimental/carrier_interpolators.py:84-93);
    returns 0 where the fit is invalid ((a + c) / 2b > 1, the
    reference's guard).  ``values`` bypasses the gather with a
    precomputed [..., 3] neighborhood.
    """
    if values is None:
        offs = jnp.asarray([-1, 0, 1])
        y = gather_neighborhood(mag, peak_idx, offs)
    else:
        y = values
    a, b, c = y[..., 0], y[..., 1], y[..., 2]
    b = jnp.maximum(b, 1e-30)
    cos_w = (a + c) / (2.0 * b)
    valid = cos_w <= 1.0
    w = jnp.arccos(jnp.clip(cos_w, -0.999999, 0.999999))
    sin_w = jnp.where(jnp.sin(w) == 0, 1e-30, jnp.sin(w))
    theta = jnp.arctan((a - c) / (2.0 * b * sin_w))
    offset = -theta / jnp.where(w == 0, 1e-30, w)
    return jnp.where(valid, offset, 0.0)


def make_polyfit_interpolator(width: int):
    """Batched quadratic least-squares sub-bin interpolation over width+1
    points (reference thrifty/carrier_sync.py:207-219), as a closed-form
    projection onto precomputed orthogonal polynomial bases."""
    xs = np.arange(-(width // 2), width // 2 + 1).astype(np.float64)
    # Precompute pseudoinverse of the Vandermonde matrix [x^2, x, 1].
    vand = np.stack([xs**2, xs, np.ones_like(xs)], axis=1)
    pinv = np.linalg.pinv(vand)  # [3, P]

    def interpolate(mag, peak_idx, values=None):
        # ``values`` bypasses the gather with a precomputed
        # [..., width+1] neighborhood.
        if values is None:
            offs = jnp.asarray(xs.astype(np.int64))
            y = gather_neighborhood(mag, peak_idx, offs)
        else:
            y = values
        coeffs = jnp.einsum("kp,...p->...k", jnp.asarray(pinv, y.dtype), y,
                            precision=lax.Precision.HIGHEST)
        a2, a1 = coeffs[..., 0], coeffs[..., 1]
        a2 = jnp.where(jnp.abs(a2) < 1e-30,
                       jnp.where(a2 < 0.0, -1e-30, 1e-30), a2)
        return -a1 / a2 / 2.0

    return interpolate
