"""DFT-as-matmul transforms: Bailey four-step / dense DFT products.

The detector's transforms can run either as ``jnp.fft`` (XLA's FFT:
cuFFT on the GPU, pocketfft/ducc on the CPU) or reformulated as matrix
products:

- n <= ``_DFT_MAX``: one dense DFT matrix product, out = x @ F with
  F[j, k] = W_n^{jk}.
- larger n divisible by 128 (Bailey's four-step, n = n1 * n2):
  view x as [n1, n2] row-major, transform columns with F_{n1}, apply
  twiddles W_n^{k1 n2}, transform rows with F_{n2}, and read the
  result transposed -- two batched [128 x 128]-class matmuls + one
  elementwise twiddle instead of log2(n) butterfly passes.

The matmul form does O(n * (n1 + n2)) work where the FFT does
O(n log n); it pays only where matrix units would otherwise idle under
a memory-bound butterfly.  On the GPU the on-card A/B (PERF.md) decides
``'auto'``: at Precision.HIGHEST the contractions run on the float32
CUDA cores, not the tensor cores.

``fft``/``ifft`` dispatch per ``impl`` (:func:`resolve_impl`):
  'auto'    -- ``jnp.fft`` on every backend (the GPU A/B's winner;
               the CPU keeps bit-exact jnp/numpy numerics);
  'matmul'  -- force the matmul path (falls back to jnp.fft only when
               n has no supported factorization);
  'matmul3' -- matmul path with every complex product computed by
               Karatsuba's 3-real-multiplication identity instead of
               XLA's 4-product complex expansion (see _capply): 25%
               fewer real products, error within ~1.3x of 'matmul'
               (6.1e-7 vs 4.8e-7 max relative on [3, 16384], CPU);
  'xla'     -- force jnp.fft.

``precision`` selects the matmul contraction precision:
  'highest' -- lax.Precision.HIGHEST: full float32 products; the
               default.
  'high'    -- lax.Precision.HIGH.  On the GPU, XLA lets both 'high'
               and 'default' run float32 contractions in TF32 (inputs
               rounded to a 10-bit mantissa, float32 accumulation);
               the relative error measured on the card is in PERF.md.
               A throughput-over-parity knob, not the default.
  'default' -- lax.Precision.DEFAULT (TF32 on the GPU, like 'high').

Beyond the full transforms, two trimmed variants exploit what the
detector actually consumes (exact, not approximations -- they compute
the same dot products as the full transform, minus unused outputs):

- :func:`ifft_head` computes only the first ``m`` outputs (the
  detector discards lags >= corr_len, i.e. ~30% of the inverse
  transform's rows at the example geometry);
- :func:`windowed_dft` computes an arbitrary subset of output bins
  (the carrier stage needs only the ~100-bin carrier window plus an
  interpolation margin; total spectrum energy comes from Parseval on
  the time-domain block).  Cost is one full [n1, n1] column transform
  plus W-bin combine -- about HALF a four-step FFT for W << n.

The transform constants are numpy complex64 embedded at trace time
(same convention as the detector's template FFTs).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

# Largest n handled by a single dense DFT matrix.  At 2048 the matrix
# is 32 MB complex64 -- fine as a trace-time constant, and small
# blocks only appear in tests/tiny geometries anyway.
_DFT_MAX = 2048

_PRECISIONS = {
    "highest": lax.Precision.HIGHEST,
    "high": lax.Precision.HIGH,
    "default": lax.Precision.DEFAULT,
}


def _resolve_precision(precision):
    try:
        return _PRECISIONS[precision]
    except KeyError:
        raise ValueError(
            "unknown fft precision {!r}: expected one of {}".format(
                precision, sorted(_PRECISIONS)))


@functools.lru_cache(maxsize=32)
def _dft_matrix(n, inverse):
    sgn = 2j if inverse else -2j
    k = np.arange(n)
    return np.exp(sgn * np.pi * np.outer(k, k) / n).astype(np.complex64)


@functools.lru_cache(maxsize=32)
def _four_step_consts(n1, n2, inverse):
    n = n1 * n2
    sgn = 2j if inverse else -2j
    f1 = np.exp(sgn * np.pi * np.outer(np.arange(n1), np.arange(n1))
                / n1).astype(np.complex64)
    f2 = np.exp(sgn * np.pi * np.outer(np.arange(n2), np.arange(n2))
                / n2).astype(np.complex64)
    tw = np.exp(sgn * np.pi * np.outer(np.arange(n1), np.arange(n2))
                / n).astype(np.complex64)
    return f1, f2, tw


def _split(n):
    """(n1, n2) four-step factorization, or None.

    n1 = 128 keeps the column transform a square [128 x 128] matmul;
    n2 is whatever remains (itself a single [n2, n2] DFT product, so n2 is
    capped like the dense path).
    """
    if n % 128 == 0 and 128 <= n // 128 <= _DFT_MAX:
        return 128, n // 128
    return None


_IMPLS = ("auto", "matmul", "matmul3", "xla")


def resolve_impl(impl):
    """The concrete transform for ``impl`` on the default backend.

    ``'auto'`` is ``'xla'`` (``jnp.fft``) everywhere: on the GPU,
    cuFFT beat the four-step matmul in the on-card A/B of the whole
    detect program (PERF.md), and on the CPU ``jnp.fft`` keeps the
    goldens' numerics.
    """
    if impl not in _IMPLS:
        raise ValueError("unknown fft impl {!r}: expected 'auto', "
                         "'matmul', 'matmul3' or 'xla'".format(impl))
    return "xla" if impl == "auto" else impl


def _use_matmul(impl):
    return resolve_impl(impl) != "xla"


def _capply(x, cnp, op, kara):
    """Bilinear complex contraction ``op(x, const)`` two ways.

    ``kara=False``: one complex-operand call (XLA expands a complex
    dot into 4 real products).  ``kara=True`` (impl='matmul3'):
    Karatsuba's 3-multiplication identity -- t1 = op(xr, cr),
    t2 = op(xi, ci), t3 = op(xr+xi, cr+ci), out = (t1-t2) +
    i(t3-t1-t2) -- 25% fewer real products at a small extra elementwise
    cost and mildly worse rounding in the imaginary part (two
    cancelling subtractions).  ``op(a, c)`` must be bilinear and take
    (array, constant) in that order; ``cnp`` is a trace-time numpy
    complex constant.
    """
    if not kara:
        return op(x, jnp.asarray(cnp))
    cr = jnp.asarray(np.ascontiguousarray(cnp.real.astype(np.float32)))
    ci = jnp.asarray(np.ascontiguousarray(cnp.imag.astype(np.float32)))
    crpi = jnp.asarray(np.ascontiguousarray(
        (cnp.real + cnp.imag).astype(np.float32)))
    xr, xi = jnp.real(x), jnp.imag(x)
    t1 = op(xr, cr)
    t2 = op(xi, ci)
    t3 = op(xr + xi, crpi)
    return jax.lax.complex(t1 - t2, t3 - t1 - t2)


def _four_step(a, inverse, prec, kara, m):
    """Four-step transform core on ``a`` [..., n1, n2] (time index
    t = j1*n2 + j2); returns [..., m] (the first m output bins)."""
    n1, n2 = a.shape[-2], a.shape[-1]
    n = n1 * n2
    f1, f2, tw = _four_step_consts(n1, n2, inverse)
    # Output index j = k2*n1 + k1: keeping j < m only needs
    # row-transform columns k2 < ceil(m/n1).
    k2_max = -(-m // n1)
    lead = a.shape[:-2]
    a = a.reshape((-1, n1, n2))
    b = _capply(a, f1,
                lambda u, c: jnp.einsum("ij,bjk->bik", c, u,
                                        precision=prec), kara)
    d = _capply(b * jnp.asarray(tw), f2[:, :k2_max],
                lambda u, c: jnp.einsum("bik,kj->bij", u, c,
                                        precision=prec), kara)
    out = d.transpose(0, 2, 1).reshape(lead + (k2_max * n1,))
    out = out[..., :m]
    return out / n if inverse else out


def _transform(x, inverse, impl, precision="highest", head=None):
    """Full transform, or (``head=m``) only its first ``m`` outputs.

    The head trim is EXACT: the kept outputs are the same dot products
    the full transform computes (dense path: a column slice of the DFT
    matrix; four-step: a column slice of the row transform), so
    ``_transform(x, head=m)`` equals ``_transform(x)[..., :m]`` per
    impl.  The detector's despread discards correlation lags >=
    corr_len (reference thrifty/soa_estimator.py:97-102 slices the
    same way), which at the example geometry skips ~30% of the inverse
    transform's output rows.
    """
    prec = _resolve_precision(precision)
    kara = impl == "matmul3"
    n = x.shape[-1]
    m = n if head is None else min(int(head), n)
    if _use_matmul(impl):
        if n <= _DFT_MAX:
            f = _dft_matrix(n, inverse)[:, :m]
            out = _capply(x, f,
                          lambda a, c: jnp.matmul(a, c, precision=prec),
                          kara)
            return out / n if inverse else out
        split = _split(n)
        if split is not None:
            n1, n2 = split
            return _four_step(x.reshape(x.shape[:-1] + (n1, n2)),
                              inverse, prec, kara, m)
        # No supported factorization: matmul would need a dense
        # [n, n] constant beyond _DFT_MAX -- fall back.
    full = jnp.fft.ifft(x) if inverse else jnp.fft.fft(x)
    return full if head is None else full[..., :m]


def fft_ramped(x, shift, impl="auto", precision="highest",
               separable=True):
    """FFT of ``x * exp(2j*pi*shift*(t/n - 0.5))`` -- the reference's
    fractional carrier shift -- with the ramp in SEPARABLE form on the
    four-step path (``separable=False`` forces the explicit full-ramp
    product; this function is the ONE home of the ramp formula, which
    the full branch also serves as the non-four-step fallback).

    The fractional carrier shift multiplies every sample by a
    unit-modulus ramp before the transform (reference
    thrifty/carrier_sync.py:60-75).  Over the four-step's index split
    t = j1*n2 + j2 the exponent factors exactly:

        shift*(t/n - 0.5) = shift*j1/n1 + shift*(j2/n - 0.5)

    so the [..., n] transcendental ramp (n exp evaluations + a full
    read/write pass per block) collapses to two [..., n1] / [..., n2]
    factors -- n1+n2 exps instead of n (128x fewer at 16384) -- whose
    broadcast product XLA fuses straight into the column transform's
    operand load, never materializing a ramp array.  Numerics: the
    two-factor product rounds differently from the single exp by ~1
    ULP of phase; the matmul transform family is checked against the
    jnp.fft path at the f32 grade (tests/test_mxu_fft.py, and on the
    card by chip_smoke.py's transforms phase), and this variant is
    covered the same way.  Falls back to the explicit full ramp off the
    four-step path (dense/xla impls keep bit-exact reference
    numerics).
    """
    prec = _resolve_precision(precision)
    kara = impl == "matmul3"
    n = x.shape[-1]
    split = _split(n)
    if separable and _use_matmul(impl) and split is not None:
        n1, n2 = split
        two_pi = jnp.float32(2.0 * np.pi)
        # Split shift = si + sf (integer + fraction in [-0.5, 0.5]) so
        # every evaluated phase stays <= 2*pi: the integer part wraps
        # EXACTLY as (si*j1) mod n1 (integer arithmetic; si*j1 is far
        # below 2^31), and exp(-i*pi*si) is the exact sign (-1)^si.
        # The naive factored phases reach 2*pi*|shift| ~ 700 rad where
        # f32 rounding costs ~1e-5 relative error; wrapped, the
        # separable form matches the full-ramp path's f32 grade (both
        # certified against the float64 oracle in tests).
        si = jnp.round(shift)
        sf = shift - si
        sii = si.astype(jnp.int32)
        j1i = jnp.arange(n1, dtype=jnp.int32)
        ph1 = two_pi * (
            ((sii[..., None] * j1i) % n1).astype(jnp.float32) / n1
            + sf[..., None] * (jnp.arange(n1, dtype=jnp.float32) / n1))
        # shift*(j2/n - 0.5) = shift*j2/n - si/2 - sf/2; j2 < n2 keeps
        # shift*j2/n below ~2*pi/n1 per unit shift (tiny), and the
        # -shift/2 constant folds into r2 as (-1)^si * exp(-i*pi*sf).
        ph2 = two_pi * shift[..., None] * (
            jnp.arange(n2, dtype=jnp.float32) / n) \
            - jnp.float32(np.pi) * sf[..., None]
        sign = (1 - 2 * (sii % 2)).astype(jnp.float32)
        r1 = jnp.exp(1j * ph1).astype(x.dtype)              # [..., n1]
        r2 = (jnp.exp(1j * ph2)
              * sign[..., None]).astype(x.dtype)            # [..., n2]
        a = x.reshape(x.shape[:-1] + (n1, n2)) \
            * r1[..., :, None] * r2[..., None, :]
        return _four_step(a, False, prec, kara, n)
    pos = jnp.arange(n, dtype=jnp.float32) / n - 0.5
    ramp = jnp.exp(1j * (2.0 * np.pi) * shift[..., None] * pos)
    return _transform(x * ramp.astype(x.dtype), False, impl, precision)


# Dense windowed-DFT heuristic: evaluate X[sel] as ONE [n, W] matmul
# (no [B, n1, n2] column-transform intermediate materialized in device
# memory) whenever the constant matrix stays below this element count.
# At the example geometry (n=16384, W~114) the dense constant is ~15 MB
# c64 -- template-bank scale -- and it saves the b1 write+read passes
# for comparable matmul work.  Module-level so the A/B
# harness can pin either form; both are certified against the same
# oracle tolerances.
WINDOWED_DENSE_MAX_ELEMS = 8 * 1024 * 1024


@functools.lru_cache(maxsize=32)
def _windowed_consts(n, sel, inverse, dense):
    """Constants for :func:`windowed_dft` at output bins ``sel``.

    ``dense``: one [n, W] matrix product (X[k] = sum_t x[t] W_n^{tk},
    single-level accumulation over the full n-length contraction).
    Factorized evaluation otherwise, when the four-step split exists:
    with time index t = j1*n2 + j2, X[k] = sum_j2 W_n^{j2 k} *
    b1[k mod n1, j2] where b1 is the SAME [n1, n1] column transform
    the four-step FFT runs -- so the windowed transform shares its
    two-level accumulation accuracy.  Returns (cols, None, None) for
    the dense path or (f1, k1_idx, comb) for the factorized one.
    """
    sgn = 2j if inverse else -2j
    sel_arr = np.asarray(sel, dtype=np.int64)
    if n <= _DFT_MAX or dense:
        k = np.arange(n)
        cols = np.exp(sgn * np.pi * np.outer(k, sel_arr) / n)
        return cols.astype(np.complex64), None, None
    split = _split(n)
    if split is None:
        return None, None, None
    n1, n2 = split
    f1 = np.exp(sgn * np.pi * np.outer(np.arange(n1), np.arange(n1))
                / n1).astype(np.complex64)
    k1_idx = (sel_arr % n1).astype(np.int32)
    comb = np.exp(sgn * np.pi * np.outer(sel_arr, np.arange(n2))
                  / n).astype(np.complex64)  # [W, n2]
    return f1, k1_idx, comb


def windowed_dft(x, sel, impl="auto", precision="highest"):
    """DFT of ``x`` evaluated only at output bins ``sel``.

    ``sel``: 1-D numpy int array (hashable tuple accepted) of FFT bin
    indices in any order, e.g. a wrapped carrier window.  Returns
    [..., len(sel)] -- ``fft(x)[..., sel]`` up to matmul accumulation
    error.  Under the xla impl (or unfactorable n) this IS a take of
    the full jnp.fft.  Cost on the matmul path: the four-step's column
    transform plus a len(sel)-bin combine -- about half a full
    four-step FFT for small windows, with no [.., n] spectrum ever
    materialized.
    """
    prec = _resolve_precision(precision)
    kara = impl == "matmul3"
    n = x.shape[-1]
    sel_t = tuple(int(s) for s in np.asarray(sel).ravel())
    if any(s < 0 or s >= n for s in sel_t):
        raise ValueError("windowed_dft bins out of range for n=%d" % n)
    if _use_matmul(impl):
        dense = n * len(sel_t) <= WINDOWED_DENSE_MAX_ELEMS
        cols, k1_idx, comb = _windowed_consts(n, sel_t, False, dense)
        if cols is not None and k1_idx is None:
            return _capply(x, cols,
                           lambda a, c: jnp.matmul(a, c,
                                                   precision=prec),
                           kara)
        if cols is not None:
            f1 = cols
            n1 = f1.shape[0]
            n2 = n // n1
            lead = x.shape[:-1]
            a = x.reshape((-1, n1, n2))
            b1 = _capply(a, f1,
                         lambda u, c: jnp.einsum("ij,bjk->bik", c, u,
                                                 precision=prec), kara)
            rows = jnp.take(b1, jnp.asarray(k1_idx), axis=1)  # [B,W,n2]
            out = _capply(rows, comb,
                          lambda u, c: jnp.einsum("bwj,wj->bw", u, c,
                                                  precision=prec), kara)
            return out.reshape(lead + (len(sel_t),))
    full = jnp.fft.fft(x)
    return jnp.take(full, jnp.asarray(np.asarray(sel_t)), axis=-1)


def fft(x, impl="auto", precision="highest"):
    """Batched FFT along the last axis (see module docstring)."""
    return _transform(x, False, impl, precision)


def ifft(x, impl="auto", precision="highest"):
    """Batched inverse FFT along the last axis."""
    return _transform(x, True, impl, precision)


def ifft_head(x, m, impl="auto", precision="highest"):
    """First ``m`` outputs of the inverse FFT -- exactly
    ``ifft(x, impl)[..., :m]``, skipping the dot products for the
    discarded tail on the matmul path (see :func:`_transform`)."""
    return _transform(x, True, impl, precision, head=m)
