"""Batched matched filtering (despreading) and sub-sample SoA estimation.

The core of the detector: frequency-domain cross-correlation of each
block against the Gold-code template (optionally a bank of templates),
windowed peak search, noise/threshold tests, and Gaussian sub-sample
interpolation.  Re-design of the reference's per-block SoA estimator
(thrifty/soa_estimator.py:42-170, fastdet/corr_detector.cpp:103-165) as
batched array ops:

  corr      = IFFT(FFT(block_shifted) * conj(FFT(template)))[:corr_len]
  noise_rms = sqrt((E_signal * E_template - peak^2) / N)
  threshold = sqrt(c + s*noise^2 + d*std(|corr|)^2)
  offset    = gaussian 3-point log interpolation, clipped to +-0.6
  SoA       = (block_len - history_len)*block_idx + peak + offset
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def corr_window(block_len: int, history_len: int, template_len: int):
    """Half-open [start, stop) interval of correlation lags unique to a block.

    With overlap-save blocking, a correlation peak within this window
    appears in exactly one block; peaks in the padding are detected by the
    neighbouring block (cf. reference thrifty/soa_estimator.py:20-39).
    """
    assert history_len >= template_len - 1, (
        "history must cover the template: history_len >= template_len - 1"
    )
    corr_len = block_len - template_len + 1
    padding = history_len - template_len + 1
    left = padding // 2
    right = padding - left
    return left, corr_len - right


def template_fft_conj(template: np.ndarray, block_len: int) -> np.ndarray:
    """conj(FFT(zero-padded template)) for one template or a [T, L] bank.

    A 1-D template yields a 1-D result; a 2-D bank stays 2-D (even with
    a single row, so bank-mode broadcasting is preserved).
    """
    template = np.asarray(template, dtype=np.float64)
    single = template.ndim == 1
    tmpl2d = np.atleast_2d(template)
    t, length = tmpl2d.shape
    padded = np.zeros((t, block_len), dtype=np.float64)
    padded[:, :length] = tmpl2d
    out = np.conj(np.fft.fft(padded)).astype(np.complex64)
    return out[0] if single else out


def template_energy(template: np.ndarray) -> np.ndarray:
    """Sum of squared template samples (per template in a bank)."""
    template = np.asarray(template, dtype=np.float64)
    return np.sum(template**2, axis=-1).astype(np.float32)


def despread_spec(shifted_fft, tmpl_fft_conj):
    """Correlation spectrum X = FFT(block_shifted) * conj(FFT(template)).

    shifted_fft: [B, N]; tmpl_fft_conj: [N] or [T, N].
    Returns [B, N] or [B, T, N]; corr = IFFT(X).
    """
    if tmpl_fft_conj.ndim == 2:
        return shifted_fft[:, None, :] * tmpl_fft_conj[None, :, :]
    return shifted_fft * tmpl_fft_conj


def despread(shifted_fft, tmpl_fft_conj, corr_len: int):
    """Batched frequency-domain correlation.

    shifted_fft: [B, N]; tmpl_fft_conj: [N] or [T, N].
    Returns corr [B, corr_len] or [B, T, corr_len].
    """
    corr_full = jnp.fft.ifft(despread_spec(shifted_fft, tmpl_fft_conj))
    return corr_full[..., :corr_len]


def window_peak(corr_mag, window):
    """Batched argmax restricted to the unique-lag window [start, stop).

    Ties resolve to the earliest lag (argmax semantics).  An empty
    window is refused: there is no peak to report.
    """
    start, stop = window
    if stop <= start:
        raise ValueError("empty correlation window [{}, {})".format(
            start, stop))
    peak_rel = jnp.argmax(corr_mag[..., start:stop], axis=-1)
    peak_idx = (peak_rel + start).astype(jnp.int32)
    peak_mag = jnp.take_along_axis(corr_mag, peak_idx[..., None], axis=-1)
    return peak_idx, peak_mag[..., 0]


def noise_rms(peak_mag, signal_energy, tmpl_energy, block_len: int):
    """Correlation-domain noise estimate.

    ``signal_energy`` is the block's time-domain energy sum(|x|^2)
    (invariant under the unit-modulus carrier shift), multiplied by the
    template energy to get total correlation energy; the peak's power is
    subtracted (cf. reference thrifty/soa_estimator.py:108-120).
    """
    corr_energy = signal_energy * tmpl_energy
    power = (corr_energy - jnp.square(peak_mag)) / block_len
    return jnp.sqrt(jnp.maximum(power, 0.0))


def threshold(corr_mag, noise, thresh_coeffs):
    """sqrt(c + s*noise^2 + d*std(|corr|)^2), batched."""
    c, s, d = thresh_coeffs
    t_sq = c + s * jnp.square(noise)
    if d:
        t_sq = t_sq + d * jnp.var(corr_mag, axis=-1)
    return jnp.sqrt(t_sq)


def _gather_neighborhood(corr_mag, peak_idx, half, values=None,
                         length=None):
    """(y [..., 2*half+1], in_bounds [...]) around each peak.

    The shared gather/clip/bounds contract of every sub-sample
    interpolator: ``values`` bypasses the gather with a precomputed
    neighborhood (pass ``length`` for the bounds check then), peaks
    within ``half`` of either edge are flagged out of bounds (callers
    return offset 0 there), and the gather indices are clipped so the
    out-of-bounds lanes still read valid memory.
    """
    n = corr_mag.shape[-1] if length is None else length
    if values is None:
        safe_idx = jnp.clip(peak_idx, half, n - half - 1)
        idx = safe_idx[..., None] + jnp.arange(-half, half + 1)
        y = jnp.take_along_axis(corr_mag, idx, axis=-1)
    else:
        y = values
    in_bounds = (peak_idx >= half) & (peak_idx < n - half)
    return y, in_bounds


def gaussian_interpolate(corr_mag, peak_idx, clip: float = 0.6,
                         values=None, length=None):
    """Batched Gaussian (log-parabolic) sub-sample peak interpolation.

    offset = 0.5*(ln c - ln a)/(2 ln b - ln a - ln c), clipped to +-clip
    (reference thrifty/soa_estimator.py:159-170 with clip 0.6;
    fastdet clips to 0.5).  Out-of-bounds peaks return offset 0.
    ``values`` bypasses the gather with a precomputed [..., 3]
    magnitude neighborhood (pass ``length`` for the bounds check then).
    """
    y, in_bounds = _gather_neighborhood(corr_mag, peak_idx, 1,
                                        values, length)
    y = jnp.maximum(y, 1e-30)  # guard log of zero magnitudes
    la, lb, lc = jnp.log(y[..., 0]), jnp.log(y[..., 1]), jnp.log(y[..., 2])
    den = 2.0 * lb - la - lc
    den = jnp.where(jnp.abs(den) < 1e-30,
                    jnp.where(den < 0.0, -1e-30, 1e-30), den)
    offset = 0.5 * (lc - la) / den
    offset = jnp.clip(offset, -clip, clip)
    return jnp.where(in_bounds, offset, 0.0)


def cosine_interpolate(corr_mag, peak_idx, clip: float = 0.6,
                       values=None, length=None):
    """Batched cosine-fit sub-sample peak interpolation (alternative).

    Fits y_k = A*cos(w*k + theta) through the three points around the
    peak: w = arccos((a+c)/2b), offset = -arctan2-style phase over w
    (reference thrifty/experimental/xcorr_interpolators.py cosine).
    Returns 0 where the fit is invalid (|a+c| > 2b).  ``values``
    bypasses the gather with a precomputed [..., 3] neighborhood
    (pass ``length`` for the bounds check then).
    """
    y, in_bounds = _gather_neighborhood(corr_mag, peak_idx, 1,
                                        values, length)
    a, b, c = y[..., 0], y[..., 1], y[..., 2]
    b = jnp.maximum(b, 1e-30)
    cos_w = (a + c) / (2.0 * b)
    valid = jnp.abs(cos_w) < 1.0
    cos_w_safe = jnp.clip(cos_w, -0.999999, 0.999999)
    w = jnp.arccos(cos_w_safe)
    sin_w = jnp.sin(w)
    theta = jnp.arctan2(a - c, 2.0 * b * sin_w)
    offset = jnp.clip(-theta / jnp.where(w == 0, 1e-30, w), -clip, clip)
    return jnp.where(valid & in_bounds, offset, 0.0)


def none_interpolate(corr_mag, peak_idx, clip: float = 0.6,
                     values=None, length=None):
    """Integer-only peaks: offset is always 0 (reference
    thrifty/experimental/xcorr_interpolators.py:31-32)."""
    del corr_mag, clip, values, length
    return jnp.zeros(peak_idx.shape, dtype=jnp.float32)


def make_maximise_interpolator(clip: float = 0.55, iters: int = 34):
    """Band-limited correlation-peak maximization.

    Re-design of the reference's experimental 'maximise' interpolator
    (thrifty/experimental/xcorr_interpolators.py:94-111), which runs a
    bounded scipy.optimize.minimize over the fractionally shifted
    cross-correlation of the [peak, peak+L) signal segment, per
    detection.  Here the fractional correlation value is evaluated
    band-limited from the full-block correlation spectrum the detector
    already computed -- corr(p + o) = (1/N) sum_k X_k e^{2 pi i k
    (p+o)/N} -- and the scalar maximization is a fixed-iteration
    golden-section search over o in [-clip, clip], so the whole batch
    solves in lockstep under jit (the same re-design pattern as the
    batched Gauss-Newton Dirichlet fit).

    DIVERGENCE from the reference: interpolation runs over the full
    overlap-save correlation rather than a re-FFT of the peak segment;
    same estimator family, and sub-1e-2-sample agreement with the
    dense-search oracle is asserted in tests (tests/test_interp_modes
    .py).  34 iterations shrink the bracket to ~8e-8 samples, the
    float32 resolution floor near the +-0.55 clip bound (the bracket
    endpoints are f32, so spacing below |a| * 2^-23 ~ 7e-8 rounds onto
    the endpoints and further iterations buy nothing).
    """
    import jax

    invphi = np.float32((np.sqrt(5.0) - 1.0) / 2.0)

    def interpolate(spec, peak_idx):
        n = spec.shape[-1]
        k = jnp.arange(n, dtype=jnp.int32)
        # Rotate the spectrum to the integer peak with EXACT integer
        # phase arithmetic ((k * p) mod n; a float32 k*p/n product
        # would lose the fractional phase).  n is static at trace
        # time, so pick the overflow-safe formulation here:
        p = peak_idx[..., None].astype(jnp.int32) % n
        if n & (n - 1) == 0:
            # Power-of-two n (every default geometry): unsigned
            # multiply wraps mod 2^32, and n divides 2^32, so the low
            # bits (& (n-1)) are exact even when k*p exceeds 2^31.
            kp = ((k.astype(jnp.uint32)[None, :] *
                   p.astype(jnp.uint32)) & jnp.uint32(n - 1)) \
                .astype(jnp.int32)
        elif n < 46341:
            # k*p < n^2 < 2^31 stays within int32.
            kp = (k[None, :] * p) % n
        else:
            raise ValueError(
                "corr_interp='maximise' needs block_len a power of "
                "two or < 46341 (int32 phase arithmetic); got %d" % n)
        base = spec * jnp.exp(2j * jnp.pi *
                              (kp.astype(jnp.float32) / n))
        # Fractional evaluation MUST use the signed (fftfreq)
        # frequencies -- e^{2 pi i o f_k} with f_k in [-1/2, 1/2) --
        # exactly as the reference does (xcorr_interpolators.py:102).
        # The unsigned k/n grid agrees only at integer shifts; using it
        # for the fractional part phases the upper half-spectrum
        # wrongly and biases the offset by tenths of a sample.
        f_signed = jnp.where(k < (n + 1) // 2, k, k - n) \
            .astype(jnp.float32) / n

        def value(o):
            ph = jnp.exp(2j * jnp.pi * o[..., None] * f_signed)
            return jnp.abs(jnp.sum(base * ph, axis=-1))

        f32 = lambda x: x.astype(jnp.float32)
        a = jnp.full(peak_idx.shape, -clip, jnp.float32)
        b = jnp.full(peak_idx.shape, clip, jnp.float32)
        c = f32(b - invphi * (b - a))
        d = f32(a + invphi * (b - a))
        fc, fd = f32(value(c)), f32(value(d))

        def body(_, st):
            a, b, c, d, fc, fd = st
            left = fc > fd  # keep [a, d]; else keep [c, b]
            f32 = lambda x: x.astype(jnp.float32)
            a2 = jnp.where(left, a, c)
            b2 = jnp.where(left, d, b)
            c2 = f32(b2 - invphi * (b2 - a2))
            d2 = f32(a2 + invphi * (b2 - a2))
            # One evaluation per iteration: the surviving interior
            # point's value is reused, only its mirror is fresh.
            xnew = jnp.where(left, c2, d2)
            fnew = f32(value(xnew))
            return (a2, b2, c2, d2,
                    jnp.where(left, fnew, fd),
                    jnp.where(left, fc, fnew))

        a, b, c, d, fc, fd = jax.lax.fori_loop(
            0, iters, body, (a, b, c, d, fc, fd))
        return 0.5 * (a + b)

    return interpolate


def make_autocorr_interpolator(template, oversample: int = 16,
                               width: int = 2, iters: int = 10,
                               clip: float = 0.6):
    """Sub-sample interpolation by fitting the template's own
    autocorrelation shape to the correlation peak neighborhood.

    The ideal peak shape is |R(tau)|, the template's (OOK-envelope)
    autocorrelation; it is precomputed on an ``oversample``-times finer
    grid and the fit solves for amplitude and sub-sample shift with a
    fixed-iteration Gauss-Newton (batched).  Batched re-design of the
    reference's iterative autocorr-fit
    (thrifty/experimental/xcorr_interpolators.py make_autocorr_fit).

    Returns ``interp(corr_mag, peak_idx) -> offset`` for lags within
    ``width`` of the peak.  With a [T, L] template bank, expects
    ``corr_mag`` shaped [..., T, corr_len] / ``peak_idx`` [..., T] and
    fits each template against its own autocorrelation shape.
    """
    template = np.asarray(template, dtype=np.float64)
    single = template.ndim == 1
    rows = np.atleast_2d(template)

    def shape_tables(tmpl):
        # The captured peak is xcorr(OOK signal, bipolar template):
        # model its shape, oversampled via spectral zero-padding.
        ook = tmpl - np.min(tmpl)
        tlen = len(ook)
        pad_ook = np.zeros(2 * tlen)
        pad_ook[:tlen] = ook
        pad_bip = np.zeros(2 * tlen)
        pad_bip[:tlen] = tmpl
        spec = np.fft.fft(pad_ook) * np.conj(np.fft.fft(pad_bip))
        fine_spec = np.zeros(2 * tlen * oversample, dtype=complex)
        half = tlen  # keep both spectrum halves (zero-pad the middle)
        fine_spec[:half] = spec[:half]
        fine_spec[-half:] = spec[-half:]
        fine = np.abs(np.fft.ifft(fine_spec)) * oversample
        # r(tau) for tau in [-width-2, width+2] at 1/oversample res.
        span = (width + 2) * oversample
        taus = np.concatenate([fine[-span:], fine[:span + 1]])
        taus = taus / np.max(taus)
        # Derivative table (central differences on the fine grid).
        return taus, np.gradient(taus, 1.0 / oversample)

    pairs = [shape_tables(r) for r in rows]
    taus_all = np.stack([p[0] for p in pairs])     # [T, M]
    dtaus_all = np.stack([p[1] for p in pairs])
    num_entries = taus_all.shape[1]
    if single:
        taus_all, dtaus_all = taus_all[0], dtaus_all[0]
    table = jnp.asarray(taus_all, dtype=jnp.float32)
    dtable = jnp.asarray(dtaus_all, dtype=jnp.float32)
    ks = np.arange(-width, width + 1)

    def lookup(tbl, u):
        # u in samples relative to the peak; nearest fine-grid entry.
        pos = jnp.clip((u + (width + 2)) * oversample, 0,
                       num_entries - 1.001)
        i0 = jnp.floor(pos).astype(jnp.int32)
        frac = pos - i0
        if tbl.ndim == 2:
            # Per-template tables: u is [..., T, K]; row t of the table
            # serves axis -2's slot t (numpy advanced-index broadcast).
            t_idx = jnp.arange(tbl.shape[0])[:, None]
            v0, v1 = tbl[t_idx, i0], tbl[t_idx, i0 + 1]
        else:
            v0, v1 = tbl[i0], tbl[i0 + 1]
        return v0 * (1 - frac) + v1 * frac

    def interpolate(corr_mag, peak_idx, values=None, length=None):
        # ``values`` bypasses the gather with a precomputed
        # [..., 2*width+1] magnitude neighborhood (pass ``length`` for
        # the bounds check then).
        y, in_bounds = _gather_neighborhood(corr_mag, peak_idx, width,
                                            values, length)
        y = y.astype(jnp.float32)
        kgrid = jnp.asarray(ks, dtype=jnp.float32)

        amp0 = y[..., width]
        delta0 = jnp.zeros_like(amp0)

        def body(carry, _):
            amp, delta = carry
            u = kgrid - delta[..., None]
            r = lookup(table, u)
            dr = lookup(dtable, u)
            resid = y - amp[..., None] * r
            j_a = r
            j_d = -amp[..., None] * dr
            a11 = jnp.sum(j_a * j_a, axis=-1) * 1.0001
            a22 = jnp.sum(j_d * j_d, axis=-1) * 1.0001 + 1e-12
            a12 = jnp.sum(j_a * j_d, axis=-1)
            b1 = jnp.sum(j_a * resid, axis=-1)
            b2 = jnp.sum(j_d * resid, axis=-1)
            det = a11 * a22 - a12 * a12
            det = jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
            amp = amp + (a22 * b1 - a12 * b2) / det
            delta = jnp.clip(
                delta + (a11 * b2 - a12 * b1) / det, -1.0, 1.0)
            return (amp, delta), None

        import jax.lax as lax
        (amp, delta), _ = lax.scan(body, (amp0, delta0), None,
                                   length=iters)
        offset = jnp.clip(delta, -clip, clip)
        return jnp.where(in_bounds, offset, 0.0)

    interpolate.width = width  # neighborhood half-width for callers
    return interpolate


def parabolic_interpolate(corr_mag, peak_idx, clip: float = 0.6,
                          values=None, length=None):
    """Batched parabolic sub-sample peak interpolation (alternative).

    ``values`` bypasses the gather with a precomputed [..., 3]
    neighborhood (pass ``length`` for the bounds check then).
    """
    y, in_bounds = _gather_neighborhood(corr_mag, peak_idx, 1,
                                        values, length)
    a, b, c = y[..., 0], y[..., 1], y[..., 2]
    den = 2.0 * b - a - c
    den = jnp.where(jnp.abs(den) < 1e-30,
                    jnp.where(den < 0.0, -1e-30, 1e-30), den)
    offset = jnp.clip(0.5 * (c - a) / den, -clip, clip)
    return jnp.where(in_bounds, offset, 0.0)
