"""Batched carrier detection: windowed argmax threshold detector on |FFT|.

Batched re-design of the reference's per-block carrier detector
(thrifty/carrier_detect.py:61-115, fastcard/cardet.c:7-41): instead of a
scalar loop over blocks, every stage is computed for a whole batch of
blocks [B, N] at once as array reductions, with the frequency window
expressed as a precomputed boolean mask (handles negative-bin wrap-around
without data-dependent control flow).

Formulas (kept bit-identical to the reference semantics):
  noise_rms  = sqrt((sum(mag^2) - 2*peak^2) / (N - 1))
  threshold  = sqrt(c + s*noise_rms^2 + d*std(mag)^2)
  detected   = peak > threshold
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def fft_window_indices(start: int, stop: int, length: int):
    """Resolve a closed signed-bin interval to wrapped FFT array indices.

    Mirrors the reference's bin-range semantics
    (thrifty/carrier_detect.py:17-58): a (start, stop) pair of signed
    frequency bins, e.g. (-10, 10) -> indices 1014..1023, 0..10 for N=1024,
    and (0, -1) meaning the full range.
    """
    if abs(start) >= length or abs(stop) >= length:
        raise ValueError(
            "frequency window out of range: {} - {}".format(start, stop)
        )
    if start < 0 and stop >= 0:
        start, stop = length + start, length + stop
    if start < 0:
        start = length + start
    if stop < 0:
        stop = length + stop
    if stop < start:
        start, stop = stop, start
    return np.arange(start, stop + 1) % length


def window_mask(window, length: int) -> np.ndarray:
    """Boolean FFT-index mask for a closed signed-bin interval.

    ``window=None`` selects the full range.
    """
    if window is None:
        window = (0, -1)
    mask = np.zeros(length, dtype=bool)
    mask[fft_window_indices(window[0], window[1], length)] = True
    return mask


def apply_peak_filter(fft_mag, weights):
    """Matched-filter the magnitude spectrum with peak-shaped weights.

    ``filtered[k] = sqrt(sum_j w[j]^2 * mag[k - (W-1) + j]^2)`` -- an
    energy-domain FIR whose coefficients should be unit-energy
    (sum w^2 = 1), improving the peak's energy estimate (reference
    thrifty/carrier_detect.py:128-135).  Returns (filtered, delay)
    where ``delay`` realigns the argmax to the true peak position.
    """
    weights = np.asarray(weights, dtype=np.float64)
    delay = len(weights) - int(np.argmax(weights)) - 1
    # windows[s][k] = power[k - (W-1) + s]; matching the reference's
    # lfilter(w[::-1]**2, 1, power) needs coefficient w[s]^2 here.
    coeffs = jnp.asarray((weights ** 2).astype(np.float32))
    power = jnp.square(fft_mag)
    # Causal FIR along the last axis (zero initial conditions), batched.
    pad = len(weights) - 1
    padded = jnp.pad(power, [(0, 0)] * (power.ndim - 1) + [(pad, 0)])
    windows = jax.vmap(
        lambda shift: jax.lax.dynamic_slice_in_dim(
            padded, shift, power.shape[-1], axis=-1))(jnp.arange(
                len(weights)))
    filtered = jnp.sqrt(jnp.tensordot(coeffs, windows, axes=(0, 0),
                                      precision=jax.lax.Precision.HIGHEST))
    return filtered, delay


def _mask_to_selection(mask):
    """Contiguous wrapped window selection from a window mask.

    Reconstructs the reference's ``_get_window`` ordering
    (thrifty/carrier_detect.py:123-130): FFT indices start..stop mod N
    in signed-bin order.  The mask must describe one circular run (what
    :func:`window_mask` produces); a full mask maps to 0..N-1.
    """
    mask = np.asarray(mask)
    n = len(mask)
    if mask.all():
        # An all-True mask is ambiguous: it could be the unwrapped
        # full range 0..N-1 OR a wrapped full-span window starting
        # mid-spectrum (e.g. (-N/2, N/2-1) starts at index N/2) --
        # and the FIR's start-up transient lands at the selection
        # start.  Callers with a wrapped full-span window must pass
        # ``selection`` to detect() explicitly.
        return np.arange(n)
    starts = np.flatnonzero(mask & ~np.roll(mask, 1))
    if len(starts) != 1:
        raise ValueError("peak_filter requires a contiguous "
                         "(possibly wrapped) carrier window mask")
    return (int(starts[0]) + np.arange(int(mask.sum()))) % n


def detect(fft_mag, mask, thresh_coeffs, peak_filter=None,
           selection=None):
    """Batched carrier detection on FFT magnitudes.

    Parameters
    ----------
    fft_mag : [..., N] float array (batch of FFT magnitudes)
    mask : [N] bool numpy array from :func:`window_mask` (trace-time
        constant)
    thresh_coeffs : (const, snr, stddev) static floats
    peak_filter : optional [W] unit-energy weights matching the peak's
        spectral shape (e.g. dirichlet.dirichlet_weights)
    selection : optional [K] numpy index array giving the window's
        FFT indices in window order (from :func:`fft_window_indices`).
        Only used with ``peak_filter``; REQUIRED for correctness when
        a wrapped window covers the whole spectrum, where the mask
        alone cannot encode the start bin (the FIR's start-up
        transient must sit at the window start, like the reference's).

    Returns
    -------
    detected : [...] bool
    peak_idx : [...] int32 -- FFT array index of the carrier peak
    peak_mag : [...] float
    noise_rms : [...] float
    """
    n = fft_mag.shape[-1]
    if not np.asarray(mask).any():
        # The masked argmax would silently report bin 0.
        raise ValueError("carrier window mask has no True bins")
    if peak_filter is not None:
        # Reference semantics (thrifty/carrier_detect.py:123-154): the
        # FIR runs over the CONTIGUOUS wrapped window selection with
        # zero initial conditions at the window start (so windows
        # crossing the DC/negative-bin wrap see their real circular
        # neighbors, and the first W-1 window bins see the reference's
        # start-up transient), the argmax spans every filter output,
        # and the reported peak index may fall up to ``delay`` bins
        # below the window start.  One deliberate divergence: the peak
        # index is reduced mod N (the reference's single ``> N``
        # correction can leave index N itself unwrapped).
        sel = (np.asarray(selection) if selection is not None
               else _mask_to_selection(mask))
        mag_win = jnp.take(fft_mag, jnp.asarray(sel), axis=-1)
        filtered, delay = apply_peak_filter(mag_win, peak_filter)
        filt_idx = jnp.argmax(filtered, axis=-1).astype(jnp.int32)
        peak_mag = jnp.take_along_axis(
            filtered, filt_idx[..., None], axis=-1)[..., 0]
        peak_idx = ((filt_idx - delay + int(sel[0])) % n).astype(
            jnp.int32)
    else:
        masked = jnp.where(jnp.asarray(mask), fft_mag, -1.0)
        peak_idx = jnp.argmax(masked, axis=-1).astype(jnp.int32)
        peak_mag = jnp.take_along_axis(
            fft_mag, peak_idx[..., None].astype(jnp.int32), axis=-1
        )[..., 0]

    energy = jnp.sum(jnp.square(fft_mag), axis=-1)
    noise_rms, thresh_sq = noise_and_threshold_sq(
        energy, jnp.square(peak_mag), n, thresh_coeffs)
    c, s, d = thresh_coeffs
    if d:  # statically gated: std term is rarely enabled
        thresh_sq = thresh_sq + d * jnp.var(fft_mag, axis=-1)
    detected = peak_mag > jnp.sqrt(jnp.maximum(thresh_sq, 0.0))
    return detected, peak_idx, peak_mag, noise_rms


def noise_and_threshold_sq(energy, peak_power, n, thresh_coeffs):
    """Carrier noise estimate + squared base threshold (no stddev
    term), shared by the XLA and Pallas detect paths.

    Signed noise variance (fastcard/cardet.c:22-27 keeps the signed
    power): an ultra-strong carrier holding more than half the total
    energy drives it negative.  The reference Python takes sqrt first
    (carrier_detect.py:99-107), so its threshold goes NaN and it
    silently REJECTS exactly the strongest blocks; fastcard detects
    them.  We follow fastcard: threshold from the signed variance
    (identical results whenever the variance is non-negative, i.e.
    every physical noise level), clamped at zero only for the
    reported noise magnitude.  square(noise_rms) (not noise_var) in
    the non-negative branch keeps the threshold bit-identical to the
    historical numerics there (sqrt-then-square rounds differently
    from the raw variance).
    """
    c, s, _ = thresh_coeffs
    noise_var = (energy - 2.0 * peak_power) / (n - 1)
    noise_rms = jnp.sqrt(jnp.maximum(noise_var, 0.0))
    thresh_sq = c + s * jnp.where(
        noise_var < 0.0, noise_var, jnp.square(noise_rms))
    return noise_rms, thresh_sq


def windowed_selection(carrier_window, thresh_coeffs, n, fft_impl,
                       margin=0):
    """Eligibility + index sets for the windowed-DFT carrier fast path.

    Returns ``(sel_i32, ext_i64)`` when the fast path applies -- an
    explicit carrier window, no stddev threshold term (it needs every
    bin's magnitude), the matmul FFT impl active, and the window plus
    ``margin`` wrapped neighbor bins per side small against ``n`` --
    else ``None``.  ``sel`` are the window's FFT bin indices in window
    order; ``ext`` additionally carries the interpolation margin.
    Shared by the detector's carrier stage and the capture node's
    CarrierGate so their eligibility and numerics can never drift.
    """
    from thrifty_tpu.dsp import mxu_fft

    if carrier_window is None or thresh_coeffs[2]:
        return None
    if not mxu_fft._use_matmul(fft_impl):
        return None
    sel = fft_window_indices(carrier_window[0], carrier_window[1], n)
    if len(sel) + 2 * margin > n // 8:
        return None
    ext = (int(sel[0]) - margin
           + np.arange(len(sel) + 2 * margin)) % n
    return sel.astype(np.int32), ext.astype(np.int64)


def detect_windowed(blocks, sel, ext, margin, thresh_coeffs,
                    fft_impl="auto", fft_precision="highest"):
    """Carrier detection via a windowed DFT (the matmul fast path).

    The carrier stage consumes only (a) the windowed argmax plus an
    interpolation neighborhood and (b) the total spectrum energy --
    and (b) is Parseval on the time-domain block -- so the full
    [B, N] FFT and magnitude arrays never materialize; cost is about
    half a four-step transform (mxu_fft.windowed_dft).  ``sel``/
    ``ext``/``margin`` come from :func:`windowed_selection`.

    Returns ``(det, idx, peak_mag, noise, thresh_sq, mag_ext, rel)``:
    the detection verdict, peak FFT bin, peak magnitude, noise RMS and
    squared decision threshold (shared
    :func:`noise_and_threshold_sq` semantics, including the
    ultra-strong-carrier signed variance), plus the extended-window
    magnitudes and the peak's position within the core window for the
    caller's sub-bin interpolator.
    """
    from thrifty_tpu.dsp import mxu_fft

    n = blocks.shape[-1]
    spec_w = mxu_fft.windowed_dft(blocks, ext, fft_impl, fft_precision)
    mag_w = jnp.abs(spec_w)
    core = mag_w[..., margin:margin + len(sel)] if margin else mag_w
    rel = jnp.argmax(core, axis=-1).astype(jnp.int32)
    peak_mag = jnp.take_along_axis(core, rel[..., None], axis=-1)[..., 0]
    idx = jnp.asarray(sel)[rel]
    # Parseval: sum|FFT|^2 = N * sum|x|^2 (exact identity; f32
    # rounding differs from the spectral sum by ~1e-6 rel).
    energy = n * jnp.sum(
        jnp.square(blocks.real) + jnp.square(blocks.imag), axis=-1)
    noise, thresh_sq = noise_and_threshold_sq(
        energy, jnp.square(peak_mag), n, thresh_coeffs)
    det = peak_mag > jnp.sqrt(jnp.maximum(thresh_sq, 0.0))
    return det, idx, peak_mag, noise, thresh_sq, mag_w, rel
