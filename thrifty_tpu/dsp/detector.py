"""The fused, batched, jit-compiled detector.

Where the reference processes one 16384-sample block at a time through a
Python loop (thrifty/detect.py:60-78) or a C++ loop (fastdet/fastdet.cpp:
163-208), this detector processes a whole batch of blocks [B, N] in one
compiled XLA program: two batched FFTs + one batched IFFT plus fused
element-wise/reduction stages.  All decisions (thresholds, peak picks,
interpolations) are computed unconditionally as arrays and masked --
there is no data-dependent control flow, so XLA can fuse the stages into
a few device kernels that stream the batch through device memory.

Detection semantics match the reference exactly (same formulas, same
windows, same clipping); see the per-stage modules for file:line cites.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from thrifty_tpu.dsp import carrier, dirichlet, mxu_fft, shift, xcorr


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Static configuration of the batched detector."""

    block_len: int = 16384
    history_len: int = 4920
    carrier_thresh: tuple = (0.0, 15.0, 0.0)
    carrier_window: Optional[tuple] = None  # (start, stop) signed bins
    corr_thresh: tuple = (0.0, 15.0, 0.0)
    # 'fractional' = python-reference semantics (phase-ramp shift);
    # 'integer' = fastdet semantics (FFT roll, no second FFT);
    # 'preshift' = integer roll + bank of fractionally pre-shifted
    #   template FFTs (reference experimental/detect_preshift.py:24-45):
    #   fractional compensation without the second FFT.
    sync_mode: str = "fractional"
    num_preshift: int = 21
    interp_width: int = 6
    gn_iters: int = 12
    # Sub-sample correlation-peak interpolator: 'gaussian' (default,
    # reference soa_estimator.py:159-170), 'parabolic', 'cosine',
    # 'autocorr' (fit of the template's own correlation shape), 'none'
    # (integer peaks), or 'maximise' (band-limited golden-section
    # maximization of |corr|) -- the reference's experimental
    # xcorr_interpolators, all as first-class batched options.
    corr_interp: str = "gaussian"
    # Sub-bin carrier interpolator: 'auto' (default) resolves to
    # 'parabolic' in integer sync mode (fastdet computes the carrier
    # offset with 3-point parabolic interpolation clipped to +-0.5,
    # fastdet/corr_detector.cpp:88-101,190-194) and 'dirichlet'
    # elsewhere (the Python reference's curve-fit,
    # thrifty/carrier_sync.py:150-196).  Explicit values: 'dirichlet',
    # 'parabolic', 'polyfit', 'gaussian', 'cosine', 'none' (the last
    # three from experimental/carrier_interpolators.py).
    carrier_interp: str = "auto"
    # Dirichlet-shaped matched filter on the magnitude spectrum before
    # the carrier peak search (reference thrifty/carrier_detect.py:
    # 128-154, carrier_sync.py:121-147): 0 = off (the reference's
    # default), -1 = the reference's suggested auto width
    # (block_len//carrier_len - 1)*2 (carrier_sync.py:106-108), or an
    # explicit odd filter length.
    peak_filter_len: int = 0
    # FFT implementation: 'auto' (jnp.fft on every backend -- cuFFT on
    # the GPU; see dsp/mxu_fft.py for the on-card A/B that chose it),
    # 'matmul' (four-step DFT-as-matmul transforms), 'matmul3' (the
    # same with Karatsuba complex products), or 'xla' (jnp.fft).
    fft_impl: str = "auto"
    # Matmul-FFT contraction precision: 'highest' (full float32, the
    # default); 'high' and 'default' both let the GPU run the
    # contraction in TF32 (inputs rounded to a 10-bit mantissa; the
    # error measured on the card is in PERF.md) -- a throughput-over-
    # parity knob.  Ignored by the xla FFT path.  See dsp/mxu_fft.py.
    fft_precision: str = "highest"
    # Windowed-carrier fast path: 'auto' = on when eligible
    # (fractional sync + carrier window + no peak filter/stddev term
    # + matmul FFT impl -- see __init__), 'off' = always the full-FFT
    # carrier stage (the A/B + fallback knob).
    carrier_fast: str = "auto"
    # Carrier-stage matmul precision: 'auto' (default) = follow
    # fft_precision; 'highest'/'high'/'default' override it for the
    # CARRIER transform only (the windowed DFT / carrier FFT).  The
    # carrier stage's outputs are an argmax, threshold decisions and a
    # sub-bin offset, far more robust to a small relative magnitude
    # error than the correlation numerics that set sub-sample SoA, so a
    # cheaper precision is safest here.  Applied only where the carrier
    # transform is NOT shared with correlation: integer/preshift sync
    # reuse one FFT for both stages and therefore keep fft_precision.
    carrier_precision: str = "auto"
    # Separable fractional-sync ramp: 'auto' = evaluate the
    # carrier-compensation phase ramp in factored form fused into the
    # four-step transform whenever the matmul FFT impl is active
    # (mxu_fft.fft_ramped -- exp(2*pi*i*shift*(t/N-0.5)) splits
    # exactly over t = j1*n2 + j2: 128x fewer transcendental
    # evaluations and no materialized [B, N] ramp array); 'off' =
    # always the explicit full-ramp product (the A/B + fallback knob;
    # bit-exact with the reference formula under the xla FFT impl
    # either way, since 'auto' only fires on the matmul path).
    ramp_fast: str = "auto"
    # Carrier-gated correlation compaction: 0 = off; C > 0
    # runs the expensive correlation stages (carrier removal +
    # despread FFTs + peak/threshold) on at most C batch rows -- the
    # carrier-detected blocks, compacted to the front by a stable
    # argsort -- instead of all B.  This is the reference's own
    # dataflow: both reference detectors run correlation ONLY on
    # carrier-positive blocks (thrifty/detect.py:64-71 returns early
    # on carrier failure; fastcard exists to thin the stream to
    # carrier blocks before fastdet ever sees it), and at deployment
    # duty cycles most blocks carry no burst.  Exactness: gathered
    # rows compute the identical row-wise program; if a batch carries
    # more carrier detections than C, a lax.cond inside the SAME
    # compiled program falls back to full-batch correlation -- no
    # host round trip, no dropped blocks, bit-equal decisions either
    # way.  Every carrier-NEGATIVE row reports corr fields as zeros /
    # detected=False (the reference computes nothing for them at
    # all) -- uniformly, including capacity-filler rows, so a noise
    # block's outputs never depend on its batch's composition.
    # Sizing: C should comfortably exceed the expected
    # carrier blocks per batch (e.g. batch/2 at <=25% duty); the
    # false-alarm rate adds ~nothing (measured < 1.6e-3/block).
    gate_capacity: int = 0


class BatchDetector:
    """Batched detect: blocks [B, N] complex64 -> per-block detection arrays.

    Output dict fields (all [B], or [B, T] reduced over templates):
      detected       bool  -- carrier AND correlation detection
      carrier_detect bool
      carrier_bin    int32 -- FFT array index of carrier peak
      carrier_offset f32   -- sub-bin offset (Dirichlet fit)
      carrier_energy f32   -- carrier peak magnitude
      carrier_noise  f32
      corr_sample    int32 -- correlation peak lag within block
      corr_offset    f32   -- sub-sample offset (Gaussian interp)
      corr_energy    f32   -- correlation peak magnitude
      corr_noise     f32
      template_idx   int32 -- best-matching template (bank mode)
    """

    def __init__(self, template: np.ndarray, config: DetectorConfig):
        if config.sync_mode not in ("fractional", "integer", "preshift"):
            raise ValueError(
                "unknown sync_mode {!r}: expected 'fractional', 'integer' "
                "or 'preshift'".format(config.sync_mode))
        if config.fft_impl not in ("auto", "matmul", "matmul3",
                                   "xla"):
            raise ValueError(
                "unknown fft_impl {!r}: expected 'auto', 'matmul', "
                "'matmul3' or 'xla'".format(config.fft_impl))
        if config.fft_precision not in ("highest", "high", "default"):
            raise ValueError(
                "unknown fft_precision {!r}: expected 'highest', "
                "'high' or 'default'".format(config.fft_precision))
        if config.carrier_fast not in ("auto", "off"):
            raise ValueError(
                "unknown carrier_fast {!r}: expected 'auto' or "
                "'off'".format(config.carrier_fast))
        if config.carrier_precision not in ("auto", "highest", "high",
                                            "default"):
            raise ValueError(
                "unknown carrier_precision {!r}: expected 'auto', "
                "'highest', 'high' or 'default'".format(
                    config.carrier_precision))
        if config.ramp_fast not in ("auto", "off"):
            raise ValueError(
                "unknown ramp_fast {!r}: expected 'auto' or "
                "'off'".format(config.ramp_fast))
        if config.gate_capacity < 0:
            raise ValueError(
                "gate_capacity must be >= 0 (got {})".format(
                    config.gate_capacity))
        self.config = config
        template = np.asarray(template, dtype=np.float64)
        self.bank = template.ndim == 2
        tmpl2d = np.atleast_2d(template)
        self.num_templates, self.template_len = tmpl2d.shape
        if config.history_len < self.template_len - 1:
            raise ValueError("history_len must be >= template_len - 1")

        n = config.block_len
        self.corr_len = n - self.template_len + 1
        self.window = xcorr.corr_window(
            n, config.history_len, self.template_len
        )
        self.new_len = n - config.history_len

        # Precomputed constants, kept as numpy so they are embedded at
        # trace time (host->device transfer happens once per compile;
        # also avoids backend-specific device->host constant round-trips).
        self._tmpl_fft_conj = xcorr.template_fft_conj(template, n)
        self._tmpl_energy = xcorr.template_energy(template)
        self._carrier_mask = carrier.window_mask(config.carrier_window, n)
        if config.peak_filter_len:
            flen = config.peak_filter_len
            if flen == -1:
                flen = (n // self.template_len - 1) * 2
            self._peak_filter = dirichlet.dirichlet_weights(
                flen, n, self.template_len)
            # Explicit window order for the FIR: the mask alone cannot
            # encode the start bin of a wrapped FULL-span window (the
            # filter's start-up transient must sit at the window
            # start, matching the reference/oracle).
            w = config.carrier_window or (0, -1)
            self._carrier_sel = carrier.fft_window_indices(w[0], w[1], n)
        else:
            self._peak_filter = None
            self._carrier_sel = None

        if config.sync_mode == "preshift":
            if config.num_preshift < 2:
                # linspace(-0.5, 0.5, 1) is the lone [-0.5] entry: a
                # SYSTEMATIC half-bin template misalignment selected
                # for every block; 0 fails opaquely at trace time.
                raise ValueError(
                    "num_preshift must be >= 2 (got {})".format(
                        config.num_preshift))
            # Bank of conj template FFTs, each pre-shifted by a fractional
            # bin in [-0.5, 0.5]; selected per block by the residual
            # fractional carrier offset after the integer roll
            # (reference experimental/detect_preshift.py:24-45).  With a
            # template bank the array is [S, T, N]: every code gets all
            # fractional shifts (a trace-time constant, S*T*N*8 bytes).
            shifts = np.linspace(-0.5, 0.5, config.num_preshift)
            freqs = np.arange(n) / n - 0.5
            padded = np.zeros((self.num_templates, n), dtype=np.complex128)
            padded[:, : self.template_len] = tmpl2d
            rows = np.stack([
                np.conj(np.fft.fft(padded * np.exp(
                    -2j * np.pi * s * freqs)))
                for s in shifts
            ])  # [S, T, N]
            if not self.bank:
                rows = rows[:, 0]
            self._preshift_bank = rows.astype(np.complex64)
        # Integer mode is fastdet: sub-sample offsets clip to +-0.5 and
        # the carrier offset defaults to parabolic interpolation
        # (fastdet/corr_detector.cpp:88-116,190-194); the other modes
        # follow the Python reference (clip 0.6, Dirichlet fit --
        # thrifty/soa_estimator.py:16-17, carrier_sync.py:103-118).
        fastdet_mode = config.sync_mode == "integer"
        self.corr_clip = 0.5 if fastdet_mode else 0.6
        carrier_interp = config.carrier_interp
        if carrier_interp == "auto":
            carrier_interp = "parabolic" if fastdet_mode else "dirichlet"
        self.carrier_interp_resolved = carrier_interp
        if carrier_interp == "dirichlet":
            self._interp = dirichlet.make_dirichlet_interpolator(
                block_len=n,
                carrier_len=self.template_len,
                width=config.interp_width,
                iters=config.gn_iters,
            )
        elif carrier_interp == "parabolic":
            carrier_clip = 0.5 if fastdet_mode else None
            self._interp = (
                lambda mag, idx, values=None:
                dirichlet.parabolic_interpolate(mag, idx, clip=carrier_clip,
                                                values=values))
        elif carrier_interp == "polyfit":
            poly = dirichlet.make_polyfit_interpolator(config.interp_width)
            self._interp = (
                lambda mag, idx, values=None: poly(mag, idx, values=values))
        elif carrier_interp == "gaussian":
            self._interp = (
                lambda mag, idx, values=None:
                dirichlet.gaussian_interpolate(mag, idx, values=values))
        elif carrier_interp == "cosine":
            self._interp = (
                lambda mag, idx, values=None:
                dirichlet.cosine_interpolate(mag, idx, values=values))
        elif carrier_interp == "none":
            self._interp = (
                lambda mag, idx, values=None:
                jnp.zeros(idx.shape, jnp.float32))
        else:
            raise ValueError(
                "unknown carrier_interp: " + config.carrier_interp)

        # Integer/preshift rolls start at the carrier peak's FFT index
        # (+-1 for preshift's fractional rounding), so the roll's
        # wrapped extension only needs to reach the window's top index
        # (shift.integer_roll_fft max_start contract).  No bound
        # exists, and the roll keeps the full wrapped extension, when
        # (a) a carrier peak filter is configured (its group delay can
        # report a peak up to `delay` bins BELOW the window start,
        # wrapped mod n), or (b) preshift pairs with a carrier
        # interpolator whose offset is unbounded (dirichlet clamps to
        # +-1 and 'none' is 0; parabolic/polyfit/gaussian/cosine can
        # report arbitrarily large offsets on degenerate neighborhoods,
        # which would overrun the bound and silently clamp the slice).
        offset_unbounded = (config.sync_mode == "preshift"
                            and carrier_interp not in ("dirichlet",
                                                       "none"))
        if config.peak_filter_len or offset_unbounded:
            self._max_roll_start = None
        else:
            self._max_roll_start = int(np.flatnonzero(
                self._carrier_mask).max()) + 2

        clip = self.corr_clip
        if config.corr_interp == "gaussian":
            self._corr_interp = functools.partial(
                xcorr.gaussian_interpolate, clip=clip)
        elif config.corr_interp == "parabolic":
            self._corr_interp = functools.partial(
                xcorr.parabolic_interpolate, clip=clip)
        elif config.corr_interp == "cosine":
            self._corr_interp = functools.partial(
                xcorr.cosine_interpolate, clip=clip)
        elif config.corr_interp == "autocorr":
            self._corr_interp = xcorr.make_autocorr_interpolator(
                tmpl2d if self.bank else tmpl2d[0], clip=clip)
        elif config.corr_interp == "none":
            self._corr_interp = xcorr.none_interpolate
        elif config.corr_interp == "maximise":
            # Works on the correlation SPECTRUM, not |corr| -- wired
            # specially in _detect_batch (reference bounds +-0.55,
            # experimental/xcorr_interpolators.py:108).
            self._corr_interp = None
            self._maximise = xcorr.make_maximise_interpolator(clip=0.55)
        else:
            raise ValueError("unknown corr_interp: " + config.corr_interp)

        # Windowed-carrier fast path: in fractional sync the
        # full carrier FFT is consumed ONLY as (a) the windowed argmax
        # + peak neighborhood (reference thrifty/carrier_detect.py:
        # 61-96 searches just the window too -- it computes the full
        # FFT because FFTW has no windowed transform) and (b) the
        # total spectrum energy for the noise estimate
        # (carrier_detect.py:99-107).  (b) is Parseval on the time-domain
        # block (sum|X|^2 = N*sum|x|^2 -- energy the corr noise stage
        # computes anyway), so the whole 16384-point carrier FFT
        # collapses to a windowed DFT over the ~100-bin carrier window
        # plus the interpolator's margin (mxu_fft.windowed_dft): one
        # [n1, n1] column transform + a W-bin combine, about half a
        # four-step FFT, with no [B, N] spectrum or magnitude array
        # ever materialized.  Gated to the matmul FFT impl so the
        # jnp.fft path keeps bit-exact reference numerics; inactive
        # with a carrier peak filter (its FIR runs over the window
        # ORDER with a start-up transient) or a stddev threshold term
        # (needs every bin's magnitude).
        if carrier_interp in ("dirichlet", "polyfit"):
            win_half = config.interp_width // 2
        elif carrier_interp == "none":
            win_half = 0
        else:  # parabolic / gaussian / cosine: 3-point fits
            win_half = 1
        self._carrier_win = None
        if (config.carrier_fast == "auto"
                and config.sync_mode == "fractional"
                and config.peak_filter_len == 0):
            # Eligibility + index sets shared with the capture node's
            # CarrierGate (dsp.carrier.windowed_selection), plus the
            # detector-only conditions above (fractional sync: the
            # full FFT would otherwise be reused by the roll; no
            # magnitude-domain peak filter).
            win = carrier.windowed_selection(
                config.carrier_window, config.carrier_thresh, n,
                config.fft_impl, margin=win_half)
            if win is not None:
                self._carrier_win = (win[0], win[1], win_half)

        self._detect_jit = jax.jit(self._detect_batch)

    # -- the compiled program ------------------------------------------------

    def _detect_batch(self, blocks):
        cfg = self.config
        n = cfg.block_len
        signal_energy = self._signal_energy(blocks)

        # Carrier-stage accumulation precision: only applied where the
        # carrier transform is NOT shared with correlation (the
        # windowed DFT, and the full carrier FFT in fractional sync --
        # integer/preshift reuse that FFT for the roll/despread, so
        # they keep fft_precision).
        c_prec = cfg.carrier_precision \
            if cfg.carrier_precision != "auto" else cfg.fft_precision
        if cfg.sync_mode != "fractional":
            c_prec = cfg.fft_precision
        if self._carrier_win is not None:
            # Stage 1+2 fast path: windowed carrier DFT (shared core
            # with the capture node -- dsp.carrier.detect_windowed).
            sel, ext, half = self._carrier_win
            c_det, c_idx, c_mag, c_noise, _, mag_w, rel = \
                carrier.detect_windowed(
                    blocks, sel, ext, half, cfg.carrier_thresh,
                    cfg.fft_impl, c_prec)
            if half:
                nidx = (rel + half)[..., None] + jnp.arange(-half,
                                                            half + 1)
                neigh = jnp.take_along_axis(mag_w, nidx, axis=-1)
                c_off = self._interp(None, c_idx, values=neigh)
            else:
                c_off = self._interp(None, c_idx)
            fft = None  # unused by fractional-mode despread
        else:
            # Stage 1: carrier detection on |FFT|.
            fft = mxu_fft.fft(blocks, cfg.fft_impl, c_prec)
            mag = jnp.abs(fft)
            c_det, c_idx, c_mag, c_noise = carrier.detect(
                mag, self._carrier_mask, cfg.carrier_thresh,
                peak_filter=self._peak_filter,
                selection=self._carrier_sel
            )
            # Stage 2: sub-bin interpolation (only reported when
            # detected).
            c_off = self._interp(mag, c_idx)
        c_off = jnp.where(c_det, c_off, 0.0)

        # Stages 3-5: correlation, gated to the carrier-positive rows
        # when configured (see DetectorConfig.gate_capacity).
        cap = cfg.gate_capacity
        if cap and cap < blocks.shape[0]:
            p_idx, p_mag, p_det, p_off, noise = self._corr_stage_gated(
                blocks, fft, c_det, c_idx, c_off, signal_energy, cap)
        else:
            p_idx, p_mag, p_det, p_off, noise = self._corr_stage(
                blocks, fft, c_idx, c_off, signal_energy)

        return self._finish_outputs(c_det, c_idx, c_off, c_mag, c_noise,
                                    p_idx, p_mag, p_det, p_off, noise)

    def _corr_stage(self, blocks, fft, c_idx, c_off, signal_energy):
        """Stages 3-5: carrier removal + despread, windowed peak,
        noise/threshold, sub-sample offset.

        Strictly row-wise (every output row depends only on the same
        input row), so the carrier-gated path may run it on any
        compacted subset of the batch and scatter results back.
        Returns (p_idx, p_mag, p_det, p_off, noise).
        """
        cfg = self.config
        corr, spec = self._remove_carrier_and_despread(
            blocks, fft, c_idx, c_off, self.corr_len, with_spec=True)
        corr_mag = jnp.abs(corr)
        p_idx, p_mag = xcorr.window_peak(corr_mag, self.window)

        noise = self._corr_noise(signal_energy, p_mag, cfg.block_len)
        thresh = xcorr.threshold(corr_mag, noise, cfg.corr_thresh)
        p_det = p_mag > thresh
        if cfg.corr_interp == "maximise":
            p_off = self._maximise(spec, p_idx)
        else:
            p_off = self._corr_interp(corr_mag, p_idx)
        return p_idx, p_mag, p_det, p_off, noise

    def _corr_defaults(self, batch):
        """Correlation outputs for rows the gated path never computes:
        not detected, zero fields -- the reference computes nothing at
        all for carrier-negative blocks (thrifty/detect.py:64-71)."""
        shape = (batch, self.num_templates) if self.bank else (batch,)
        return (jnp.zeros(shape, jnp.int32),
                jnp.zeros(shape, jnp.float32),
                jnp.zeros(shape, bool),
                jnp.zeros(shape, jnp.float32),
                jnp.zeros(shape, jnp.float32))

    def _corr_stage_gated(self, blocks, fft, c_det, c_idx, c_off,
                          signal_energy, cap):
        """Correlation on a compacted carrier-positive subset.

        A stable argsort moves carrier-detected rows to the front (in
        index order); the first ``cap`` rows run :meth:`_corr_stage`
        and scatter back.  Non-gathered rows are carrier-negative by
        construction whenever the batch holds <= cap carrier
        detections; if it holds more, a ``lax.cond`` in the SAME
        compiled program re-runs the full-batch correlation instead --
        exact under all inputs, no host involvement.  See the
        DetectorConfig.gate_capacity comment for the reference-parity
        argument.
        """
        batch = blocks.shape[0]
        # Stable sort: False (carrier) keys first, original order
        # preserved within each class -- sel is cap distinct indices.
        sel = jnp.argsort(jnp.logical_not(c_det))[:cap]

        def gated(_):
            take = lambda a: None if a is None else jnp.take(
                a, sel, axis=0)
            outs = self._corr_stage(take(blocks), take(fft),
                                    take(c_idx), take(c_off),
                                    take(signal_energy))
            # Capacity FILLER rows (carrier-negative rows gathered
            # only because fewer than cap carriers exist) are masked
            # back to the defaults before the scatter: otherwise a
            # noise block's reported corr fields would depend on how
            # many carriers its batch happened to hold -- the
            # carrier-negative contract must be uniform (zeros /
            # not-detected), not batch-composition-dependent.
            keep = jnp.take(c_det, sel, axis=0)
            if self.bank:
                keep = keep[:, None]
            return tuple(
                d.at[sel].set(jnp.where(keep, o, jnp.zeros_like(o)))
                for d, o in zip(self._corr_defaults(batch), outs))

        def full(_):
            outs = self._corr_stage(blocks, fft, c_idx, c_off,
                                    signal_energy)
            # Same carrier-negative masking as the gated branch: the
            # uniform contract (zeros / not-detected on every
            # carrier-negative row) must hold regardless of WHICH
            # branch executed, or a noise block's outputs would depend
            # on its batch's composition.  Rows the reference computes
            # are untouched -- detected rows are carrier-positive.
            keep = c_det[:, None] if self.bank else c_det
            return tuple(jnp.where(keep, o, jnp.zeros_like(o))
                         for o in outs)

        overflow = jnp.sum(c_det.astype(jnp.int32)) > cap
        return jax.lax.cond(overflow, full, gated, None)

    @staticmethod
    def _signal_energy(blocks):
        """Time-domain block energy sum(|x|^2), shared by the carrier
        noise (via Parseval on the fast path) and corr noise stages."""
        return jnp.sum(
            jnp.square(blocks.real) + jnp.square(blocks.imag), axis=-1)

    def _corr_noise(self, signal_energy, p_mag, n):
        """Correlation noise from the block's time-domain energy
        (one formula for the full and gated correlation stages)."""
        if self.bank:
            signal_energy = signal_energy[:, None]
        return xcorr.noise_rms(p_mag, signal_energy, self._tmpl_energy, n)

    def _finish_outputs(self, c_det, c_idx, c_off, c_mag, c_noise,
                        p_idx, p_mag, p_det, p_off, noise):
        """Epilogue of the detect program: mask the offset on
        non-detections, reduce the template bank by peak magnitude,
        assemble the output dict."""
        p_off = jnp.where(p_det, p_off, 0.0)
        if self.bank:
            # Pick the best template per block by peak magnitude.
            best = jnp.argmax(p_mag, axis=-1)
            take = lambda a: jnp.take_along_axis(
                a, best[:, None], axis=-1)[:, 0]
            p_idx, p_mag = take(p_idx), take(p_mag)
            noise, p_det = take(noise), take(p_det)
            p_off = take(p_off)
            template_idx = best.astype(jnp.int32)
        else:
            template_idx = jnp.zeros_like(c_idx)

        return {
            "detected": c_det & p_det,
            "carrier_detect": c_det,
            "carrier_bin": c_idx,
            "carrier_offset": c_off,
            "carrier_energy": c_mag,
            "carrier_noise": c_noise,
            "corr_sample": p_idx,
            "corr_offset": p_off,
            "corr_energy": p_mag,
            "corr_noise": noise,
            "template_idx": template_idx,
        }

    def _remove_carrier_and_despread(self, blocks, fft, c_idx, c_off,
                                     corr_len, with_spec=False):
        """Stage 3+4: carrier-compensated correlation, [.., corr_len].

        ``with_spec`` also returns the correlation spectrum X (with
        corr = IFFT(X)) for band-limited fractional evaluation (the
        'maximise' interpolator); XLA dead-code-eliminates it when
        unused.
        """
        cfg = self.config
        if cfg.sync_mode == "fractional":
            # Wrap the peak's FFT index to its SIGNED bin before
            # building the phase ramp: ramps for s and s+N are
            # mathematically identical (even N), but a |shift| ~ N ramp
            # accumulates ~2*pi*N/2 radians of f32 phase and loses ~3
            # decimal digits of carrier alignment for negative-
            # frequency carriers (array index near N); the signed bin
            # keeps the ramp phase small and exact.
            n = cfg.block_len
            signed = ((c_idx + n // 2) % n) - n // 2
            shift_bins = -(signed.astype(jnp.float32) + c_off)
            ramp = "separable" if cfg.ramp_fast == "auto" else "full"
            shifted = shift.fractional_shift_fft(
                blocks, shift_bins, impl=cfg.fft_impl,
                precision=cfg.fft_precision, ramp=ramp)
            spec = xcorr.despread_spec(shifted, self._tmpl_fft_conj)
        elif cfg.sync_mode == "integer":
            shifted = shift.integer_roll_fft(
                fft, -c_idx, max_start=self._max_roll_start)
            spec = xcorr.despread_spec(shifted, self._tmpl_fft_conj)
        elif cfg.sync_mode == "preshift":
            # Integer roll + per-block fractionally pre-shifted template:
            # fractional compensation without a second signal FFT.
            # Signed-bin wrap as in 'fractional': at |shift| ~ N the
            # f32 fractional part only has ~2e-3 granularity.
            n = cfg.block_len
            signed = ((c_idx + n // 2) % n) - n // 2
            shift_total = -(signed.astype(jnp.float32) + c_off)
            int_shift = jnp.round(shift_total).astype(jnp.int32)
            frac = jnp.clip(shift_total - int_shift, -0.5, 0.5)
            shifted = shift.integer_roll_fft(
                fft, int_shift, max_start=self._max_roll_start)
            sel = jnp.round(
                (frac + 0.5) * (cfg.num_preshift - 1)).astype(jnp.int32)
            tconj = jnp.asarray(self._preshift_bank)[sel]  # [B,(T,)N]
            if self.bank:
                shifted = shifted[:, None, :]
            spec = shifted * tconj
        else:
            raise ValueError("unknown sync_mode: " + cfg.sync_mode)
        # Head-trimmed inverse: lags >= corr_len are discarded anyway
        # (exact -- same dot products, see mxu_fft._transform).
        corr = mxu_fft.ifft_head(spec, corr_len, cfg.fft_impl,
                                 cfg.fft_precision)
        return (corr, spec) if with_spec else corr

    def _detect_batch_raw(self, raw):
        """Detect directly on raw uint8 interleaved I/Q [B, 2N].

        The uint8->complex conversion runs on device, fused into the
        first FFT's input read: the batch crosses host->device and
        device memory at 2 bytes/sample instead of 8.
        """
        from thrifty_tpu.dsp import iq as iq_mod

        return self._detect_batch(iq_mod.raw_to_iq_jax(raw))

    def _detect_batch_u16(self, rows):
        """Detect on packed I/Q byte pairs, uint16 [B, N] (one sample
        per element; see iq.u16_to_iq_jax)."""
        from thrifty_tpu.dsp import iq as iq_mod

        return self._detect_batch(iq_mod.u16_to_iq_jax(rows))

    def _unfold_stream(self, new_u16, carry_u16):
        from thrifty_tpu.dsp.unfold import unfold_stream

        return unfold_stream(new_u16, carry_u16, self.config.block_len,
                             self.config.history_len)

    # -- host API ------------------------------------------------------------

    def __call__(self, blocks):
        """Run detection on a [B, N] complex64 batch (device or host array)."""
        return self._detect_jit(jnp.asarray(blocks))

    def _detect_u16(self, rows):
        if not hasattr(self, "_detect_u16_jit"):
            self._detect_u16_jit = jax.jit(self._detect_batch_u16)
        return self._detect_u16_jit(rows)

    def detect_raw(self, raw):
        """Run detection on raw uint8 interleaved I/Q [B, 2N].

        The bytes are viewed as packed uint16 sample pairs on the host
        (no copy) and run through the same compiled program as
        :meth:`detect_raw_stream`'s rows, so both ingest paths give
        bit-identical outputs for the same samples.
        """
        raw = np.ascontiguousarray(raw, dtype=np.uint8)
        return self._detect_u16(raw.view(np.uint16))

    def detect_raw_stream(self, new_raw):
        """Run detection on CONTIGUOUS raw uint8 I/Q stream bytes.

        ``new_raw``: uint8 [B*2*new_len] -- the stream's new bytes for
        B blocks, with NO repeated history.  The host ships 1.43x fewer
        bytes than the pre-unfolded [B, 2*block_len] path; the
        overlap-save unfold runs on device (dsp.unfold.unfold_stream)
        against a device-resident carry of the previous call's tail,
        and the rows then go through :meth:`detect_raw`'s compiled
        program.  Call :meth:`reset_stream` before reusing the detector
        on a new stream.  Pre-stream history is zero-signal (0x80
        bytes), the same convention as the host unfold.
        """
        if not hasattr(self, "_unfold_jit"):
            self._unfold_jit = jax.jit(self._unfold_stream)
        rows = self._stream_state.call(self._unfold_jit, new_raw,
                                       new_len=self.new_len)
        return self._detect_u16(rows)

    @property
    def _stream_state(self):
        from thrifty_tpu.dsp.unfold import StreamCarry
        if getattr(self, "_stream_carry_state", None) is None:
            self._stream_carry_state = StreamCarry(self.config.history_len)
        return self._stream_carry_state

    def reset_stream(self):
        """Reset :meth:`detect_raw_stream`'s device-side history carry
        to the zero-signal (0x8080) pre-stream state."""
        self._stream_state.reset()

    def soa(self, block_idx, corr_sample, corr_offset):
        """Absolute sample-of-arrival since receiver start (host, float64).

        soa = (block_len - history_len)*block_idx + peak + offset
        (reference thrifty/detect.py:67-69, fastdet/fastdet.cpp:185-186).
        Computed on host in float64: block_idx can be large enough that
        float32 would lose sub-sample precision.
        """
        return (
            np.asarray(block_idx, dtype=np.float64) * self.new_len
            + np.asarray(corr_sample, dtype=np.float64)
            + np.asarray(corr_offset, dtype=np.float64)
        )
