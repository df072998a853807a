"""DFT-as-matmul transforms (dsp/mxu_fft.py) vs numpy, and in the detector."""

import numpy as np
import pytest
import jax.numpy as jnp

from thrifty_tpu.dsp import mxu_fft


def rand(b, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, n))
            + 1j * rng.normal(size=(b, n))).astype(np.complex64)


@pytest.mark.parametrize("n", [64, 256, 2048, 4096, 16384])
def test_matmul_fft_matches_numpy(n):
    x = rand(3, n, seed=n)
    ref = np.fft.fft(x.astype(np.complex128))
    got = np.asarray(mxu_fft.fft(x, impl="matmul"))
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(got - ref)) / scale < 2e-5, n


@pytest.mark.parametrize("n", [256, 4096, 16384])
def test_matmul_ifft_matches_numpy(n):
    x = rand(2, n, seed=n + 1)
    ref = np.fft.ifft(x.astype(np.complex128))
    got = np.asarray(mxu_fft.ifft(x, impl="matmul"))
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(got - ref)) / scale < 2e-5, n


def test_roundtrip():
    x = rand(2, 16384, seed=7)
    back = np.asarray(mxu_fft.ifft(mxu_fft.fft(x, "matmul"), "matmul"))
    assert np.max(np.abs(back - x)) < 1e-4


def test_auto_is_xla_on_cpu():
    """On CPU 'auto' must keep jnp.fft numerics bit-for-bit (goldens
    and oracle tests rely on them)."""
    import jax.numpy as jnp

    x = rand(2, 1024, seed=3)
    np.testing.assert_array_equal(
        np.asarray(mxu_fft.fft(x, "auto")), np.asarray(jnp.fft.fft(x)))


def test_unfactorable_size_falls_back():
    """A size with no DFT-matrix or four-step plan still transforms
    correctly via the jnp fallback even under impl='matmul'."""
    x = rand(1, 6000, seed=4)  # 6000 not 128-divisible, > _DFT_MAX
    ref = np.fft.fft(x.astype(np.complex128))
    got = np.asarray(mxu_fft.fft(x, impl="matmul"))
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 2e-5


def test_bad_impl_rejected():
    with pytest.raises(ValueError, match="unknown fft impl"):
        mxu_fft.fft(rand(1, 64), impl="fast")


def test_leading_dims():
    x = rand(6, 16384, seed=9).reshape(2, 3, 16384)
    ref = np.fft.fft(x.astype(np.complex128))
    got = np.asarray(mxu_fft.fft(x, impl="matmul"))
    assert got.shape == x.shape
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 2e-5


class TestDetectorEquivalence:
    def test_detector_matmul_fft_matches_xla(self):
        """Full detector with fft_impl='matmul' vs 'xla': identical
        decisions and peak indices, float surfaces within the matmul
        transform's f32-grade error."""
        from thrifty_tpu import sim
        from thrifty_tpu.dsp.detector import BatchDetector, DetectorConfig

        tpl = sim.make_template()
        cap = sim.synth_capture(num_blocks=12, bursts_every=3,
                                template=tpl, seed=11, quantize=True)
        outs = {}
        for impl in ("xla", "matmul"):
            det = BatchDetector(tpl, DetectorConfig(
                carrier_window=(7, 110), fft_impl=impl))
            outs[impl] = {k: np.asarray(v)
                          for k, v in det(cap.blocks).items()}
        a, b = outs["xla"], outs["matmul"]
        np.testing.assert_array_equal(a["detected"], b["detected"])
        np.testing.assert_array_equal(a["carrier_bin"], b["carrier_bin"])
        np.testing.assert_array_equal(a["corr_sample"], b["corr_sample"])
        np.testing.assert_allclose(a["corr_offset"], b["corr_offset"],
                                   atol=1e-3)
        np.testing.assert_allclose(a["corr_energy"], b["corr_energy"],
                                   rtol=1e-4)
        det_m = BatchDetector(tpl, DetectorConfig(
            carrier_window=(7, 110), fft_impl="matmul"))
        out = {k: np.asarray(v) for k, v in det_m(cap.blocks).items()}
        soa = det_m.soa(cap.indices, out["corr_sample"],
                        out["corr_offset"])
        for burst in cap.bursts:
            assert out["detected"][burst.block_idx]
            assert abs(soa[burst.block_idx] - burst.expected_soa) < 0.05

    def test_bad_fft_impl_rejected(self):
        from thrifty_tpu import sim
        from thrifty_tpu.dsp.detector import BatchDetector, DetectorConfig

        with pytest.raises(ValueError, match="unknown fft_impl"):
            BatchDetector(sim.make_template(),
                          DetectorConfig(fft_impl="fftw"))


class TestWindowedDft:
    """windowed_dft: carrier-window transform (round 5)."""

    @pytest.mark.parametrize("n,sel", [
        (16384, np.arange(7, 111)),            # example carrier window
        (16384, np.arange(-10, 11) % 16384),   # wrapped window
        (1024, np.arange(3, 40)),              # dense-matrix path
    ])
    def test_matches_full_fft(self, n, sel):
        x = rand(3, n, seed=n + len(sel))
        ref = np.fft.fft(x.astype(np.complex128))[:, sel]
        got = np.asarray(mxu_fft.windowed_dft(x, sel, impl="matmul"))
        assert got.shape == (3, len(sel))
        assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 2e-5

    def test_xla_impl_is_exact_take(self):
        import jax.numpy as jnp

        x = rand(2, 2048, seed=12)
        sel = np.arange(5, 50)
        got = np.asarray(mxu_fft.windowed_dft(x, sel, impl="xla"))
        exact = np.asarray(jnp.fft.fft(x))[:, sel]
        np.testing.assert_array_equal(got, exact)

    def test_out_of_range_bins_rejected(self):
        with pytest.raises(ValueError, match="out of range"):
            mxu_fft.windowed_dft(rand(1, 256), np.asarray([256]),
                                 impl="matmul")

    def test_leading_dims(self):
        x = rand(6, 16384, seed=2).reshape(2, 3, 16384)
        sel = np.arange(7, 111)
        got = np.asarray(mxu_fft.windowed_dft(x, sel, impl="matmul"))
        ref = np.fft.fft(x.astype(np.complex128))[..., sel]
        assert got.shape == (2, 3, len(sel))
        assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 2e-5


class TestIfftHead:
    """ifft_head: exact head-trimmed inverse transform (round 5)."""

    @pytest.mark.parametrize("n,m", [(16384, 11471), (16384, 16384),
                                     (1024, 100), (256, 1)])
    def test_equals_sliced_ifft(self, n, m):
        x = rand(2, n, seed=n + m)
        full = np.asarray(mxu_fft.ifft(x, "matmul"))[..., :m]
        head = np.asarray(mxu_fft.ifft_head(x, m, "matmul"))
        assert head.shape == (2, m)
        # Same dot products, minus discarded outputs; XLA may fuse the
        # smaller matmul differently, so allow ULP-scale noise.
        assert np.max(np.abs(head - full)) < 1e-6

    def test_xla_impl_is_exact_slice(self):
        x = rand(2, 6000, seed=3)  # unfactorable -> jnp fallback
        full = np.asarray(mxu_fft.ifft(x, "xla"))[..., :123]
        head = np.asarray(mxu_fft.ifft_head(x, 123, "xla"))
        np.testing.assert_array_equal(head, full)


class TestPrecision:
    def test_high_precision_runs_and_is_coarser(self):
        """'high' (TF32 on the GPU; still f32 matmul on CPU) transforms
        correctly; 'default' is accepted but documented-lossy."""
        x = rand(2, 16384, seed=8)
        ref = np.fft.fft(x.astype(np.complex128))
        for prec in ("high", "default"):
            got = np.asarray(mxu_fft.fft(x, "matmul", prec))
            # CPU matmuls ignore the precision hint -- just assert the
            # correctness envelope here; chip_smoke.py measures 'high'
            # on the card.
            err = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
            assert err < 1e-2, (prec, err)

    def test_bad_precision_rejected(self):
        with pytest.raises(ValueError, match="unknown fft precision"):
            mxu_fft.fft(rand(1, 256), "matmul", "quad")


class TestWindowedCarrierFastPath:
    """Detector-level equivalence of the windowed-carrier stage."""

    @pytest.mark.parametrize("interp", ["dirichlet", "parabolic",
                                        "gaussian", "cosine",
                                        "polyfit", "none"])
    def test_matches_full_path_per_interp(self, interp):
        from thrifty_tpu import sim
        from thrifty_tpu.dsp.detector import BatchDetector, DetectorConfig

        tpl = sim.make_template()
        cap = sim.synth_capture(num_blocks=10, bursts_every=3,
                                template=tpl, seed=17, quantize=True)
        outs = {}
        for impl in ("matmul", "xla"):
            det = BatchDetector(tpl, DetectorConfig(
                carrier_window=(7, 110), fft_impl=impl,
                carrier_interp=interp))
            if impl == "matmul":
                assert det._carrier_win is not None
            outs[impl] = {k: np.asarray(v)
                          for k, v in det(cap.blocks).items()}
        a, b = outs["xla"], outs["matmul"]
        np.testing.assert_array_equal(a["detected"], b["detected"])
        np.testing.assert_array_equal(a["carrier_bin"], b["carrier_bin"])
        np.testing.assert_array_equal(a["corr_sample"], b["corr_sample"])
        np.testing.assert_allclose(a["carrier_offset"],
                                   b["carrier_offset"], atol=2e-3)
        np.testing.assert_allclose(a["carrier_noise"],
                                   b["carrier_noise"], rtol=1e-4)
        np.testing.assert_allclose(a["carrier_energy"],
                                   b["carrier_energy"], rtol=1e-4)
        np.testing.assert_allclose(a["corr_offset"], b["corr_offset"],
                                   atol=2e-3)

    def test_gating(self):
        """The fast path requires: fractional sync, a carrier window,
        no peak filter, no stddev term, matmul FFT impl."""
        from thrifty_tpu import sim
        from thrifty_tpu.dsp.detector import BatchDetector, DetectorConfig

        tpl = sim.make_template()
        on = dict(carrier_window=(7, 110), fft_impl="matmul")
        assert BatchDetector(
            tpl, DetectorConfig(**on))._carrier_win is not None
        for off in (dict(on, fft_impl="xla"),
                    dict(on, sync_mode="integer"),
                    dict(on, sync_mode="preshift"),
                    dict(on, carrier_window=None),
                    dict(on, peak_filter_len=5),
                    dict(on, carrier_thresh=(0.0, 15.0, 1.0)),
                    dict(on, carrier_fast="off")):
            assert BatchDetector(
                tpl, DetectorConfig(**off))._carrier_win is None, off

    def test_bad_carrier_fast_rejected(self):
        from thrifty_tpu import sim
        from thrifty_tpu.dsp.detector import BatchDetector, DetectorConfig

        with pytest.raises(ValueError, match="unknown carrier_fast"):
            BatchDetector(sim.make_template(),
                          DetectorConfig(carrier_fast="on"))

    def test_wrapped_window(self):
        """A window spanning negative bins wraps through index 0."""
        from thrifty_tpu import sim
        from thrifty_tpu.dsp.detector import BatchDetector, DetectorConfig

        tpl = sim.make_template()
        cap = sim.synth_capture(num_blocks=6, bursts_every=3,
                                template=tpl, seed=23, quantize=True,
                                carrier_bin=-20)
        outs = {}
        for impl in ("matmul", "xla"):
            det = BatchDetector(tpl, DetectorConfig(
                carrier_window=(-60, -5), fft_impl=impl))
            outs[impl] = {k: np.asarray(v)
                          for k, v in det(cap.blocks).items()}
        a, b = outs["xla"], outs["matmul"]
        np.testing.assert_array_equal(a["detected"], b["detected"])
        np.testing.assert_array_equal(a["carrier_bin"], b["carrier_bin"])
        np.testing.assert_array_equal(a["corr_sample"], b["corr_sample"])

    def test_carrier_fast_off_isolates_windowed_stage(self):
        """carrier_fast='off' + matmul vs 'auto' + matmul differ ONLY
        by the windowed carrier stage: identical decisions/indices,
        float surfaces within the windowed transform's f32 error."""
        from thrifty_tpu import sim
        from thrifty_tpu.dsp.detector import BatchDetector, DetectorConfig

        tpl = sim.make_template()
        cap = sim.synth_capture(num_blocks=10, bursts_every=3,
                                template=tpl, seed=31, quantize=True)
        outs = {}
        for fast in ("auto", "off"):
            det = BatchDetector(tpl, DetectorConfig(
                carrier_window=(7, 110), fft_impl="matmul",
                carrier_fast=fast))
            assert (det._carrier_win is not None) == (fast == "auto")
            outs[fast] = {k: np.asarray(v)
                          for k, v in det(cap.blocks).items()}
        a, b = outs["off"], outs["auto"]
        np.testing.assert_array_equal(a["detected"], b["detected"])
        np.testing.assert_array_equal(a["carrier_bin"], b["carrier_bin"])
        np.testing.assert_array_equal(a["corr_sample"], b["corr_sample"])
        np.testing.assert_allclose(a["carrier_offset"],
                                   b["carrier_offset"], atol=1e-4)
        np.testing.assert_allclose(a["carrier_noise"],
                                   b["carrier_noise"], rtol=1e-5)
        np.testing.assert_allclose(a["corr_offset"], b["corr_offset"],
                                   atol=1e-4)

    @pytest.mark.parametrize("block_len,hist,win", [
        (2048, 64, (4, 60)),      # small geometry
        (2048, 64, (-30, 30)),    # window wrapping DC
        (4096, 128, (-120, -4)),  # all-negative bins
        (2048, 64, (1, 8)),       # window narrower than interp margin
    ])
    def test_odd_geometries(self, block_len, hist, win):
        """Wrapped / edge / tiny windows across block sizes: windowed
        path equals the full path on decisions and indices."""
        from thrifty_tpu import sim
        from thrifty_tpu.dsp import template as template_mod
        from thrifty_tpu.dsp.detector import BatchDetector, DetectorConfig

        tpl = template_mod.generate(5, 0, 2.0)  # 62-sample Gold code
        cap = sim.synth_capture(num_blocks=8, bursts_every=3,
                                template=tpl, block_len=block_len,
                                history_len=hist,
                                carrier_bin=(win[0] + win[1]) / 2,
                                seed=3)
        outs = {}
        for impl in ("matmul", "xla"):
            det = BatchDetector(tpl, DetectorConfig(
                block_len=block_len, history_len=hist,
                carrier_window=win, fft_impl=impl, gn_iters=4))
            if impl == "matmul":
                assert det._carrier_win is not None
            outs[impl] = {k: np.asarray(v)
                          for k, v in det(cap.blocks).items()}
        a, b = outs["xla"], outs["matmul"]
        np.testing.assert_array_equal(a["detected"], b["detected"])
        np.testing.assert_array_equal(a["carrier_bin"], b["carrier_bin"])
        np.testing.assert_array_equal(a["corr_sample"], b["corr_sample"])


class TestMatmul3:
    """impl='matmul3': Karatsuba 3-real-product complex contractions."""

    @pytest.mark.parametrize("n", [256, 2048, 4096, 16384])
    def test_fft_matches_numpy(self, n):
        x = rand(3, n, seed=n + 5)
        ref = np.fft.fft(x.astype(np.complex128))
        got = np.asarray(mxu_fft.fft(x, impl="matmul3"))
        assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 2e-5

    def test_ifft_head_and_windowed(self):
        x = rand(2, 16384, seed=41)
        refi = np.fft.ifft(x.astype(np.complex128))[:, :11471]
        goti = np.asarray(mxu_fft.ifft_head(x, 11471, "matmul3"))
        assert np.max(np.abs(goti - refi)) / np.max(np.abs(refi)) < 2e-5
        sel = np.arange(4, 120)
        refw = np.fft.fft(x.astype(np.complex128))[:, sel]
        gotw = np.asarray(mxu_fft.windowed_dft(x, sel, "matmul3"))
        assert np.max(np.abs(gotw - refw)) / np.max(np.abs(refw)) < 2e-5

    def test_detector_equivalence(self):
        from thrifty_tpu import sim
        from thrifty_tpu.dsp.detector import BatchDetector, DetectorConfig

        tpl = sim.make_template()
        cap = sim.synth_capture(num_blocks=8, bursts_every=3,
                                template=tpl, seed=11, quantize=True)
        outs = {}
        for impl in ("xla", "matmul3"):
            det = BatchDetector(tpl, DetectorConfig(
                carrier_window=(7, 110), fft_impl=impl))
            outs[impl] = {k: np.asarray(v)
                          for k, v in det(cap.blocks).items()}
        a, b = outs["xla"], outs["matmul3"]
        np.testing.assert_array_equal(a["detected"], b["detected"])
        np.testing.assert_array_equal(a["carrier_bin"], b["carrier_bin"])
        np.testing.assert_array_equal(a["corr_sample"], b["corr_sample"])
        np.testing.assert_allclose(a["corr_offset"], b["corr_offset"],
                                   atol=1e-3)


class TestSeparableRamp:
    """fft_ramped: the fractional-sync ramp factored over the
    four-step split (round 5).  The wrapped form (integer shift part
    reduced mod n1 exactly) must beat the full f32 ramp's accuracy
    against the float64 oracle, not just match it."""

    @staticmethod
    def _oracle(x, s):
        n = x.shape[-1]
        pos = np.arange(n) / n - 0.5
        return np.fft.fft(
            x.astype(np.complex128)
            * np.exp(2j * np.pi * s.astype(np.float64)[:, None] * pos),
            axis=-1)

    def test_matches_f64_oracle(self):
        rng = np.random.default_rng(5)
        x = (rng.standard_normal((4, 16384))
             + 1j * rng.standard_normal((4, 16384))
             ).astype(np.complex64)
        s = rng.uniform(-110, 110, 4).astype(np.float32)
        ref = self._oracle(x, s)
        scale = np.abs(ref).max()
        got = np.asarray(mxu_fft.fft_ramped(jnp.asarray(x),
                                            jnp.asarray(s), "matmul"))
        sep_err = np.abs(got - ref).max() / scale
        assert sep_err < 2e-6, sep_err
        # ...and strictly better than the full f32 ramp through the
        # same transform (large unwrapped phases cost it ~1e-5).
        from thrifty_tpu.dsp import shift as shift_mod
        full = np.asarray(shift_mod.fractional_shift_fft(
            jnp.asarray(x), jnp.asarray(s), impl="matmul", ramp="full"))
        full_err = np.abs(full - ref).max() / scale
        assert sep_err < full_err, (sep_err, full_err)

    def test_edge_shifts(self):
        """Half-integer rounding boundaries, zero, negatives."""
        rng = np.random.default_rng(6)
        s = np.array([0.0, -0.5, 0.5, 109.5, -109.5, 37.25,
                      -0.49999, 3.0], np.float32)
        x = (rng.standard_normal((8, 16384))
             + 1j * rng.standard_normal((8, 16384))
             ).astype(np.complex64)
        ref = self._oracle(x, s)
        got = np.asarray(mxu_fft.fft_ramped(jnp.asarray(x),
                                            jnp.asarray(s), "matmul"))
        assert np.abs(got - ref).max() / np.abs(ref).max() < 2e-6

    def test_fallback_paths(self):
        """xla impl and non-four-step sizes take the full-ramp path."""
        rng = np.random.default_rng(7)
        for n, impl in ((1024, "matmul"), (16384, "xla")):
            x = (rng.standard_normal((3, n))
                 + 1j * rng.standard_normal((3, n))
                 ).astype(np.complex64)
            s = rng.uniform(-20, 20, 3).astype(np.float32)
            ref = self._oracle(x, s)
            got = np.asarray(mxu_fft.fft_ramped(jnp.asarray(x),
                                                jnp.asarray(s), impl))
            assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5

    def test_matmul3(self):
        rng = np.random.default_rng(8)
        x = (rng.standard_normal((3, 16384))
             + 1j * rng.standard_normal((3, 16384))
             ).astype(np.complex64)
        s = rng.uniform(-110, 110, 3).astype(np.float32)
        ref = self._oracle(x, s)
        got = np.asarray(mxu_fft.fft_ramped(jnp.asarray(x),
                                            jnp.asarray(s), "matmul3"))
        assert np.abs(got - ref).max() / np.abs(ref).max() < 4e-6

    def test_detector_equivalence(self):
        """ramp_fast auto-vs-off under the matmul impl: decisions and
        integer fields equal, offsets within interpolation tolerance."""
        import dataclasses

        from thrifty_tpu import sim
        from thrifty_tpu.dsp.detector import BatchDetector, DetectorConfig

        tpl = sim.make_template()
        cap = sim.synth_capture(num_blocks=12, bursts_every=3,
                                template=tpl, seed=13, quantize=True)
        base = DetectorConfig(carrier_window=(7, 110), fft_impl="matmul")
        outs = {}
        for mode in ("auto", "off"):
            det = BatchDetector(tpl, dataclasses.replace(
                base, ramp_fast=mode))
            outs[mode] = {k: np.asarray(v)
                          for k, v in det(cap.blocks).items()}
        a, b = outs["auto"], outs["off"]
        np.testing.assert_array_equal(a["detected"], b["detected"])
        np.testing.assert_array_equal(a["carrier_bin"], b["carrier_bin"])
        np.testing.assert_array_equal(a["corr_sample"], b["corr_sample"])
        np.testing.assert_allclose(a["corr_offset"], b["corr_offset"],
                                   atol=1e-3)
        np.testing.assert_allclose(a["corr_energy"], b["corr_energy"],
                                   rtol=1e-4)


class TestCarrierPrecision:
    """carrier_precision: matmul precision override for the carrier
    transform only (round 5)."""

    def _run(self, **over):
        import dataclasses

        from thrifty_tpu import sim
        from thrifty_tpu.dsp.detector import BatchDetector, DetectorConfig

        tpl = sim.make_template()
        cap = sim.synth_capture(num_blocks=12, bursts_every=3,
                                template=tpl, seed=17, quantize=True)
        cfg = dataclasses.replace(
            DetectorConfig(carrier_window=(7, 110), fft_impl="matmul"),
            **over)
        det = BatchDetector(tpl, cfg)
        return {k: np.asarray(v) for k, v in det(cap.blocks).items()}

    def test_high_carrier_equivalent_at_clear_snr(self):
        a = self._run()
        b = self._run(carrier_precision="high")
        np.testing.assert_array_equal(a["detected"], b["detected"])
        np.testing.assert_array_equal(a["carrier_bin"], b["carrier_bin"])
        np.testing.assert_array_equal(a["corr_sample"], b["corr_sample"])
        # Carrier magnitudes at reduced-precision grade (TF32 on the
        # GPU); corr numerics unchanged
        # up to the carrier-offset feedthrough into the sync ramp.
        m = a["detected"]
        np.testing.assert_allclose(a["carrier_energy"][m],
                                   b["carrier_energy"][m], rtol=2e-3)
        np.testing.assert_allclose(a["carrier_offset"][m],
                                   b["carrier_offset"][m], atol=5e-3)
        np.testing.assert_allclose(a["corr_offset"][m],
                                   b["corr_offset"][m], atol=1e-3)

    def test_shared_fft_modes_ignore_it(self):
        """integer sync shares one FFT between carrier and corr: the
        override must not alter ANY output bit (it is ignored)."""
        a = self._run(sync_mode="integer")
        b = self._run(sync_mode="integer", carrier_precision="high")
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    def test_validation(self):
        import pytest

        with pytest.raises(ValueError, match="carrier_precision"):
            self._run(carrier_precision="hi")
