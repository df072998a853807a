"""The detector's plain peak/energy reductions (what XLA fuses on the
device): windowed argmax edges, ties, empty windows, the optional
stddev threshold terms and template-bank interpolation, checked against
direct numpy and the float64 oracle."""

import numpy as np
import pytest

import jax.numpy as jnp

from thrifty_tpu import sim
from thrifty_tpu.dsp import carrier, template as template_mod, xcorr
from thrifty_tpu.dsp.detector import BatchDetector, DetectorConfig
from thrifty_tpu.oracle.numpy_ref import OracleDetector

N = 2048


def noise_mag(b=4, n=N, seed=0):
    rng = np.random.default_rng(seed)
    return np.abs(rng.normal(size=(b, n))
                  + 1j * rng.normal(size=(b, n))).astype(np.float32)


@pytest.mark.parametrize("where", ["first", "last"])
def test_carrier_peak_at_window_edge(where):
    """A peak on the first or last bin of the window is found, and a
    larger one just outside the window is ignored."""
    mask = carrier.window_mask((7, 110), N)
    sel = np.flatnonzero(mask)
    edge = sel[0] if where == "first" else sel[-1]
    outside = sel[0] - 1 if where == "first" else sel[-1] + 1
    mag = noise_mag()
    mag[:, edge] = 50.0
    mag[:, outside] = 80.0
    det, idx, peak, noise = carrier.detect(jnp.asarray(mag), mask,
                                           (0.0, 15.0, 0.0))
    assert (np.asarray(idx) == edge).all()
    np.testing.assert_allclose(np.asarray(peak), 50.0)
    # noise = sqrt((sum(mag^2) - 2*peak^2) / (N-1)), in float64.
    m64 = mag.astype(np.float64)
    want = np.sqrt((np.sum(m64 ** 2, axis=-1) - 2 * 50.0 ** 2) / (N - 1))
    np.testing.assert_allclose(np.asarray(noise), want, rtol=1e-5)
    assert np.asarray(det).all()


@pytest.mark.parametrize("where", ["first", "last"])
def test_corr_peak_at_window_edge(where):
    """The correlation argmax covers exactly the unique lags
    [start, stop): peaks at start and stop-1 are found, a larger one
    at stop (owned by the next block) is not."""
    start, stop = xcorr.corr_window(N, 600, 200)
    edge = start if where == "first" else stop - 1
    outside = start - 1 if where == "first" else stop
    mag = noise_mag(n=N - 200 + 1)
    mag[:, edge] = 40.0
    mag[:, outside] = 90.0
    idx, peak = xcorr.window_peak(jnp.asarray(mag), (start, stop))
    assert (np.asarray(idx) == edge).all()
    np.testing.assert_allclose(np.asarray(peak), 40.0)


def test_ties_keep_earliest_index():
    mask = carrier.window_mask((7, 110), N)
    mag = np.zeros((2, N), np.float32)
    mag[:, [20, 30, 99]] = 5.0
    _, idx, _, _ = carrier.detect(jnp.asarray(mag), mask, (0.0, 15.0, 0.0))
    assert (np.asarray(idx) == 20).all()
    cmag = np.zeros((2, 1000), np.float32)
    cmag[:, [300, 301, 700]] = 5.0
    idx, _ = xcorr.window_peak(jnp.asarray(cmag), (100, 900))
    assert (np.asarray(idx) == 300).all()


def test_empty_carrier_window_refused():
    mag = jnp.asarray(noise_mag())
    with pytest.raises(ValueError, match="no True"):
        carrier.detect(mag, np.zeros(N, bool), (0.0, 15.0, 0.0))


def test_empty_corr_window_refused():
    mag = jnp.asarray(noise_mag(n=1000))
    with pytest.raises(ValueError, match="empty correlation window"):
        xcorr.window_peak(mag, (500, 500))


def test_stddev_threshold_terms_match_oracle():
    """d != 0 on both stages: the variance threshold terms agree with
    the float64 oracle's np.std (decisions identical, SoA within the
    differential fuzz's bound)."""
    tpl = template_mod.generate(7, 0, 2.0)
    cap = sim.synth_capture(
        num_blocks=8, bursts_every=2, template=tpl, block_len=N,
        history_len=256, carrier_bin=40.25, amplitude=0.8,
        noise_std=0.05, seed=3, quantize=False)
    thresh = (0.0, 15.0, 0.5)
    det = BatchDetector(tpl, DetectorConfig(
        block_len=N, history_len=256, carrier_window=(7, 110),
        carrier_thresh=thresh, corr_thresh=thresh))
    out = {k: np.asarray(v) for k, v in det(cap.blocks).items()}
    oracle = OracleDetector(tpl, block_len=N, history_len=256,
                            carrier_window=(7, 110),
                            carrier_thresh=thresh, corr_thresh=thresh)
    detected = 0
    for i, block in enumerate(cap.blocks):
        ref = oracle.detect_block(block.astype(np.complex128))
        assert bool(out["carrier_detect"][i]) == ref.carrier_detect, i
        if not ref.carrier_detect:
            continue
        assert bool(out["detected"][i]) == ref.detected, i
        if ref.detected:
            detected += 1
            assert int(out["corr_sample"][i]) == ref.corr_sample
            # The differential fuzz's SoA bound (tests/test_fuzz.py).
            assert float(out["corr_offset"][i]) == pytest.approx(
                ref.corr_offset, abs=1e-2)
    assert detected >= 3


def test_stddev_threshold_never_nan():
    """A flat magnitude surface (a time-domain impulse has a constant
    |FFT|) has zero variance: the pure stddev threshold is 0, not NaN,
    and the constant peak is detected."""
    tpl = template_mod.generate(5, 0, 2.0)
    blocks = np.zeros((4, N), np.complex64)
    blocks[:, 100] = 3.0
    det = BatchDetector(tpl, DetectorConfig(
        block_len=N, history_len=256, carrier_window=(7, 110),
        carrier_thresh=(0.0, 0.0, 2.0), corr_thresh=(0.0, 0.0, 2.0)))
    out = {k: np.asarray(v) for k, v in det(blocks).items()}
    assert out["carrier_detect"].all()
    assert np.isfinite(out["carrier_noise"]).all()


@pytest.mark.parametrize("corr_interp",
                         ["gaussian", "parabolic", "autocorr", "maximise"])
def test_bank_interpolators(corr_interp):
    """Template bank: bursts of code 1 pick template 1 at the planted
    lag; the Gaussian interpolator matches the float64 oracle run with
    that code, and every interpolator lands near the planted SoA: 0.05
    samples (the verify bound), except that a 3-point parabola fitted
    to the triangular correlation peak of a 2-samples-per-chip code is
    biased by up to ~0.1 samples at fractional delays."""
    truth_tol = 0.15 if corr_interp == "parabolic" else 0.05
    bank = np.stack([template_mod.generate(7, c, 2.0) for c in range(2)])
    cap = sim.synth_capture(
        num_blocks=8, bursts_every=2, template=bank[1], block_len=N,
        history_len=256, carrier_bin=40.25, amplitude=0.8,
        noise_std=0.05, seed=5, quantize=False, frac_jitter=True)
    det = BatchDetector(bank, DetectorConfig(
        block_len=N, history_len=256, carrier_window=(7, 110),
        corr_interp=corr_interp))
    out = {k: np.asarray(v) for k, v in det(cap.blocks).items()}
    oracle = OracleDetector(bank[1], block_len=N, history_len=256,
                            carrier_window=(7, 110))
    assert cap.bursts
    for b in cap.bursts:
        i = b.block_idx
        assert out["detected"][i] and out["template_idx"][i] == 1
        soa = det.soa(i, out["corr_sample"][i], out["corr_offset"][i])
        assert abs(float(soa) - b.expected_soa) < truth_tol, (corr_interp, i)
        if corr_interp == "gaussian":
            ref = oracle.detect_block(cap.blocks[i].astype(np.complex128))
            assert int(out["corr_sample"][i]) == ref.corr_sample
            assert float(out["corr_offset"][i]) == pytest.approx(
                ref.corr_offset, abs=2e-2)
