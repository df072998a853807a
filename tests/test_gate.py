"""Carrier-gated correlation compaction (DetectorConfig.gate_capacity).

The gate must be semantically invisible: identical decisions on every
block, identical outputs (to cross-batch-shape refusion ULPs) on every
carrier-positive block, and an exact in-program full-batch fallback
when a batch carries more carrier detections than the capacity.  The
reference's own dataflow runs correlation only on carrier-positive
blocks (thrifty/detect.py:64-71; fastcard's whole purpose is thinning
the stream to carrier blocks), so gated outputs on carrier-negative
rows are zeros / not-detected by design.
"""

import dataclasses

import numpy as np
import pytest

from thrifty_tpu import sim
from thrifty_tpu.dsp import iq
from thrifty_tpu.dsp.detector import BatchDetector, DetectorConfig

BASE = DetectorConfig(carrier_window=(7, 110))


@pytest.fixture(scope="module")
def capture():
    tpl = sim.make_template()
    return sim.synth_capture(num_blocks=24, bursts_every=3,
                             template=tpl, seed=7)


@pytest.fixture(scope="module")
def full_out(capture):
    det = BatchDetector(capture.template, BASE)
    return {k: np.asarray(v) for k, v in det(capture.blocks).items()}


CORR_FIELDS = ("corr_sample", "corr_offset", "corr_energy",
               "corr_noise")


def assert_gate_equivalent(a, b, exact=False):
    """``a`` ungated reference output, ``b`` gated output.

    Decisions equal everywhere; all fields equal on carrier-positive
    rows (gathered rows re-run the identical row-wise program; float
    fields may differ by XLA refusion ULPs between batch shapes --
    ``exact`` asserts bitwise equality instead, the overflow-fallback
    contract where both sides run the same full-batch code); carrier
    fields bitwise everywhere (the carrier stage precedes the gate);
    and the UNIFORM carrier-negative contract: corr fields of ``b``
    are zeros on every carrier-negative row, from either branch.
    """
    np.testing.assert_array_equal(a["detected"], b["detected"])
    np.testing.assert_array_equal(a["carrier_detect"],
                                  b["carrier_detect"])
    mask = a["carrier_detect"]
    for k in a:
        x, y = a[k][mask], b[k][mask]
        if exact or x.dtype.kind in "ib":
            np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    neg = ~mask
    for k in ("carrier_bin", "carrier_offset", "carrier_energy",
              "carrier_noise"):
        np.testing.assert_array_equal(a[k][neg], b[k][neg], err_msg=k)
    for k in CORR_FIELDS:
        assert (b[k][neg] == 0).all(), k


@pytest.mark.parametrize("cap", [8, 12, 23])
def test_gated_equals_full(capture, full_out, cap):
    n_carrier = int(full_out["carrier_detect"].sum())
    det = BatchDetector(capture.template,
                        dataclasses.replace(BASE, gate_capacity=cap))
    out = {k: np.asarray(v) for k, v in det(capture.blocks).items()}
    if cap >= n_carrier:
        assert_gate_equivalent(full_out, out)
    else:
        # Overflow: the lax.cond fallback runs the identical
        # full-batch program -- bitwise equality on every field.
        assert_gate_equivalent(full_out, out, exact=True)


def test_boundary_capacities(capture, full_out):
    """Exactly-at-capacity stays gated; one below falls back."""
    n_carrier = int(full_out["carrier_detect"].sum())
    assert 0 < n_carrier < 24
    at = BatchDetector(capture.template, dataclasses.replace(
        BASE, gate_capacity=n_carrier))
    out = {k: np.asarray(v) for k, v in at(capture.blocks).items()}
    assert_gate_equivalent(full_out, out)
    # Gated (not fallback): EVERY carrier-negative row -- including
    # capacity-filler rows that were gathered -- must carry the zero
    # defaults (uniform contract, independent of batch composition);
    # the full program never produces zeros there on this capture.
    neg = ~full_out["carrier_detect"]
    assert (out["corr_energy"][neg] == 0.0).all()
    assert not out["detected"][neg].any()
    assert (full_out["corr_energy"][neg] > 0.0).all()

    below = BatchDetector(capture.template, dataclasses.replace(
        BASE, gate_capacity=n_carrier - 1))
    out = {k: np.asarray(v) for k, v in below(capture.blocks).items()}
    assert_gate_equivalent(full_out, out, exact=True)


@pytest.mark.parametrize("mode", ["integer", "preshift"])
def test_sync_modes(capture, mode):
    cfg = dataclasses.replace(BASE, sync_mode=mode)
    full = BatchDetector(capture.template, cfg)
    gated = BatchDetector(capture.template,
                          dataclasses.replace(cfg, gate_capacity=12))
    a = {k: np.asarray(v) for k, v in full(capture.blocks).items()}
    b = {k: np.asarray(v) for k, v in gated(capture.blocks).items()}
    assert_gate_equivalent(a, b)


def test_bank_mode(capture):
    bank = np.stack([capture.template,
                     np.ascontiguousarray(capture.template[::-1])])
    full = BatchDetector(bank, BASE)
    gated = BatchDetector(bank,
                          dataclasses.replace(BASE, gate_capacity=12))
    a = {k: np.asarray(v) for k, v in full(capture.blocks).items()}
    b = {k: np.asarray(v) for k, v in gated(capture.blocks).items()}
    assert_gate_equivalent(a, b)


def test_maximise_interp(capture):
    cfg = dataclasses.replace(BASE, corr_interp="maximise")
    full = BatchDetector(capture.template, cfg)
    gated = BatchDetector(capture.template,
                          dataclasses.replace(cfg, gate_capacity=12))
    a = {k: np.asarray(v) for k, v in full(capture.blocks).items()}
    b = {k: np.asarray(v) for k, v in gated(capture.blocks).items()}
    assert_gate_equivalent(a, b)


def test_stream_path(capture):
    """detect_raw_stream (device-side overlap-save) under the gate."""
    cfg = BASE
    raw = iq.iq_to_raw(capture.blocks)
    new = raw.reshape(24, -1)[:, 2 * cfg.history_len:].reshape(-1)
    full = BatchDetector(capture.template, cfg)
    gated = BatchDetector(capture.template,
                          dataclasses.replace(cfg, gate_capacity=12))
    a = {k: np.asarray(v) for k, v in full.detect_raw_stream(new).items()}
    b = {k: np.asarray(v)
         for k, v in gated.detect_raw_stream(new).items()}
    assert_gate_equivalent(a, b)


def test_pure_noise_batch(capture):
    """No carriers at all: every gathered row is filler, decisions all
    False, and nothing NaNs."""
    rng = np.random.default_rng(11)
    noise = (rng.standard_normal((16, BASE.block_len))
             + 1j * rng.standard_normal((16, BASE.block_len))
             ).astype(np.complex64) * 0.05
    det = BatchDetector(capture.template,
                        dataclasses.replace(BASE, gate_capacity=4))
    out = {k: np.asarray(v) for k, v in det(noise).items()}
    assert not out["detected"].any()
    for k, v in out.items():
        if v.dtype.kind == "f":
            assert np.isfinite(v).all(), k


def test_all_bursts_batch_falls_back(capture):
    """Every block carries a burst: capacity overflows, the fallback
    must still detect everything the full program does."""
    tpl = capture.template
    dense = sim.synth_capture(num_blocks=16, bursts_every=1,
                              template=tpl, seed=5)
    full = BatchDetector(tpl, BASE)
    gated = BatchDetector(tpl,
                          dataclasses.replace(BASE, gate_capacity=4))
    a = {k: np.asarray(v) for k, v in full(dense.blocks).items()}
    b = {k: np.asarray(v) for k, v in gated(dense.blocks).items()}
    # Block 0's burst straddles the zero-padded pre-stream history;
    # every later block must detect, far exceeding the capacity.
    assert a["detected"][1:].all()
    assert int(a["carrier_detect"].sum()) > 4
    assert_gate_equivalent(a, b, exact=True)


def test_validation():
    tpl = sim.make_template()
    with pytest.raises(ValueError, match="gate_capacity"):
        BatchDetector(tpl, dataclasses.replace(BASE, gate_capacity=-1))
    # cap >= batch is simply ungated, not an error.
    det = BatchDetector(tpl, dataclasses.replace(BASE, gate_capacity=64))
    cap = sim.synth_capture(num_blocks=8, bursts_every=4,
                            template=tpl, seed=2)
    out = det(cap.blocks)
    assert int(np.asarray(out["detected"]).sum()) >= 1


def test_gspmd_gate(capture):
    """The gate under the GSPMD formulation: the argsort/cond run on
    the GLOBAL batch (XLA partitions the compaction gather across
    shards), unlike shard_map's per-shard gate -- both must reproduce
    the unsharded decisions."""
    import jax
    from jax.sharding import Mesh
    from thrifty_tpu.parallel import sharded

    devs = np.array(jax.devices()[:4]).reshape(1, 4)
    mesh = Mesh(devs, (sharded.AXIS_RX, sharded.AXIS_TIME))
    cfg = dataclasses.replace(BASE, gate_capacity=16)
    det_g = BatchDetector(capture.template, cfg)
    det_f = BatchDetector(capture.template, BASE)
    stream = np.concatenate([
        b[BASE.history_len:] for b in capture.blocks])[None, :]
    f_g = sharded.make_stream_detector_gspmd(det_g, 24, mesh)
    f_f = sharded.make_stream_detector_gspmd(det_f, 24, mesh)
    with mesh:
        a = {k: np.asarray(v) for k, v in f_f(stream).items()}
        b = {k: np.asarray(v) for k, v in f_g(stream).items()}
    np.testing.assert_array_equal(a["detected"], b["detected"])
    m = a["carrier_detect"]
    np.testing.assert_array_equal(a["corr_sample"][m],
                                  b["corr_sample"][m])
    np.testing.assert_allclose(a["corr_offset"][m], b["corr_offset"][m],
                               rtol=1e-5, atol=1e-6)


def test_sharded_gate(capture):
    """The gate composes with the sharded streaming detector (the gate
    then applies per shard-local batch)."""
    import jax
    from jax.sharding import Mesh
    from thrifty_tpu.parallel import sharded

    devs = np.array(jax.devices()[:4]).reshape(1, 4)
    mesh = Mesh(devs, (sharded.AXIS_RX, sharded.AXIS_TIME))
    cfg = dataclasses.replace(BASE, gate_capacity=4)
    det_g = BatchDetector(capture.template, cfg)
    det_f = BatchDetector(capture.template, BASE)
    new_len = BASE.block_len - BASE.history_len
    stream = np.concatenate([
        b[BASE.history_len:] for b in capture.blocks])[None, :]
    f_g = sharded.make_stream_detector(det_g, 1, 6, mesh, gather=True)
    f_f = sharded.make_stream_detector(det_f, 1, 6, mesh, gather=True)
    a = {k: np.asarray(v) for k, v in f_f(stream).items()}
    b = {k: np.asarray(v) for k, v in f_g(stream).items()}
    np.testing.assert_array_equal(a["detected"], b["detected"])
    m = a["carrier_detect"]
    for k in ("corr_sample", "template_idx", "carrier_bin"):
        np.testing.assert_array_equal(a[k][m], b[k][m], err_msg=k)
    for k in ("corr_offset", "corr_energy", "carrier_offset"):
        np.testing.assert_allclose(a[k][m], b[k][m], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_bench_mix_carrier_count_fits_auto_gate():
    """The official bench mix (bursts_every=4, seeds 0/1, quantize
    off) must keep its carrier-positive count <= batch//2 -- the
    bench's auto gate capacity.  If sim or the seeds ever change this,
    the headline would silently measure the lax.cond fallback instead
    of the gated program (still correct, but a perf artifact); this
    test turns that into a visible failure."""
    import dataclasses

    tpl = sim.make_template()
    det = BatchDetector(tpl, BASE)
    for seed in (0, 1):
        cap = sim.synth_capture(num_blocks=64, bursts_every=4,
                                template=tpl, seed=seed, quantize=False)
        n_carrier = int(np.asarray(
            det(cap.blocks)["carrier_detect"]).sum())
        assert n_carrier <= 32, (seed, n_carrier)
        # ...and the mix is genuinely dense enough to exercise the
        # corr stage (not a degenerate all-noise batch).
        assert n_carrier >= 16, (seed, n_carrier)
