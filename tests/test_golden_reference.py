"""Cross-validation against the ACTUAL reference implementation.

``tests/golden/`` holds the outputs of running the real
swkrueger/Thrifty pipeline (/root/reference, via the mechanical py2->py3
shim in ``scripts/make_reference_goldens.sh``) on the committed capture
``tests/golden/input/*.card`` (the example pipeline's synthetic
three-receiver network: ``example/simulate.py`` seed 20 ->
``capture --raw-in --t0 1.5e9``; committed verbatim so the
golden/input pairing cannot drift if the simulator changes):

    thrifty detect rxN.card --rxid N   -> rxN.toad
    thrifty identify -m freq-map.cfg   -> rx.toads
    thrifty match -w 0.02              -> rx.match
    thrifty tdoa -r pos-rx -b pos-beacon -> data.tdoa
    thrifty pos -r pos-rx              -> data.pos

Here the SAME chain is re-run with thrifty-tpu and compared
field-by-field.  This is the acceptance bar of SURVEY.md section 7.3
("validated against reference Python detect on the same input",
/root/reference/thrifty/detect.py:161-223, soa_estimator.py:146-170,
tdoa_est.py:234-303, pos_est.py:128-157).

Tolerances: the reference computes in float64 numpy on the host; the
batched detector computes the FFT/correlation path in float32 on
device (float64 only for the final SoA arithmetic).  Measured
disagreement on this capture is ~1e-5 samples of SoA and <1e-6
relative on amplitudes; bounds below carry ~10-50x headroom over that
while remaining far below any physically meaningful scale (1e-3
samples = 0.125 m of range at 2.4 MS/s).  Detect/no-detect decisions,
block indices, correlation peak indices and carrier bins must be
IDENTICAL.  There are no other deliberate numerical divergences on
this chain (docs/golden_validation.md).
"""

import os

import numpy as np
import pytest

from thrifty_tpu.cli import main

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
INPUT = os.path.join(GOLDEN, "input")

# .toad columns (toads_data.py:99-124 ordering, without txid):
# 0 rxid, 1 timestamp, 2 block, 3 soa, 4 peak_idx, 5 corr_offset,
# 6 corr_ampl, 7 corr_noise, 8 carrier_bin, 9 carrier_offset,
# 10 carrier_ampl, 11 carrier_noise
TOAD_INT_COLS = (0, 2, 4, 8)
TOAD_TOLS = {1: dict(atol=1e-9), 3: dict(atol=1e-3), 5: dict(atol=1e-3),
             6: dict(rtol=1e-3, atol=1e-3), 7: dict(rtol=1e-2, atol=1e-3),
             9: dict(atol=2e-3), 10: dict(rtol=1e-3, atol=1e-3),
             11: dict(rtol=1e-2, atol=1e-3)}


@pytest.fixture(scope="module")
def rerun(tmp_path_factory):
    """Run the full thrifty-tpu chain on the example cards."""
    d = tmp_path_factory.mktemp("golden_rerun")
    common = ["--carrier-window", "7-110",
              "--template", os.path.join(INPUT, "template.npy")]
    for rxid in (0, 1, 2):
        assert main(["detect", os.path.join(INPUT, "rx%d.card" % rxid),
                     "-o", str(d / ("rx%d.toad" % rxid)), "--quiet",
                     "--rxid", str(rxid)] + common) == 0
    assert main(["identify"] +
                [str(d / ("rx%d.toad" % i)) for i in (0, 1, 2)] +
                ["-o", str(d / "rx.toads"),
                 "-m", os.path.join(INPUT, "freq-map.cfg")]) == 0
    assert main(["match", str(d / "rx.toads"), "-o", str(d / "rx.match"),
                 "-w", "0.02"]) == 0
    assert main(["tdoa", str(d / "rx.toads"), str(d / "rx.match"),
                 "-o", str(d / "data.tdoa"),
                 "-r", os.path.join(INPUT, "pos-rx.cfg"),
                 "-b", os.path.join(INPUT, "pos-beacon.cfg")]) == 0
    assert main(["pos", str(d / "data.tdoa"), "-o", str(d / "data.pos"),
                 "-r", os.path.join(INPUT, "pos-rx.cfg")]) == 0
    return d


def _load(path):
    return np.atleast_2d(np.loadtxt(path))


@pytest.mark.parametrize("rxid", [0, 1, 2])
def test_detect_matches_reference(rerun, rxid):
    ref = _load(os.path.join(GOLDEN, "rx%d.toad" % rxid))
    got = _load(str(rerun / ("rx%d.toad" % rxid)))
    assert got.shape == ref.shape, "different detection count"
    for col in TOAD_INT_COLS:
        np.testing.assert_array_equal(got[:, col], ref[:, col],
                                      err_msg="toad col %d" % col)
    for col, tol in TOAD_TOLS.items():
        np.testing.assert_allclose(got[:, col], ref[:, col],
                                   err_msg="toad col %d" % col, **tol)


def test_identify_matches_reference(rerun):
    ref = _load(os.path.join(GOLDEN, "rx.toads"))
    got = _load(str(rerun / "rx.toads"))
    assert got.shape == ref.shape, "identify kept a different set"
    # .toads = .toad with txid spliced in as column 1.
    np.testing.assert_array_equal(got[:, 1], ref[:, 1], err_msg="txid")
    for col in TOAD_INT_COLS:
        c = col if col == 0 else col + 1
        np.testing.assert_array_equal(got[:, c], ref[:, c],
                                      err_msg="toads col %d" % c)
    for col, tol in TOAD_TOLS.items():
        np.testing.assert_allclose(got[:, col + 1], ref[:, col + 1],
                                   err_msg="toads col %d" % (col + 1), **tol)


def test_match_matches_reference(rerun):
    ref = [l.split() for l in open(os.path.join(GOLDEN, "rx.match"))
           if l.strip() and not l.startswith("#")]
    got = [l.split() for l in open(str(rerun / "rx.match"))
           if l.strip() and not l.startswith("#")]
    assert [sorted(map(int, m)) for m in got] == \
        [sorted(map(int, m)) for m in ref]


def test_tdoa_matches_reference(rerun):
    # cols: 0 group, 1 timestamp, 2 txid, 3 rx0, 4 rx1, 5 tdoa_dist[m],
    # 6/7 model-corrected distances, 8/9 detection indices
    ref = _load(os.path.join(GOLDEN, "data.tdoa"))
    got = _load(str(rerun / "data.tdoa"))
    assert got.shape == ref.shape, "different TDOA group structure"
    for col in (0, 2, 3, 4, 8, 9):
        np.testing.assert_array_equal(got[:, col], ref[:, col],
                                      err_msg="tdoa col %d" % col)
    np.testing.assert_allclose(got[:, 1], ref[:, 1], atol=1e-9)
    np.testing.assert_allclose(got[:, 5], ref[:, 5], atol=0.01,
                               err_msg="TDOA distance [m]")
    np.testing.assert_allclose(got[:, 6:8], ref[:, 6:8], atol=0.05)


def test_pos_matches_reference(rerun):
    # cols: 0 group, 1 timestamp, 2 txid, 3 dop, 4 snr, 5 x, 6 y
    ref = _load(os.path.join(GOLDEN, "data.pos"))
    got = _load(str(rerun / "data.pos"))
    assert got.shape == ref.shape, "different fix count"
    np.testing.assert_array_equal(got[:, (0, 2)], ref[:, (0, 2)])
    np.testing.assert_allclose(got[:, 1], ref[:, 1], atol=1e-9)
    np.testing.assert_allclose(got[:, 3], ref[:, 3], atol=1e-5,
                               err_msg="DOP")
    np.testing.assert_allclose(got[:, 4], ref[:, 4], rtol=0.05,
                               err_msg="SNR")
    np.testing.assert_allclose(got[:, 5:], ref[:, 5:], atol=0.05,
                               err_msg="position [m]")


# --- scenario 2: collision / miss semantics --------------------------------
# tests/golden/scenario2/: same network, but two same-TX transmissions
# 10 ms apart (match-window COLLISIONS resolved by the higher-energy
# rule, matchmaker.py:60-68) and rx1/rx2 captures that stop before the
# last transmission (an rx0-only MISS).  Reference run reports
# 6 matches / 2 misses / 9 collisions.  Identical rx.match content
# proves the collision-resolution picks the same detection indices.

S2 = os.path.join(GOLDEN, "scenario2")


@pytest.fixture(scope="module")
def rerun2(tmp_path_factory):
    d = tmp_path_factory.mktemp("golden_rerun2")
    common = ["--carrier-window", "7-110",
              "--template", os.path.join(INPUT, "template.npy")]
    for rxid in (0, 1, 2):
        assert main(["detect",
                     os.path.join(S2, "input", "rx%d.card" % rxid),
                     "-o", str(d / ("rx%d.toad" % rxid)), "--quiet",
                     "--rxid", str(rxid)] + common) == 0
    assert main(["identify"] +
                [str(d / ("rx%d.toad" % i)) for i in (0, 1, 2)] +
                ["-o", str(d / "rx.toads"),
                 "-m", os.path.join(INPUT, "freq-map.cfg")]) == 0
    assert main(["match", str(d / "rx.toads"), "-o", str(d / "rx.match"),
                 "-w", "0.05"]) == 0
    return d


@pytest.mark.parametrize("rxid", [0, 1, 2])
def test_s2_detect_matches_reference(rerun2, rxid):
    ref = _load(os.path.join(S2, "rx%d.toad" % rxid))
    got = _load(str(rerun2 / ("rx%d.toad" % rxid)))
    assert got.shape == ref.shape, "different detection count"
    for col in TOAD_INT_COLS:
        np.testing.assert_array_equal(got[:, col], ref[:, col])
    for col, tol in TOAD_TOLS.items():
        np.testing.assert_allclose(got[:, col], ref[:, col],
                                   err_msg="toad col %d" % col, **tol)


def test_s2_identify_matches_reference(rerun2):
    ref = _load(os.path.join(S2, "rx.toads"))
    got = _load(str(rerun2 / "rx.toads"))
    assert got.shape == ref.shape, "identify kept a different set"
    np.testing.assert_array_equal(got[:, 1], ref[:, 1], err_msg="txid")


def test_s2_match_collision_resolution_matches_reference(rerun2):
    # Exact data-line equality (docs/golden_validation.md): every
    # collision resolves to the same detection index AND group members
    # appear in the reference's order (rx first-appearance).
    ref = [l.strip() for l in open(os.path.join(S2, "rx.match"))
           if l.strip() and not l.startswith("#")]
    got = [l.strip() for l in open(str(rerun2 / "rx.match"))
           if l.strip() and not l.startswith("#")]
    assert got == ref


def test_s2_miss_and_collision_counts(rerun2):
    """The scenario really exercises the rules: the matchmaker sees
    collisions (duplicate-rx groups) and misses (rx0-only tail)."""
    from thrifty_tpu.io import toad as toad_mod
    from thrifty_tpu.pipeline import matchmaker

    det = toad_mod.load_toads(str(rerun2 / "rx.toads"))
    matches, misses, collisions = matchmaker.match_detections(
        det, window=0.05)
    assert len(matches) == 6
    assert len(misses) == 2
    assert len(collisions) == 9
