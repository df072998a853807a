"""chip_smoke.py: refusal without a GPU, and its comparison helpers at a
small geometry on the CPU (the phases themselves run on the card)."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from thrifty_tpu import sim  # noqa: E402
from thrifty_tpu.dsp import template as template_mod  # noqa: E402
from thrifty_tpu.io import toad  # noqa: E402
from thrifty_tpu.oracle.numpy_ref import OracleResult  # noqa: E402


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_cpu():
    """No GPU: exit non-zero, last line reports ok false, and no
    phase after the device check runs."""
    res = _run(REPO, "chip_smoke.py")
    assert res.returncode != 0
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert last["ok"] is False and last["phase"] == "device"
    assert "== phase golden" not in res.stdout


def test_fails_without_the_repo(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo
    must fail, and print no ok result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = _run(str(tmp_path), "chip_smoke.py")
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_schedule_keeps_bursts_in_separate_blocks():
    sched = cs.deployment_schedule(12.4)
    txids = [t for t, _ in sched]
    assert set(txids) == {9} | set(cs.MOBILE_POS)
    times = np.array([t for _, t in sched])
    block_s = (cs.BLOCK - cs.HISTORY) / cs.FS
    # Two blocks of margin each side of a burst (it straddles <= 2).
    assert np.diff(times).min() > 4 * block_s
    assert times.min() > 0 and times.max() < 12.4


def test_channel_bins_of_deploy_freqmap():
    bins = cs.channel_bins(os.path.join(REPO, "deploy", "freq-map.cfg"))
    assert set(bins) == {0, 1, 2, 9}
    lo, hi = 7, 110  # the carrier window every channel must sit in
    assert all(lo < b < hi for b in bins.values())


def test_toad_rows_differ(tmp_path):
    a, b = tmp_path / "a.toad", tmp_path / "b.toad"
    a.write_text("1 2 3\n4 5 6\n")
    b.write_text("1 2 3\n4 5 6\n")
    assert cs.toad_rows_differ(str(a), str(b)) == []
    b.write_text("1 2 3\n4 5 7\n8\n")
    assert cs.toad_rows_differ(str(a), str(b)) == [1, 2]


def _burst(soa, block_idx=1):
    return sim.Burst(position=soa, carrier_bin=40.0, amplitude=1.0,
                     phase=0.0, expected_soa=soa, block_idx=block_idx)


def test_check_bursts():
    recs = toad.empty(3)
    recs["soa"] = [1000.01, 5000.2, 9000.0]
    worst, missed = cs.check_bursts(
        recs, [_burst(1000.0), _burst(9000.03), _burst(20.0, -1)])
    assert missed == [] and worst == pytest.approx(0.03)
    worst, missed = cs.check_bursts(recs, [_burst(5000.0), _burst(7000.0)])
    assert [m[0] for m in missed] == [5000.0, 7000.0]


def _fixes(rows):
    dtype = np.dtype([("tx", "i4"), ("timestamp", "f8"), ("x", "f8"),
                      ("y", "f8")])
    return np.array(rows, dtype=dtype)


def test_position_errors_and_pairing():
    truth = {0: (0.0, 0.0), 1: (100.0, 0.0)}
    pos = _fixes([(0, 10.0, 3.0, 4.0), (1, 11.0, 100.0, 1.0)])
    np.testing.assert_allclose(cs.position_errors(pos, truth), [5.0, 1.0])
    live = _fixes([(1, 11.0002, 100.0, 1.5), (0, 10.0, 3.0, 4.0),
                   (1, 12.0, 0.0, 0.0)])
    pairs, only_a, only_b = cs.pair_fixes(pos, live)
    assert sorted(pairs) == [(0, 1), (1, 0)]
    assert only_a == [] and only_b == [2]


def test_compare_with_oracle():
    ref = OracleResult(carrier_detect=True, carrier_bin=40,
                       carrier_offset=0.1, carrier_energy=100.0,
                       carrier_noise=2.0, detected=True, corr_sample=700,
                       corr_offset=0.2, corr_energy=50.0, corr_noise=1.0)
    out = {"carrier_detect": [True], "carrier_bin": [40],
           "carrier_offset": [0.101], "carrier_energy": [100.05],
           "carrier_noise": [2.001], "detected": [True],
           "corr_sample": [700], "corr_offset": [0.2005],
           "corr_energy": [50.01], "corr_noise": [1.0]}
    bad, worst = cs.compare_with_oracle(out, [ref])
    assert bad == [] and worst == pytest.approx(5e-4)
    off = dict(out, corr_offset=[0.25], corr_sample=[700])
    assert cs.compare_with_oracle(off, [ref])[0]
    flipped = dict(out, detected=[False])
    assert "detected" in cs.compare_with_oracle(flipped, [ref])[0][0]
    nocarrier = dataclasses.replace(ref, carrier_detect=False)
    assert cs.compare_with_oracle(dict(out, carrier_detect=[False]),
                                  [nocarrier]) == ([], 0.0)


def test_deployment_phase_small_geometry(monkeypatch):
    """The whole deployment phase -- synthesis, detect --raw on both
    unfold paths, identify, match, tdoa, pos --batched, serve --once
    and the oracle check -- at 2048-sample blocks and a 7-bit code.
    XLA:CPU reruns of one program are not bit-reproducible, so the
    unfold-identity check (bit-identical rows on the card) is left to
    the GPU run."""
    monkeypatch.setattr(cs, "toad_rows_differ", lambda a, b: [])
    tpl = template_mod.generate(7, 0, 2.4e6 / 0.999707e6)
    cs.phase_deployment(seconds=3.0, template=tpl, block_len=2048,
                        history_len=768, batch=32, oracle_blocks=8)
