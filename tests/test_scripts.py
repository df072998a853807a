"""scripts/ utilities and the .tpl template format."""

import os
import subprocess
import sys

import numpy as np
import pytest

from thrifty_tpu.dsp import iq, template as template_mod
from thrifty_tpu.io import tpl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")


def run_script(name, args, cwd):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, os.path.join(SCRIPTS, name)] + args,
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


class TestTpl:
    def test_round_trip(self, tmp_path):
        template = template_mod.generate(11, 0, 2.4e6 / 0.999707e6)
        path = str(tmp_path / "t.tpl")
        tpl.save_tpl(path, template)
        back = tpl.load_tpl(path)
        np.testing.assert_allclose(back, template, atol=1e-6)
        # int16 length header + float32 samples
        assert os.path.getsize(path) == 2 + 4 * len(template)

    def test_npy_to_tpl_script(self, tmp_path):
        template = template_mod.generate(5, 0, 2.0)
        np.save(str(tmp_path / "t.npy"), template)
        res = run_script("npy_to_tpl.py", ["t.npy"], str(tmp_path))
        assert res.returncode == 0, res.stderr
        back = tpl.load_tpl(str(tmp_path / "t.tpl"))
        np.testing.assert_allclose(back, template, atol=1e-6)
        # reverse conversion
        res = run_script("npy_to_tpl.py",
                         ["--reverse", "t.tpl", "t2.npy"], str(tmp_path))
        assert res.returncode == 0, res.stderr
        np.testing.assert_allclose(
            np.load(str(tmp_path / "t2.npy")), template, atol=1e-6)


@pytest.fixture(scope="module")
def raw_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("raw")
    rng = np.random.default_rng(0)
    stream = (0.05 * (rng.normal(size=60000) + 1j * rng.normal(size=60000))
              + 0.3 * np.exp(2j * np.pi * 40 * np.arange(60000) / 16384))
    raw = iq.iq_to_raw(stream)
    path = d / "data.bin"
    path.write_bytes(raw.tobytes())
    return d


def test_noise_rms(raw_file):
    res = run_script("noise_rms.py",
                     ["data.bin", "-b", "8192", "-y", "2048", "-i", "2"],
                     str(raw_file))
    assert res.returncode == 0, res.stderr
    values = [float(x) for x in res.stdout.split()]
    assert len(values) >= 2
    assert all(v > 0 for v in values)


def test_fft_analysis(raw_file):
    res = run_script("fft_analysis.py",
                     ["data.bin", "-b", "16384", "-y", "4920", "--top", "1"],
                     str(raw_file))
    assert res.returncode == 0, res.stderr
    # The strongest bin must be the injected tone at bin 40.
    assert "bin     40" in res.stdout


def test_hist(raw_file):
    res = run_script("hist.py", ["data.bin", "-b", "8192", "-y", "2048"],
                     str(raw_file))
    assert res.returncode == 0, res.stderr
    mean = float(res.stdout.split("mean: ")[1].split()[0])
    assert 126.0 < mean < 128.5  # centred on the 127.4 DC offset


@pytest.fixture(scope="module")
def network_files(tmp_path_factory):
    from thrifty_tpu import sim
    from thrifty_tpu.io import toad
    from thrifty_tpu.pipeline import matchmaker

    d = tmp_path_factory.mktemp("net")
    rx_pos = {0: np.array([0.0, 0.0]), 1: np.array([10000.0, 0.0]),
              2: np.array([5000.0, 7000.0])}
    tx_pos = {9: np.array([5000.0, 2000.0]), 3: np.array([7000.0, 1000.0])}
    schedule = [(9, t) for t in np.arange(0.5, 20, 1.0)]
    schedule += [(3, t) for t in np.arange(4.0, 16.0, 2.0)]
    det = sim.synth_network(rx_pos, tx_pos, schedule, 2.4e6,
                            clock_offsets={1: 123.0, 2: -77.0},
                            clock_drifts={1: 2e-6, 2: -1e-6},
                            soa_noise=0.02)
    matches, _, _ = matchmaker.match_detections(det)
    toad.save(str(d / "data.toads"), det, with_rxid=True, with_txid=True)
    matchmaker.save_matches(str(d / "data.match"), matches)
    (d / "pos-rx.cfg").write_text("".join(
        "{}: {} {}\n".format(r, p[0], p[1]) for r, p in rx_pos.items()))
    (d / "pos-beacon.cfg").write_text("9: 5000.0 2000.0\n")
    return d


def test_tdoa_matrix(network_files):
    res = run_script("tdoa_matrix.py", ["data.toads", "data.match"],
                     str(network_files))
    assert res.returncode == 0, res.stderr
    assert "# TX 3:" in res.stdout
    assert "n=6" in res.stdout


def test_reldist_nearest(network_files):
    res = run_script("reldist_nearest.py",
                     ["data.toads", "data.match", "--tx", "3",
                      "--beacon", "9"], str(network_files))
    assert res.returncode == 0, res.stderr
    assert "std=" in res.stdout


def test_reldist_export_with_lowess(network_files):
    res = run_script("reldist_nearest.py",
                     ["data.toads", "data.match", "--tx", "3",
                      "--beacon", "9", "--export", "reldist.png"],
                     str(network_files))
    assert res.returncode == 0, res.stderr
    assert os.path.getsize(str(network_files / "reldist.png")) > 1000


def test_lowess_recovers_trend():
    """The local-regression smoother tracks a known slow trend."""
    from thrifty_tpu import stats
    rng = np.random.default_rng(0)
    x = np.linspace(0, 10, 400)
    trend = 2.0 * np.sin(x / 3.0)
    y = trend + rng.normal(0, 0.3, len(x))
    smooth = stats.lowess(x, y, frac=0.15)
    assert np.sqrt(np.mean((smooth - trend) ** 2)) < 0.15


def test_scaling_sweep_smoke(tmp_path):
    """Mesh sweep runs functionally on the virtual device mesh and
    reports monotone device counts with sane efficiency numbers."""
    import json

    env_flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in env_flags:
        os.environ["XLA_FLAGS"] = (
            env_flags + " --xla_force_host_platform_device_count=8").strip()
    res = run_script("scaling_sweep.py",
                     ["--platform", "cpu", "--geometry", "tiny",
                      "--iters", "2", "--shapes", "1x1,1x2,2x2",
                      "--json", str(tmp_path / "sweep.json")],
                     str(tmp_path))
    assert res.returncode == 0, res.stderr
    data = json.load(open(tmp_path / "sweep.json"))
    rows = data["results"]
    assert [r["devices"] for r in rows] == [1, 2, 4]
    assert all(r["samples_per_s"] > 0 for r in rows)
    assert rows[0]["efficiency"] == 1.0


@pytest.mark.skipif(
    os.environ.get("THRIFTY_TPU_SKIP_MULTIHOST") == "1",
    reason="multi-host test disabled")
def test_scaling_sweep_multiprocess(tmp_path):
    """--processes 2 rehearses the multi-process command line: two
    coordinator-connected jax.distributed workers sweep the global
    (2, 4) mesh; process 0 writes the report."""
    import json

    res = run_script("scaling_sweep.py",
                     ["--platform", "cpu", "--geometry", "tiny",
                      "--processes", "2", "--devices-per-process", "4",
                      "--shapes", "2x4", "--iters", "2",
                      "--coordinator", "127.0.0.1:37747",
                      "--json", str(tmp_path / "pod.json")],
                     str(tmp_path))
    assert res.returncode == 0, res.stderr[-2000:]
    data = json.load(open(tmp_path / "pod.json"))
    assert data["processes"] == 2
    rows = data["results"]
    assert rows and rows[0]["mesh"] == "2x4"
    assert rows[0]["devices"] == 8
    assert rows[0]["samples_per_s"] > 0


def test_validation_sweep_smoke(tmp_path):
    """The differential validation sweep runs all four suites clean at
    a few trials (the offline tool for large campaigns; see
    docs/golden_validation.md for recorded results)."""
    import json

    res = run_script("validation_sweep.py",
                     ["--platform", "cpu", "--trials", "3"],
                     str(tmp_path))
    assert res.returncode == 0, res.stderr[-2000:]
    lines = [json.loads(x) for x in res.stdout.splitlines()
             if x.startswith("{")]
    # 'all' = the self-contained suites; the fastdet differential
    # campaign (builds the reference C tree) is opt-in, tested below.
    assert sorted(r["suite"] for r in lines) == \
        ["detector", "matchmaker", "pos", "tdoa"]
    assert all(r["ok"] for r in lines), lines


def test_validation_sweep_fastdet_smoke(tmp_path):
    """The near-threshold differential campaign against the COMPILED
    fastdet binaries: builds the reference with the shim backend and
    compares decisions + SoAs through the detection knee.  Skips when
    no reference tree / toolchain is available."""
    import json

    if not os.path.isdir("/root/reference"):
        import pytest
        pytest.skip("reference tree not available")
    res = run_script("validation_sweep.py",
                     ["--platform", "cpu", "--trials", "4",
                      "--suite", "fastdet"], str(tmp_path))
    assert res.returncode == 0, res.stderr[-2000:]
    line = [x for x in res.stdout.splitlines() if x.startswith("{")][-1]
    data = json.loads(line)
    assert data["suite"] == "fastdet" and data["ok"], data
    assert data["blocks"] == 4 * 24
    assert data["flips_out_of_band"] == 0
    assert data["worst_soa_diff"] < 1e-4


def test_golden_check_script(tmp_path):
    """The golden-check script also passes on the CPU backend (the dev
    harness for what chip_smoke.py runs on the card)."""
    import json

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS, "golden_check.py")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    assert summary["metric"] == "golden_check"
    assert summary["value"] == 1.0
    assert summary["backend"] == "cpu"


def test_golden_check_gated(tmp_path):
    """--detect-arg passthrough: the carrier-gated detect path must
    reproduce the reference goldens through the full chain too (a
    golden capture dense in carriers exercises the cond fallback; a
    sparse one exercises the compacted branch -- both must match)."""
    import json

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS, "golden_check.py"),
         "--detect-arg=--gate-capacity", "--detect-arg=8"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    assert summary["value"] == 1.0


def test_golden_check_tolerances_match_tests():
    """The golden-check script's duplicated column maps / tolerances must
    not drift from the golden tests' (they can't share a module since
    neither tests/ nor scripts/ is an importable package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "golden_check", os.path.join(SCRIPTS, "golden_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    import test_golden_fastdet as tgf
    import test_golden_reference as tgr

    assert mod.INT_COLS == tgf.TOAD_INT_COLS == tgr.TOAD_INT_COLS
    assert mod.FLOAT_TOLS == {
        k: v for k, v in tgf.TOAD_TOLS.items() if k != 1}
    assert mod.PY_FLOAT_TOLS == {
        k: v for k, v in tgr.TOAD_TOLS.items() if k != 1}


def test_ab_time_smoke(tmp_path):
    """Interleaved config A/B timer runs on CPU and emits the paired
    JSON contract (on the card it is the same-process protocol for
    any DetectorConfig knob)."""
    import json

    res = run_script("ab_time.py",
                     ["--cpu", "--batch", "8", "--scan-k", "2",
                      "--rounds", "3", "--ab", "fft_impl=xla"],
                     str(tmp_path))
    data = json.loads(
        [l for l in res.stdout.splitlines() if l.startswith("{")][-1])
    assert data["metric"] == "config_ab_time"
    assert data["b"] == {"fft_impl": "xla"} and data["a"] == {}
    if res.returncode != 0:
        # Host-load jitter on a shared machine can produce
        # non-positive scan slopes at scan-k=2; the script must then
        # DISCARD those rounds and declare itself unresolved rather
        # than report poisoned ratios.
        assert data["verdict"] == "unresolved", data
        return
    assert data["verdict"] in ("a_faster", "b_faster", "parity")
    assert 2 <= len(data["rounds"]) <= 3
    # Paired rounds each carry both sides and their ratio.
    assert all({"a", "b", "ratio_b_over_a"} <= set(r)
               for r in data["rounds"])
    assert data["invalid_rounds"] + len(data["rounds"]) == 3


def test_ab_time_rejects_bad_override(tmp_path):
    res = run_script("ab_time.py",
                     ["--cpu", "--ab", "nonsense"], str(tmp_path))
    assert res.returncode != 0


def test_ab_time_sync_mode_override(tmp_path):
    """sync_mode is a valid str field: overriding it via --ab must
    build B with the overridden mode (dataclasses.replace), not crash
    with a duplicate-keyword TypeError against the --sync-mode flag."""
    import json

    res = run_script("ab_time.py",
                     ["--cpu", "--batch", "8", "--scan-k", "2",
                      "--rounds", "2", "--sync-mode", "fractional",
                      "--ab", "sync_mode=integer"], str(tmp_path))
    assert "TypeError" not in res.stderr
    data = json.loads(
        [l for l in res.stdout.splitlines() if l.startswith("{")][-1])
    assert data["b"] == {"sync_mode": "integer"}


def _load_scaling_sweep():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "scaling_sweep", os.path.join(SCRIPTS, "scaling_sweep.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_scaling_sweep_worker_env_cpu():
    """Emulating devices: every worker stays on the CPU backend with
    its own virtual devices, whatever the parent environment says."""
    mod = _load_scaling_sweep()
    base = {"XLA_FLAGS": "--xla_dump_to=/dev/null", "JAX_PLATFORMS": "cuda"}
    envs = [mod.worker_env(base, pid, "cpu", 4) for pid in range(2)]
    for env in envs:
        assert env["JAX_PLATFORMS"] == "cpu"
        assert env["XLA_FLAGS"].endswith(
            "--xla_force_host_platform_device_count=4")
        assert "CUDA_VISIBLE_DEVICES" not in env
    assert base["JAX_PLATFORMS"] == "cuda"  # parent env untouched


def test_scaling_sweep_worker_env_one_card_each():
    """On the GPU every worker sees exactly one card, and no two
    workers see the same card."""
    mod = _load_scaling_sweep()
    envs = [mod.worker_env({}, pid, None, 4) for pid in range(4)]
    cards = [env["CUDA_VISIBLE_DEVICES"] for env in envs]
    assert cards == ["0", "1", "2", "3"]
    assert all("xla_force_host_platform_device_count"
               not in env.get("XLA_FLAGS", "") for env in envs)
