"""bench.py runs end-to-end and prints the driver's JSON contract."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_bench(args):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8"
                        ).strip()
    code = (
        "import jax; jax.config.update('jax_platforms','cpu'); "
        "import runpy, sys; sys.argv = ['bench.py'] + {!r}; "
        "runpy.run_path({!r}, run_name='__main__')".format(
            list(args) + ["--allow-cpu"], os.path.join(REPO, "bench.py"))
    )
    return subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=540)


def check_contract(stdout):
    line = [l for l in stdout.splitlines() if l.startswith("{")][-1]
    data = json.loads(line)
    # Contract: the four core keys plus the device every figure came
    # from, on one JSON line; per-run times and the config ride along.
    assert set(data) >= {"metric", "value", "unit", "vs_baseline"}
    assert data["metric"] == "detect_throughput"
    assert data["unit"] == "IQ_samples/s/chip"
    assert data["value"] > 0
    assert data["vs_baseline"] > 0
    assert data["device"]["platform"] == "cpu"
    assert data["device"]["count"] >= 1
    assert len(data["runs_sec_per_batch"]) >= 1
    # Raw per-repeat slopes may go non-positive when host-load jitter
    # swamps the K->2K difference at tiny scan-k (bench takes the
    # median, or flags slope_unresolved and substitutes a positive
    # figure when the median itself is non-positive; the raw runs stay
    # recorded as evidence).  The contract is that the resolved value
    # is positive (asserted above) and every raw run is a real number.
    import math
    assert all(math.isfinite(r) for r in data["runs_sec_per_batch"])
    assert (any(r > 0 for r in data["runs_sec_per_batch"])
            or data.get("slope_unresolved") is True)
    assert {"batch", "iters", "sync_mode", "fft_impl", "input"} <= set(data)
    return data


def test_bench_default_contract():
    res = run_bench(["--batch", "8", "--iters", "2", "--scan-k", "2",
                     "--oracle-blocks", "2", "--sweep", "none"])
    assert res.returncode == 0, res.stderr[-2000:]
    data = check_contract(res.stdout)
    assert data["headline_batch"] == 8
    # Primary method is the in-program scan-slope chain; the wall-clock
    # dispatch chain is recorded alongside for auditability.
    assert data["method"] == "scan_slope"
    assert data["scan_k"] == 2
    assert data["dispatch_chain_sec_per_batch"] > 0
    assert data["scan_dispatch_times"]["t_k_s"]
    assert data["scan_dispatch_times"]["t_2k_s"]


def test_bench_batch_sweep_scaling():
    """The batch-size sweep records per-size timings and a linearity
    verdict, and takes the headline from the linear regime.  On CPU
    the program is genuinely compute-bound, so the sweep must come out
    linear and keep the requested batch."""
    res = run_bench(["--batch", "8", "--iters", "2", "--skip-baseline",
                     "--scan-k", "2", "--sweep", "2,4,8"])
    assert res.returncode == 0, res.stderr[-2000:]
    data = check_contract(res.stdout)
    assert set(data["batch_sweep_sec"]) == {"2", "4", "8"}
    assert set(data["batch_sweep_samples_per_s"]) == {"2", "4", "8"}
    sc = data["scaling"]
    # Slope timings at scan_k=2 on a loaded shared host are too noisy
    # to pin the verdict itself (the unit test below covers the verdict
    # logic on exact inputs); assert the CONTRACT: the verdict names
    # the linear boundary, and the headline figure is taken from it.
    assert sc["verdict"] in ("linear", "scale_economy") \
        or sc["verdict"].startswith("floor_limited_above_"), sc
    assert sc["linear_up_to"] in (2, 4, 8)
    assert data["headline_batch"] == min(8, sc["linear_up_to"])
    assert set(sc["ratios"]) == {"2->4", "4->8"}
    if len(data["runs_sec_per_batch"]) == 3:
        expect = data["batch_sweep_samples_per_s"][
            str(data["headline_batch"])]
        # scan-k=2 slopes on this loaded shared host can come out
        # negative (pure jitter); bench then substitutes the smallest
        # positive run and flags slope_unresolved -- the sweep entry
        # no longer matches by design.
        if expect > 0 and not data.get("slope_unresolved"):
            assert abs(data["value"] - expect) <= 0.51


def test_scaling_verdict_unit():
    sys.path.insert(0, REPO)
    import bench

    # Proportional timings -> linear all the way up.
    v = bench.scaling_verdict({64: 1.0, 128: 2.1, 256: 3.9, 512: 7.8})
    assert v["verdict"] == "linear" and v["linear_up_to"] == 512
    # Flat beyond 128 (dispatch floor): the largest trustworthy size
    # is 128 even though 256/512 "ran faster" per sample.
    v = bench.scaling_verdict({64: 1.0, 128: 1.9, 256: 2.0, 512: 2.1})
    assert v["linear_up_to"] == 128
    assert v["verdict"] == "floor_limited_above_128"
    # Entirely flat -> only the smallest size is trustworthy.
    v = bench.scaling_verdict({64: 1.0, 128: 1.0, 256: 1.0})
    assert v["linear_up_to"] == 64
    # A later recovery after a flat step must NOT re-enter the linear
    # regime (monotone prefix semantics).
    v = bench.scaling_verdict({64: 1.0, 128: 1.0, 256: 2.0})
    assert v["linear_up_to"] == 64
    # Sub-proportional but genuinely growing steps (a fixed
    # per-program cost amortizing) keep the headline at the largest
    # size but are labelled scale_economy, with the affine
    # decomposition reported.
    v = bench.scaling_verdict({64: 0.329, 128: 0.460, 256: 0.718,
                               512: 1.690})
    assert v["verdict"] == "scale_economy"
    assert v["linear_up_to"] == 512
    assert v["fixed_cost_s"] > 0
    assert v["slope_s_per_block"] > 0
    # Flat-ish 1.25x steps are still the floor, not economy.
    v = bench.scaling_verdict({64: 1.0, 128: 1.2, 256: 1.44})
    assert v["verdict"] == "floor_limited_above_64"
    # Step-size-aware thresholds: a genuine NON-doubling step (e.g. a
    # --batch 300 merged into the sweep; ideal ratio 300/256 = 1.17
    # can never clear a fixed 1.30 doubling cutoff) must not demote a
    # perfectly linear sweep ...
    v = bench.scaling_verdict({64: 64e-5, 128: 128e-5, 256: 256e-5,
                               300: 300e-5, 512: 512e-5})
    assert v["verdict"] == "linear" and v["linear_up_to"] == 512
    # ... and a sparse sweep's stacked floor step (two floor
    # doublings, 1.18^2 = 1.39 across 64->256) must still classify as
    # floor, not sneak past the fixed cutoff as growth.
    v = bench.scaling_verdict({64: 1.0, 256: 1.39})
    assert v["verdict"] == "floor_limited_above_64"


def test_bench_c64_and_modes():
    res = run_bench(["--batch", "8", "--iters", "2", "--skip-baseline",
                     "--input", "c64", "--sync-mode", "integer",
                     "--scan-k", "2", "--sweep", "none"])
    assert res.returncode == 0, res.stderr[-2000:]
    check_contract(res.stdout)


def test_bench_stream_program():
    res = run_bench(["--batch", "8", "--iters", "2", "--skip-baseline",
                     "--program", "stream"])
    assert res.returncode == 0, res.stderr[-2000:]
    check_contract(res.stdout)


@pytest.mark.parametrize("kind", ["raw", "card", "ingest"])
def test_bench_e2e_program(kind):
    res = run_bench(["--program", "e2e", "--batch", "8",
                     "--e2e-bytes", "3e6", "--input", kind,
                     "--skip-baseline"])
    assert res.returncode == 0, res.stderr[-2000:]
    line = [l for l in res.stdout.splitlines() if l.startswith("{")][-1]
    data = json.loads(line)
    assert data["metric"] == "e2e_throughput_" + kind
    assert data["unit"] == "IQ_samples/s"
    assert data["value"] > 0
    assert data["vs_baseline"] > 0
    assert data["blocks"] > 0
    assert data["device"]["platform"] == "cpu"
    if kind == "ingest":
        # The ingest ceiling must pump the RAW stream format: 3e6
        # bytes // (8-block chunks of 2*new_len bytes each) -> exactly
        # 16 chunks of 8 blocks (a .card-format file, the old bug,
        # yields a different block count from its base64 expansion).
        new_bytes = 2 * (16384 - 4920)
        chunks = int(3e6) // (8 * new_bytes)
        assert data["blocks"] == 8 * chunks


def test_bench_ingest_feeds_aggregate():
    """--feeds N: N parallel per-receiver feed pumps, aggregate host
    ingest.  Block accounting must be exact per feed."""
    res = run_bench(["--program", "e2e", "--input", "ingest",
                     "--feeds", "2", "--e2e-bytes", "6e6",
                     "--batch", "8", "--skip-baseline"])
    assert res.returncode == 0, res.stderr[-2000:]
    line = [l for l in res.stdout.splitlines() if l.startswith("{")][-1]
    data = json.loads(line)
    assert data["metric"] == "ingest_throughput_aggregate"
    assert data["feeds"] == 2
    assert data["value"] > 0
    new_bytes = 2 * (16384 - 4920)
    chunks = int(3e6) // (8 * new_bytes)  # per-feed bytes // chunk
    assert data["blocks_per_feed"] == [8 * chunks] * 2


def test_bench_feeds_requires_ingest():
    res = run_bench(["--program", "e2e", "--input", "raw",
                     "--feeds", "2", "--e2e-bytes", "3e6",
                     "--skip-baseline"])
    assert res.returncode != 0
    assert "ingest" in res.stderr


def test_bench_serve_program():
    res = run_bench(["--program", "serve"])
    assert res.returncode == 0, res.stderr[-2000:]
    line = res.stdout.strip().splitlines()[-1]
    data = json.loads(line)
    assert data["metric"] == "serve_throughput"
    assert data["unit"] == "fixes/s"
    assert data["value"] > 0
    assert data["vs_baseline"] > 0


def test_bench_refuses_cpu_without_flag():
    """With no accelerator the benchmark fails instead of reporting
    CPU figures as device numbers."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    code = ("import jax; jax.config.update('jax_platforms','cpu'); "
            "import runpy, sys; sys.argv = ['bench.py', '--batch', '8']; "
            "runpy.run_path({!r}, run_name='__main__')".format(
                os.path.join(REPO, "bench.py")))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "no accelerator" in res.stderr
    assert not [l for l in res.stdout.splitlines() if l.startswith("{")]


def test_abcheck_program():
    """On-device config A/B program: carrier_fast off-vs-auto under
    the matmul impl exercises the windowed carrier path."""
    res = run_bench(["--program", "abcheck", "--batch", "16",
                     "--fft-impl", "matmul", "--ab", "carrier_fast=off"])
    assert res.returncode == 0, res.stderr[-2000:]
    line = [l for l in res.stdout.splitlines() if l.startswith("{")][-1]
    data = json.loads(line)
    assert data["metric"] == "config_abcheck"
    assert data["value"] == 1.0
    assert data["ab"] == {"carrier_fast": "off"}
    d = data["field_diffs"]
    assert d["detected"] == 0 and d["corr_sample"] == 0


def test_abcheck_knee_program():
    """Knee-sweep config A/B: burst amplitudes spanning the detection
    knee, decision flips graded by deciding-gate margin.  matmul-vs-xla
    on CPU must agree flip-free with SoAs equal on both-detected
    blocks."""
    res = run_bench(["--program", "abcheck", "--batch", "32",
                     "--fft-impl", "matmul", "--ab", "fft_impl=xla",
                     "--ab-knee"])
    assert res.returncode == 0, res.stderr[-2000:]
    line = [l for l in res.stdout.splitlines() if l.startswith("{")][-1]
    data = json.loads(line)
    assert data["metric"] == "config_abcheck_knee"
    assert data["value"] == 1.0
    k = data["knee"]
    assert k["n_blocks"] == 32
    # The amplitude sweep must genuinely straddle the knee: some
    # blocks detected, some not (otherwise the check is vacuous).
    assert 0 < k["n_both"] < k["n_blocks"]
    assert k["n_flips"] == 0 or k["max_flip_margin_rel"] <= k["band"]
    # Integer and fractional SoA parts compared separately (an f32 sum
    # corr_sample + offset quantizes at ~1e-3 and would hide offset
    # drift); sample indices must agree exactly on both-detected blocks.
    assert k["sample_mismatch_both"] == 0
    assert k["max_corr_off_diff_both"] <= 1e-3


def test_abcheck_knee_gate():
    """Gate A/B through the knee program: gated-vs-ungated must agree
    flip-free with SoAs equal on both-detected blocks.  (The knee
    comparison restricts field checks to both-detected rows, which is
    exactly the gate's contract -- carrier-negative rows report zeros
    by design, so the plain abcheck's all-rows field diff does not
    apply to this knob.)"""
    res = run_bench(["--program", "abcheck", "--batch", "32",
                     "--ab", "gate_capacity=16", "--ab-knee"])
    assert res.returncode == 0, res.stderr[-2000:]
    line = [l for l in res.stdout.splitlines() if l.startswith("{")][-1]
    data = json.loads(line)
    assert data["metric"] == "config_abcheck_knee"
    assert data["value"] == 1.0
    assert data["ab"] == {"gate_capacity": 16}


def test_abcheck_gate_wired():
    """An explicit --gate reaches the abcheck base config (both sides
    gated) and is recorded in the certificate JSON; without it the
    base stays ungated (gate 0)."""
    res = run_bench(["--program", "abcheck", "--batch", "16",
                     "--gate", "8", "--fft-impl", "matmul",
                     "--ab", "carrier_fast=off"])
    assert res.returncode == 0, res.stderr[-2000:]
    line = [l for l in res.stdout.splitlines() if l.startswith("{")][-1]
    data = json.loads(line)
    assert data["value"] == 1.0
    assert data["gate"] == 8
    res = run_bench(["--program", "abcheck", "--batch", "16",
                     "--fft-impl", "matmul", "--ab", "carrier_fast=off"])
    assert res.returncode == 0, res.stderr[-2000:]
    line = [l for l in res.stdout.splitlines() if l.startswith("{")][-1]
    assert json.loads(line)["gate"] == 0


def test_gate_batch_program():
    """--gate wires into the timed batch program and its sweep."""
    res = run_bench(["--batch", "16", "--iters", "2", "--repeats", "1",
                     "--scan-k", "2", "--sweep", "8,16", "--gate", "8",
                     "--skip-baseline"])
    assert res.returncode == 0, res.stderr[-2000:]
    data = check_contract(res.stdout)
    assert data["gate"] == 8


def test_abcheck_requires_ab():
    res = run_bench(["--program", "abcheck", "--batch", "16"])
    assert res.returncode != 0
    assert "--ab" in res.stderr


def test_ab_validation_errors():
    """--ab must fail fast with a usage error (not a traceback) on
    unknown fields, bad values, and gate_capacity without --ab-knee
    (the plain all-rows diff does not apply to gated outputs)."""
    res = run_bench(["--program", "abcheck", "--batch", "16",
                     "--ab", "gate_capacity=8"])
    assert res.returncode != 0
    assert "ab-knee" in res.stderr
    res = run_bench(["--program", "abcheck", "--batch", "16",
                     "--ab", "fft_precison=high"])  # typo
    assert res.returncode != 0
    assert "unknown DetectorConfig field" in res.stderr
    res = run_bench(["--program", "abcheck", "--batch", "16",
                     "--ab", "gate_capacity=lots", "--ab-knee"])
    assert res.returncode != 0
    assert "not a valid value" in res.stderr
    res = run_bench(["--program", "abcheck", "--batch", "16",
                     "--ab", "carrier_thresh=0"])
    assert res.returncode != 0
    assert "not overridable" in res.stderr
