#!/usr/bin/env python
"""Smoke test of the receiver-to-position chain on one NVIDIA GPU.

Drives the system through the entry points a user calls -- the
``thrifty-tpu`` CLI, in-process (a second JAX process on the same card
would fail for want of device memory) -- at the reference deployment's
full geometry: 2.4 Msps, 16384-sample blocks, 4920 history, carrier
window 7-110, ``15*snr`` thresholds, the 11-bit Gold template (4914
samples), batch 256.  Phases:

  device       the JAX backend must be the GPU (there is no CPU
               fallback); prints the card, versions, XLA_FLAGS and the
               compile-cache directory
  golden       integer sync vs the compiled fastdet goldens, and the
               Python-semantics chain through positions vs the
               reference goldens (scripts/golden_check.py)
  deployment   a synthetic 4-receiver network (1 beacon + 3 mobiles on
               the channels of deploy/freq-map.cfg), >= 10 full batches
               of raw u8 IQ per receiver, through detect --raw (host
               and device unfold), identify, match, tdoa, pos --batched
               and serve --once, checked against the planted truth; 64
               carrier-positive blocks vs the float64 oracle
  transforms   one [256, 16384] batch under fft_impl='xla' and
               'matmul' (with their carrier_fast/ramp_fast
               consequences): identical decisions, floats within
               bench_abcheck's tolerance

``--cards 4`` runs only __graft_entry__.dryrun_multichip(4) (the rx x
time mesh, ppermute halo, GSPMD twin and template bank, at tiny and
production geometry, against planted truth).

Usage:  python chip_smoke.py [--cards 4]

Exits non-zero, with ``"ok": false`` in its last line, if any phase
fails or no GPU is present.  On success the last line is exactly
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

FS = 2.4e6
BLOCK = 16384
HISTORY = 4920
BATCH = 256
T0 = 1.5e9
CARRIER_WINDOW = "7-110"

# The planted network: 4 receivers on an ~9 km footprint, a beacon and
# three mobiles inside it.
RX_POS = {0: (0.0, 0.0), 1: (9000.0, 500.0), 2: (4000.0, 8000.0),
          3: (8500.0, 7500.0)}
BEACON_POS = {9: (4500.0, 3000.0)}
MOBILE_POS = {0: (6000.0, 2500.0), 1: (2500.0, 5000.0),
              2: (7000.0, 6000.0)}
CLOCK_OFFSETS = {1: 777.25, 2: -123.5, 3: 4000.75}
CLOCK_DRIFTS = {1: 3e-6, 2: -2e-6, 3: 1e-6}

# |SoA - planted truth| bound per detected burst, in samples: the verify
# skill's bound; at this SNR (amplitude 0.5, noise 0.05) the f32 SoA
# error is ~1e-3 samples, so 0.05 leaves a wide margin while any
# window, wrap or shift bug moves the SoA by >= 0.1.
SOA_TRUTH_TOL = 0.05
# Position bound vs the planted geometry, in metres.  SoA noise of
# ~1e-3 samples is ~0.1 m of range; the beacon-synchronised TDOA
# (polynomial clock model over the 8 s window) and a GDOP of a few
# keep fixes within metres.  A TDOA or clock-sync bug moves fixes by
# tens of metres or more.
POSITION_TOL_M = 5.0
# serve --once vs pos --batched, in metres: both run the same
# multi-start Gauss-Newton on the same detections, but serve's
# sliding-window clock sync sees a different beacon window than the
# offline tdoa run, so fixes differ by the clock-model noise only.
SERVE_VS_POS_TOL_M = 2.0
# serve and pos fixes of one transmission share its timestamp (the
# group's first detection) to well within a block (4.8 ms).
SAME_TX_TOL_S = 1e-3

# Detector vs the float64 oracle (thrifty_tpu/oracle/numpy_ref.py),
# per field, with the CPU tests' tolerances and their reasons:
#   decisions, carrier bin, corr sample: identical -- any difference is
#     a logic bug, not rounding;
#   SoA (corr_sample + corr_offset): 1e-2 samples -- the random-geometry
#     differential fuzz's bound (tests/test_fuzz.py), set by f32
#     interpolation noise on small templates; production templates
#     measure ~1e-7..1e-4;
#   carrier_offset: 5e-3 bins, energies: 1e-3 relative, noises: 1e-2
#     relative -- tests/test_detector.py::test_matches_oracle, the f32
#     rounding of 16384-point transforms and sums.
ORACLE_SOA_TOL = 1e-2
ORACLE_CARRIER_OFFSET_TOL = 5e-3
ORACLE_ENERGY_RTOL = 1e-3
ORACLE_NOISE_RTOL = 1e-2
ORACLE_BLOCKS = 64

# xla vs matmul transforms: bench_abcheck's float tolerance (1e-3
# absolute on offsets, relative on energies/noises) -- two float32
# transform algorithms at HIGHEST precision differ by ~1e-6 relative,
# so 1e-3 flags only a wrong formula, never rounding.
TRANSFORM_FLOAT_TOL = 1e-3


class PhaseFailure(Exception):
    pass


def log(msg):
    print(msg, flush=True)


def require(cond, msg):
    if not cond:
        raise PhaseFailure(msg)


# -- helpers (unit-tested on the CPU at small geometry) ---------------------

def deployment_schedule(seconds, period=0.25, start=0.2):
    """(txid, t) transmissions: every ``period`` s the next of beacon 9
    and mobiles 0, 1, 2 -- one transmission per ~52 blocks, so no two
    bursts ever share a block (the detector takes one carrier per
    block, as the reference does)."""
    order = [9] + sorted(MOBILE_POS)
    times = np.arange(start, seconds - start, period)
    return [(order[i % len(order)], float(t)) for i, t in enumerate(times)]


def channel_bins(freqmap_path):
    """Centre bin of every transmitter channel in a freq-map config."""
    from thrifty_tpu.config.settings import parse_kv_config

    with open(freqmap_path) as f:
        strings = parse_kv_config(f)
    bins = {}
    for key, value in strings.items():
        if not key.startswith("@"):
            start, stop = (float(x) for x in value.split("-"))
            bins[int(key)] = (start + stop) / 2.0
    return bins


def write_deployment(d, seconds, template, block_len=BLOCK,
                     history_len=HISTORY, seed=5):
    """Synthesize the 4-receiver network's raw u8 IQ files and configs
    into ``d``; returns ({rxid: Capture}, tx_bins)."""
    from thrifty_tpu import sim
    from thrifty_tpu.dsp import iq

    freqmap_src = os.path.join(REPO, "deploy", "freq-map.cfg")
    tx_bins = channel_bins(freqmap_src)
    with open(freqmap_src) as f:
        channels = [l for l in f if l.strip() and not l.startswith(("#", "@"))]
    with open(os.path.join(d, "freq-map.cfg"), "w") as f:
        f.writelines(channels)
        f.writelines("@{}: 0\n".format(r) for r in RX_POS)
    with open(os.path.join(d, "pos-rx.cfg"), "w") as f:
        f.writelines("{}: {} {}\n".format(r, *p) for r, p in RX_POS.items())
    with open(os.path.join(d, "pos-beacon.cfg"), "w") as f:
        f.writelines("{}: {} {}\n".format(t, *p)
                     for t, p in BEACON_POS.items())
    np.save(os.path.join(d, "template.npy"), template)

    new_len = block_len - history_len
    num_blocks = int(np.ceil(seconds * FS / new_len))
    tx_pos = {t: np.asarray(p) for t, p in
              {**BEACON_POS, **MOBILE_POS}.items()}
    caps = sim.synth_rx_captures(
        {r: np.asarray(p) for r, p in RX_POS.items()}, tx_pos, tx_bins,
        deployment_schedule(num_blocks * new_len / FS), template=template,
        num_blocks=num_blocks, block_len=block_len,
        history_len=history_len, amplitude=0.5, noise_std=0.05,
        clock_offsets=CLOCK_OFFSETS, clock_drifts=CLOCK_DRIFTS, seed=seed,
        t0=T0)
    for r, cap in caps.items():
        stream = cap.blocks[:, history_len:].reshape(-1)
        iq.iq_to_raw(stream).tofile(os.path.join(d, "rx%d.bin" % r))
    return caps, tx_bins


def toad_rows_differ(path_a, path_b):
    """Line numbers at which two .toad files differ (a missing line
    counts as different)."""
    with open(path_a) as f:
        a = f.read().splitlines()
    with open(path_b) as f:
        b = f.read().splitlines()
    return [i for i in range(max(len(a), len(b)))
            if i >= len(a) or i >= len(b) or a[i] != b[i]]


def check_bursts(recs, bursts, tol=SOA_TRUTH_TOL):
    """Every planted burst has a detection within ``tol`` samples of
    its true SoA.  Returns (max |error|, missed bursts)."""
    soa = np.sort(np.asarray(recs["soa"], dtype=np.float64))
    worst, missed = 0.0, []
    for b in bursts:
        if b.block_idx < 0:
            continue  # outside every block's unique window
        i = np.searchsorted(soa, b.expected_soa)
        near = soa[max(i - 1, 0):i + 1]
        err = float(np.min(np.abs(near - b.expected_soa))) if len(near) \
            else np.inf
        if err >= tol:
            missed.append((b.expected_soa, err))
        else:
            worst = max(worst, err)
    return worst, missed


def position_errors(fixes, truth):
    """Distance of each fix to its transmitter's planted position."""
    return np.array([
        float(np.hypot(row["x"] - truth[int(row["tx"])][0],
                       row["y"] - truth[int(row["tx"])][1]))
        for row in fixes])


def pair_fixes(a, b, tol_s=SAME_TX_TOL_S):
    """Pair fixes of the same transmission (same tx, timestamps within
    ``tol_s``).  Returns (pairs [(i, j)], unpaired_a, unpaired_b)."""
    pairs, used = [], set()
    for i, row in enumerate(a):
        cand = [j for j in range(len(b)) if j not in used
                and int(b[j]["tx"]) == int(row["tx"])
                and abs(b[j]["timestamp"] - row["timestamp"]) < tol_s]
        if cand:
            pairs.append((i, cand[0]))
            used.add(cand[0])
    return (pairs, [i for i in range(len(a)) if i not in {p[0] for p in pairs}],
            [j for j in range(len(b)) if j not in used])


def compare_with_oracle(out, oracle_results):
    """Batched detector outputs vs float64 oracle results, block by
    block.  Returns (violations [str], max |SoA diff|)."""
    bad, worst = [], 0.0
    for i, ref in enumerate(oracle_results):
        def fail(field, got, want):
            bad.append("block %d %s: %r vs oracle %r" % (i, field, got, want))

        def rel(a, b):
            return abs(a - b) / max(abs(b), 1e-30)

        if bool(out["carrier_detect"][i]) != ref.carrier_detect:
            fail("carrier_detect", bool(out["carrier_detect"][i]),
                 ref.carrier_detect)
            continue
        if not ref.carrier_detect:
            continue
        if int(out["carrier_bin"][i]) != ref.carrier_bin:
            fail("carrier_bin", int(out["carrier_bin"][i]), ref.carrier_bin)
            continue
        if abs(float(out["carrier_offset"][i]) - ref.carrier_offset) \
                > ORACLE_CARRIER_OFFSET_TOL:
            fail("carrier_offset", float(out["carrier_offset"][i]),
                 ref.carrier_offset)
        if rel(float(out["carrier_energy"][i]), ref.carrier_energy) \
                > ORACLE_ENERGY_RTOL:
            fail("carrier_energy", float(out["carrier_energy"][i]),
                 ref.carrier_energy)
        if rel(float(out["carrier_noise"][i]), ref.carrier_noise) \
                > ORACLE_NOISE_RTOL:
            fail("carrier_noise", float(out["carrier_noise"][i]),
                 ref.carrier_noise)
        if bool(out["detected"][i]) != ref.detected:
            fail("detected", bool(out["detected"][i]), ref.detected)
            continue
        if not ref.detected:
            continue
        if int(out["corr_sample"][i]) != ref.corr_sample:
            fail("corr_sample", int(out["corr_sample"][i]), ref.corr_sample)
            continue
        diff = abs(float(out["corr_offset"][i]) - ref.corr_offset)
        worst = max(worst, diff)
        if diff > ORACLE_SOA_TOL:
            fail("soa", float(out["corr_offset"][i]), ref.corr_offset)
        if rel(float(out["corr_energy"][i]), ref.corr_energy) \
                > ORACLE_ENERGY_RTOL:
            fail("corr_energy", float(out["corr_energy"][i]),
                 ref.corr_energy)
        if rel(float(out["corr_noise"][i]), ref.corr_noise) \
                > ORACLE_NOISE_RTOL:
            fail("corr_noise", float(out["corr_noise"][i]), ref.corr_noise)
    return bad, worst


# -- phases -----------------------------------------------------------------

def phase_device():
    import jax
    import jaxlib

    backend = jax.default_backend()
    require(backend == "gpu",
            "JAX backend is %r, not 'gpu': no GPU found" % backend)
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        card = "nvidia-smi unavailable (%s)" % e
    log("card: " + card)
    log("jax %s, jaxlib %s, python %s" % (
        jax.__version__, jaxlib.__version__, sys.version.split()[0]))
    log("XLA_FLAGS=%r" % os.environ.get("XLA_FLAGS", ""))
    from thrifty_tpu.compile_cache import enable_compile_cache

    log("compile cache: " + enable_compile_cache())
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def _load_golden_check():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "golden_check", os.path.join(REPO, "scripts", "golden_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_golden():
    from thrifty_tpu.cli import main as cli_main

    gc = _load_golden_check()
    with tempfile.TemporaryDirectory() as d:
        reports = gc.check_all(cli_main, d, gc.GPU_TOL_SCALE)
    for r in reports:
        log("golden " + json.dumps(r))
    worst = max(r.get("max_err_in_cpu_tols", 0.0) for r in reports)
    pos = [r["max_position_err_m"] for r in reports
           if "max_position_err_m" in r]
    log("golden: worst float error %.3f x the CPU-golden tolerance "
        "(scale %.1f allowed); worst position error %s m" % (
            worst, gc.GPU_TOL_SCALE, pos[0] if pos else "n/a"))
    require(all(r["ok"] for r in reports),
            "golden mismatch: %s" % [r for r in reports if not r["ok"]])


def _run_cli(cli_main, argv):
    rc = cli_main(argv)
    require(rc in (0, None), "thrifty-tpu %s exited %r" % (argv[0], rc))


def phase_deployment(seconds=12.4, template=None, block_len=BLOCK,
                     history_len=HISTORY, batch=BATCH,
                     oracle_blocks=ORACLE_BLOCKS):
    from thrifty_tpu import sim
    from thrifty_tpu.cli import main as cli_main
    from thrifty_tpu.dsp.detector import BatchDetector, DetectorConfig
    from thrifty_tpu.io import toad
    from thrifty_tpu.oracle.numpy_ref import OracleDetector
    from thrifty_tpu.pipeline import pos as pos_mod

    if template is None:
        template = sim.make_template()
    with tempfile.TemporaryDirectory() as d:
        p = lambda name: os.path.join(d, name)  # noqa: E731
        t_syn = time.perf_counter()
        caps, tx_bins = write_deployment(d, seconds, template, block_len,
                                         history_len)
        num_blocks = len(caps[0].blocks)
        log("deployment: %d receivers x %d blocks (%.2f s of IQ, %d "
            "batches of %d), %d transmissions, synthesized in %.1f s" % (
                len(caps), num_blocks,
                num_blocks * (block_len - history_len) / FS,
                num_blocks // batch, batch, len(caps[0].bursts),
                time.perf_counter() - t_syn))

        # An explicit empty config keeps detect from reading any
        # detector.cfg in the working directory.
        with open(p("detector.cfg"), "w"):
            pass
        common = ["--quiet", "--raw", "--t0", repr(T0), "-c", p("detector.cfg"),
                  "--template", p("template.npy"),
                  "--carrier-window", CARRIER_WINDOW,
                  "--block-size", str(block_len),
                  "--history", str(history_len),
                  "--batch-size", str(batch)]
        rates = {"host": [], "device": []}
        for r in sorted(caps):
            for mode, extra in (("host", []), ("device", ["--device-unfold"])):
                out = p("rx%d%s.toad" % (r, "" if mode == "host" else "_du"))
                t = time.perf_counter()
                _run_cli(cli_main, ["detect", p("rx%d.bin" % r), "-o", out,
                                    "--rxid", str(r)] + common + extra)
                rates[mode].append(num_blocks * (block_len - history_len)
                                   / (time.perf_counter() - t))
        for mode, rs in rates.items():
            # The first call of each mode compiles its program.
            warm = rs[1:] if len(rs) > 1 else rs
            log("detect --raw (%s unfold): %.4g IQ samples/s = %.1fx "
                "realtime at 2.4 Msps after the first call (first call, "
                "with compilation: %.4g)" % (
                    mode, float(np.median(warm)), float(np.median(warm)) / FS,
                    rs[0]))

        worst_soa = 0.0
        for r, cap in caps.items():
            diff = toad_rows_differ(p("rx%d.toad" % r), p("rx%d_du.toad" % r))
            require(not diff, "rx%d: host and device unfold .toad rows "
                    "differ at lines %s" % (r, diff[:5]))
            recs = toad.load_toad(p("rx%d.toad" % r))
            worst, missed = check_bursts(recs, cap.bursts)
            require(not missed, "rx%d: planted bursts missed or off: %s"
                    % (r, missed[:5]))
            worst_soa = max(worst_soa, worst)
        log("bursts: all detected by both unfold paths (identical .toad "
            "rows); max |SoA - truth| %.2e samples (bound %g)" % (
                worst_soa, SOA_TRUTH_TOL))

        toads = [p("rx%d.toad" % r) for r in sorted(caps)]
        _run_cli(cli_main, ["identify"] + toads + [
            "-o", p("data.toads"), "-m", p("freq-map.cfg")])
        _run_cli(cli_main, ["match", p("data.toads"), "-o", p("data.match"),
                            "-w", "0.02"])
        _run_cli(cli_main, ["tdoa", p("data.toads"), p("data.match"),
                            "-o", p("data.tdoa"), "-r", p("pos-rx.cfg"),
                            "-b", p("pos-beacon.cfg")])
        _run_cli(cli_main, ["pos", p("data.tdoa"), "-o", p("data.pos"),
                            "-r", p("pos-rx.cfg"), "--batched"])
        _run_cli(cli_main, ["serve"] + toads + [
            "-o", p("live.pos"), "-r", p("pos-rx.cfg"),
            "-b", p("pos-beacon.cfg"), "-m", p("freq-map.cfg"), "--once",
            "--history", str(max(30.0, 2 * seconds))])

        fixes = pos_mod.load_positions(p("data.pos"))
        n_mobile_tx = sum(1 for t, _ in deployment_schedule(
            num_blocks * (block_len - history_len) / FS) if t in MOBILE_POS)
        require(len(fixes) > 0, "pos produced no fixes")
        errs = position_errors(fixes, MOBILE_POS)
        log("pos --batched: %d fixes for %d mobile transmissions; max "
            "error vs planted %.3f m (bound %g m)" % (
                len(fixes), n_mobile_tx, float(errs.max()), POSITION_TOL_M))
        require(float(errs.max()) < POSITION_TOL_M,
                "position error %.3f m" % float(errs.max()))

        live = pos_mod.load_positions(p("live.pos"))
        pairs, only_pos, only_serve = pair_fixes(fixes, live)
        require(not only_pos and not only_serve,
                "serve and pos resolved different transmissions: %d only "
                "in pos, %d only in serve" % (len(only_pos),
                                               len(only_serve)))
        gap = max(float(np.hypot(fixes[i]["x"] - live[j]["x"],
                                 fixes[i]["y"] - live[j]["y"]))
                  for i, j in pairs)
        log("serve --once: the same %d transmissions; max distance to "
            "pos's fix %.3f m (bound %g m)" % (len(pairs), gap,
                                               SERVE_VS_POS_TOL_M))
        require(gap < SERVE_VS_POS_TOL_M, "serve vs pos %.3f m" % gap)

        # Float64 oracle on carrier-positive blocks: the blocks of the
        # planted bursts (and their straddle neighbours) at rx 0..3.
        rows = []
        for r, cap in sorted(caps.items()):
            for b in cap.bursts:
                for k in (b.block_idx, b.block_idx + 1):
                    if 0 <= k < num_blocks and (r, k) not in rows:
                        rows.append((r, k))
        rows = rows[:oracle_blocks]
        blocks = np.stack([caps[r].blocks[k] for r, k in rows])
        det = BatchDetector(template, DetectorConfig(
            block_len=block_len, history_len=history_len,
            carrier_window=(7, 110)))
        out = {k: np.asarray(v) for k, v in det(blocks).items()}
        require(int(out["carrier_detect"].sum()) >= len(rows) // 2,
                "too few carrier-positive blocks for the oracle check")
        oracle = OracleDetector(template, block_len=block_len,
                                history_len=history_len,
                                carrier_window=(7, 110))
        refs = [oracle.detect_block(b.astype(np.complex128))
                for b in blocks]
        bad, worst = compare_with_oracle(out, refs)
        log("oracle: %d blocks (%d carrier-positive), max |SoA diff| "
            "%.2e samples (bound %g); %d violations" % (
                len(rows), int(out["carrier_detect"].sum()), worst,
                ORACLE_SOA_TOL, len(bad)))
        require(not bad, "detector vs float64 oracle: %s" % bad[:5])


def phase_transforms(batch=BATCH):
    import bench
    from thrifty_tpu import sim
    from thrifty_tpu.dsp.detector import DetectorConfig

    base = DetectorConfig(carrier_window=(7, 110), fft_impl="xla")
    ok, diffs = bench.bench_abcheck(sim.make_template(), batch, base,
                                    {"fft_impl": "matmul"},
                                    float_tol=TRANSFORM_FLOAT_TOL)
    log("transforms xla vs matmul (highest): " + json.dumps(diffs))
    require(ok, "xla and matmul transforms disagree: %s" % diffs)
    # For information: what 'high' precision (TF32 on the GPU) costs in
    # accuracy on the same batch.
    _, diffs = bench.bench_abcheck(sim.make_template(), batch, base,
                                   {"fft_impl": "matmul",
                                    "fft_precision": "high"},
                                   float_tol=TRANSFORM_FLOAT_TOL)
    log("transforms xla vs matmul (high), not asserted: "
        + json.dumps(diffs))


def phase_cards(n):
    import jax

    sys.path.insert(0, REPO)
    import __graft_entry__

    require(len(jax.devices()) >= n,
            "%d devices visible, %d needed" % (len(jax.devices()), n))
    __graft_entry__.dryrun_multichip(n)
    log("dryrun_multichip(%d): ok" % n)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--cards", type=int, default=1, choices=[1, 4],
                        help="4: run only the four-card mesh phase")
    args = parser.parse_args(argv)

    sys.path.insert(0, REPO)
    phases = [("device", phase_device)]
    if args.cards == 4:
        phases.append(("cards", lambda: phase_cards(4)))
    else:
        phases += [("golden", phase_golden),
                   ("deployment", phase_deployment),
                   ("transforms", phase_transforms)]
    device = None
    for name, fn in phases:
        t = time.perf_counter()
        log("== phase %s" % name)
        try:
            result = fn()
        except Exception as e:  # noqa: BLE001 -- reported, exits non-zero
            import traceback

            traceback.print_exc()
            print(json.dumps({"ok": False, "phase": name,
                              "error": "%s: %s" % (type(e).__name__, e)}))
            return 1
        if name == "device":
            device = result
        log("== phase %s ok (%.1f s)" % (name, time.perf_counter() - t))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
