#!/usr/bin/env python
"""Mesh scaling sweep: streaming-detect throughput vs device count.

Runs the halo-exchange streaming detector over growing (rx, time)
meshes and reports per-shape step time, aggregate throughput, and
scaling efficiency relative to the single-device run.  On a multi-GPU
host the ppermute halos travel over the cards' all-to-all links; on a
CPU-only machine it is validated functionally on virtual devices.

Timing uses the same data-dependent chain as bench.py (the carry
perturbs the next iteration's input with a value visible in float32),
so steps cannot overlap or be cached behind the runtime's back.

Usage:
  # functional smoke on 8 virtual CPU devices
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
      python scripts/scaling_sweep.py --platform cpu --geometry tiny

  # multi-PROCESS rehearsal on CPU: spawns N coordinator-connected
  # jax.distributed workers, each owning --devices-per-process virtual
  # devices, and sweeps the global mesh
  python scripts/scaling_sweep.py --platform cpu --geometry tiny \\
      --processes 2 --devices-per-process 4 --shapes 2x4

  # one process per card on a multi-GPU host: worker N sees only card
  # N (CUDA_VISIBLE_DEVICES), so no two workers share a card
  python scripts/scaling_sweep.py --processes 4 --shapes 1x4 \\
      --geometry full --coordinator localhost:37741

  # one process driving every local card (the cheaper layout)
  python scripts/scaling_sweep.py --geometry full --iters 20
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def parse_shapes(text, n_avail):
    """'1x1,1x2,2x2' -> [(1,1),(1,2),(2,2)]; default: powers of two."""
    if text:
        shapes = []
        for part in text.split(","):
            rx, _, t = part.lower().partition("x")
            shapes.append((int(rx), int(t)))
        return shapes
    shapes = []
    n = 1
    while n <= n_avail:
        shapes.append((1, n))
        if n >= 4 and n % 2 == 0:
            shapes.append((2, n // 2))
        n *= 2
    return shapes


def worker_env(base_env, process_id, platform, devices_per_process):
    """Environment of spawned worker ``process_id``.

    Emulating devices on the CPU (``platform == 'cpu'``): every worker
    stays on the CPU backend with ``devices_per_process`` virtual
    devices.  Otherwise each worker is pinned to its own card through
    ``CUDA_VISIBLE_DEVICES``: a JAX process reserves most of a card's
    memory when it starts, so two workers on one card would fail.
    """
    env = dict(base_env)
    if platform == "cpu":
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (
            env.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count="
            + str(devices_per_process)).strip()
    else:
        env["CUDA_VISIBLE_DEVICES"] = str(process_id)
    return env


def time_mesh(detector, template, num_rx, num_time, blocks_per_shard,
              iters, devices):
    """Chained per-step seconds for one mesh shape.

    Uses bench.py's shared `time_stream_mesh` timer with burst-bearing
    captures: the data-dependent chain's 1e-10 perturbation factor is
    calibrated against a corr-energy carry of ~1e5-1e6, which only
    burst-bearing inputs produce (pure noise would leave the chain
    perturbation below float32 visibility).
    """
    import numpy as np

    import bench

    from thrifty_tpu.parallel import mesh as mesh_mod

    m = mesh_mod.make_mesh(num_rx=num_rx, num_time=num_time,
                           devices=devices[: num_rx * num_time])
    total_blocks = num_time * blocks_per_shard
    new_len = detector.new_len
    total = total_blocks * new_len
    tpl = np.asarray(template, dtype=np.complex64)
    streams = []
    for seed in (0, 1):
        rng = np.random.default_rng(seed)
        s = (rng.normal(size=(num_rx, total))
             + 1j * rng.normal(size=(num_rx, total))
             ).astype(np.complex64) * 0.05
        # Splice a template copy into every block so the corr-energy
        # carry is large in every shard/iteration.
        for b in range(total_blocks):
            pos = b * new_len
            end = min(pos + len(tpl), total)
            s[:, pos:end] += 0.6 * tpl[: end - pos]
        streams.append(s)

    sec = bench.time_stream_mesh(detector, streams, m,
                                 blocks_per_shard, iters)
    samples = num_rx * num_time * blocks_per_shard * detector.new_len
    return sec, samples


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--shapes", type=str, default=None,
                        help="comma list of RXxTIME mesh shapes "
                             "[default: power-of-two sweep]")
    parser.add_argument("--geometry", choices=["tiny", "full"],
                        default="full",
                        help="'full': 16384/4920 example geometry; "
                             "'tiny': 256/64 wiring check")
    parser.add_argument("--blocks-per-shard", type=int, default=4)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--platform", type=str, default=None,
                        help="force a JAX platform (cpu: emulate the "
                             "devices; workers stay on the CPU)")
    parser.add_argument("--json", type=str, default=None,
                        help="also write results to this JSON file")
    parser.add_argument("--processes", type=int, default=1,
                        help="spawn N coordinator-connected "
                             "jax.distributed worker processes, one "
                             "card each (or --devices-per-process "
                             "virtual devices each with --platform "
                             "cpu); every mesh shape must span all "
                             "processes' devices")
    parser.add_argument("--devices-per-process", type=int, default=4,
                        help="virtual CPU devices per worker process "
                             "in --processes --platform cpu mode "
                             "[default: 4]")
    parser.add_argument("--coordinator", type=str,
                        default="127.0.0.1:37741",
                        help="jax.distributed coordinator address for "
                             "--processes mode")
    parser.add_argument("--process-id", type=int, default=None,
                        help="(internal/manual) run as worker N of "
                             "--processes instead of spawning")
    args = parser.parse_args(argv)

    if args.processes > 1 and args.process_id is None:
        # Orchestrator: spawn N workers of this same command line and
        # stay off JAX itself, so it holds no card.
        import subprocess

        base = list(argv) if argv is not None else sys.argv[1:]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__)]
            + base + ["--process-id", str(pid)],
            env=worker_env(os.environ, pid, args.platform,
                           args.devices_per_process))
            for pid in range(args.processes)]
        rcs = [p.wait() for p in procs]
        return max(rcs)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    if args.processes > 1:
        from thrifty_tpu.parallel import distributed

        distributed.initialize(coordinator_address=args.coordinator,
                               num_processes=args.processes,
                               process_id=args.process_id)

    from thrifty_tpu import sim
    from thrifty_tpu.dsp import template as template_mod
    from thrifty_tpu.dsp.detector import BatchDetector, DetectorConfig

    if args.geometry == "full":
        template = sim.make_template()
        detector = BatchDetector(template,
                                 DetectorConfig(carrier_window=(7, 110)))
    else:
        template = template_mod.generate(5, 0, 2.0)
        detector = BatchDetector(
            template,
            DetectorConfig(block_len=256, history_len=64,
                           carrier_window=(4, 60), gn_iters=4))

    devices = jax.devices()
    shapes = [s for s in parse_shapes(args.shapes, len(devices))
              if s[0] * s[1] <= len(devices)]
    multi = jax.process_count() > 1
    if multi:
        # Every process must participate in every collective, so only
        # full-span meshes are timeable across processes.
        full = [s for s in shapes if s[0] * s[1] == len(devices)]
        dropped = [s for s in shapes if s not in full]
        if dropped and jax.process_index() == 0:
            print("# multi-process: dropping sub-span shapes {}"
                  .format(dropped), file=sys.stderr)
        shapes = full or [(jax.process_count(),
                           len(devices) // jax.process_count())]
    report = not multi or jax.process_index() == 0
    if report:
        print("# platform={} devices={} processes={} geometry={}".format(
            jax.default_backend(), len(devices), jax.process_count(),
            args.geometry), file=sys.stderr)

    results = []
    base_rate_per_dev = None
    for num_rx, num_time in shapes:
        n = num_rx * num_time
        sec, samples = time_mesh(detector, template, num_rx, num_time,
                                 args.blocks_per_shard, args.iters,
                                 devices)
        rate = samples / sec
        if base_rate_per_dev is None:
            base_rate_per_dev = rate / n
        eff = rate / (n * base_rate_per_dev)
        row = {"mesh": "{}x{}".format(num_rx, num_time), "devices": n,
               "sec_per_step": round(sec, 6),
               "samples_per_s": round(rate, 1),
               "efficiency": round(eff, 3)}
        results.append(row)
        if report:
            print("{mesh:>6}  n={devices:<3d} {sec_per_step:>10.6f} "
                  "s/step  {samples_per_s:>14.4g} samples/s  "
                  "eff={efficiency:.2f}".format(**row))

    if args.json and report:
        with open(args.json, "w") as f:
            json.dump({"geometry": args.geometry,
                       "platform": jax.default_backend(),
                       "processes": jax.process_count(),
                       "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
