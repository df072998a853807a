"""Umbrella CLI: ``thrifty-tpu <command>`` (or ``python -m thrifty_tpu.cli``).

Mirrors the reference's command set (thrifty/cli.py:47-61) with the same
subcommand names, lazily importing each command module.
"""

from __future__ import annotations

import importlib
import sys

HELP = """usage: thrifty-tpu <command> [<args>]

Batched JAX TDOA positioning framework.

Receiver commands:
    capture           Capture raw IQ data from an SDR (subprocess wrapper)
    detect            Detect positioning signals, estimate SoA (on device)

Server commands:
    identify          Merge .toad files, identify transmitter IDs, dedup
    match             Match detections across receivers
    tdoa              Estimate TDOAs using beacon clock sync
    pos               Estimate positions from TDOAs
    serve             Live positioning: tail .toad files, emit fixes
    track             Kalman-smooth position fixes into tracks

Analysis commands:
    analyze_toads     Statistics on .toads detection data
    analyze_detect    Per-stage detection diagnostics
    analyze_beacon    Beacon clock-sync quality between two receivers
    analyze_tdoa      TDOA precision measurement

Utilities:
    template_generate Generate a new (ideal) Gold-code template
    template_extract  Extract a template from captured data
    gold              Generate Gold codes / print code stats
    scope             Live time/freq/histogram scope with triggers
    bench             Run the detector benchmark
    doctor            Check this node can run the full pipeline

Use 'thrifty-tpu help <command>' for a command's arguments."""

COMMANDS = {
    "capture": "thrifty_tpu.pipeline.capture",
    "detect": "thrifty_tpu.pipeline.detect",
    "identify": "thrifty_tpu.pipeline.identify",
    "match": "thrifty_tpu.pipeline.matchmaker",
    "tdoa": "thrifty_tpu.pipeline.tdoa",
    "pos": "thrifty_tpu.pipeline.pos",
    "serve": "thrifty_tpu.pipeline.server",
    "track": "thrifty_tpu.pipeline.track",
    "analyze_toads": "thrifty_tpu.analysis.toads_analysis",
    "analyze_detect": "thrifty_tpu.analysis.detect_analysis",
    "analyze_beacon": "thrifty_tpu.analysis.beacon_analysis",
    "analyze_tdoa": "thrifty_tpu.analysis.tdoa_analysis",
    "template_generate": "thrifty_tpu.pipeline.template_generate",
    "template_extract": "thrifty_tpu.pipeline.template_extract",
    "gold": "thrifty_tpu.pipeline.gold_cli",
    "scope": "thrifty_tpu.pipeline.scope",
    "bench": "thrifty_tpu.pipeline.bench_cli",
    "doctor": "thrifty_tpu.pipeline.doctor",
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(HELP)
        return 1

    command = argv.pop(0)
    if command in ("help", "--help", "-h"):
        if argv:
            command, argv = argv[0], argv[1:] + ["--help"]
        else:
            print(HELP)
            return 0

    if command not in COMMANDS:
        print("thrifty-tpu: {!r} is not a command. "
              "See 'thrifty-tpu --help'.".format(command), file=sys.stderr)
        return 1

    # Wisdom analog: every command reuses previously compiled XLA
    # programs from the persistent cache (fastcard/fastcard.c:32-37).
    from thrifty_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()

    module = importlib.import_module(COMMANDS[command])
    return module._main(argv) or 0


if __name__ == "__main__":
    sys.exit(main())
