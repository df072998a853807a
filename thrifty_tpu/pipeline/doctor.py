"""``thrifty-tpu doctor``: deployment-environment check.

The analog of the reference's installation checklist
(rpi/installation.md): one command an operator runs on a fresh node to
confirm every layer under the pipeline works -- Python stack, native
host library, compile cache, and the detector program on the local
accelerator -- before wiring the node into a deployment.

Each check prints one ``ok``/``FAIL`` line; exit code 0 iff all pass.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile


def _check(results, name, fn):
    try:
        detail = fn()
        results.append((name, True, detail or ""))
    except Exception as e:  # noqa: BLE001 -- each check is a probe
        results.append((name, False, "{}: {}".format(type(e).__name__, e)))


def _versions():
    import jax
    import jaxlib
    import numpy

    return "python {}.{}.{}, numpy {}, jax {}, jaxlib {}".format(
        *sys.version_info[:3], numpy.__version__, jax.__version__,
        jaxlib.__version__)


def _devices():
    import jax

    devs = jax.devices()
    return "backend={} devices={} ({})".format(
        jax.default_backend(), len(devs),
        ", ".join(d.device_kind for d in devs[:4])
        + ("..." if len(devs) > 4 else ""))


def _native():
    import numpy as np

    from thrifty_tpu import native

    # base64 round-trip through the SWAR/AVX2 codec
    data = np.arange(96, dtype=np.uint8)
    enc = native.b64encode(data)
    dec = native.b64decode_batch([enc])
    assert dec.shape == (1, 96) and (dec[0] == data).all(), "b64 mismatch"
    # ring write/read
    ring = native.RingBuffer(256)
    ring.write(data)
    ring.close()
    assert (ring.read(96) == data).all(), "ring mismatch"
    # unfold + parallel row gather
    out = native.unfold(data, 8, 2, 4)
    assert out.shape == (4, 8), "unfold shape"
    rows = np.empty((2, 16), np.uint8)
    native.copy_rows(data, 0, rows, 16)
    assert (rows[1] == data[16:32]).all(), "copy_rows mismatch"
    return "lib loaded, b64/ring/unfold/copy_rows ok, {} threads".format(
        native.num_threads())


def _compile_cache():
    import os

    from thrifty_tpu import compile_cache

    path = compile_cache.enable_compile_cache()
    os.makedirs(path, exist_ok=True)
    probe = os.path.join(path, ".doctor-probe")
    with open(probe, "w") as f:
        f.write("ok")
    os.remove(probe)
    return path


def _detector(batch):
    import numpy as np

    from thrifty_tpu import sim
    from thrifty_tpu.dsp.detector import BatchDetector, DetectorConfig

    tpl = sim.make_template()
    cap = sim.synth_capture(num_blocks=batch, bursts_every=2,
                            template=tpl, seed=1)
    det = BatchDetector(tpl, DetectorConfig(carrier_window=(7, 110)))
    out = det(cap.blocks)
    detected = np.asarray(out["detected"])
    assert detected.any(), "no synthetic burst detected"
    return "compiled + ran, {}/{} blocks detected".format(
        int(detected.sum()), batch)


def _pipeline():
    """File-format round trip through detect -> .toad on a temp dir."""
    import os

    import numpy as np

    from thrifty_tpu import sim
    from thrifty_tpu.dsp import iq
    from thrifty_tpu.io import card, toad
    from thrifty_tpu.pipeline import detect as detect_cli

    tpl = sim.make_template()
    cap = sim.synth_capture(num_blocks=6, bursts_every=2, template=tpl,
                            seed=2)
    with tempfile.TemporaryDirectory() as d:
        np.save(os.path.join(d, "tpl.npy"), tpl)
        card.write_card(os.path.join(d, "rx.card"), cap.timestamps,
                        cap.indices, iq.iq_to_raw(cap.blocks))
        # Hermetic: an explicit empty config, or detect would pick up
        # any ambient ./detector.cfg and the probe would depend on the
        # operator's cwd (failing on a healthy node whose deployment
        # config uses a different geometry than the synthetic capture).
        cfg = os.path.join(d, "detector.cfg")
        with open(cfg, "w"):
            pass
        rc = detect_cli._main(
            [os.path.join(d, "rx.card"), "-o", os.path.join(d, "rx.toad"),
             "-c", cfg,
             "--template", os.path.join(d, "tpl.npy"), "--quiet",
             "--carrier-window", "7-110"])
        assert rc in (0, None), "detect CLI rc={}".format(rc)
        recs = toad.load_toad(os.path.join(d, "rx.toad"))
        assert len(recs) > 0, "empty .toad"
    return "card -> detect -> toad ok ({} detections)".format(len(recs))


def _main(argv=None):
    parser = argparse.ArgumentParser(
        prog="thrifty-tpu doctor",
        description="Check this node can run the full pipeline.")
    parser.add_argument("--batch", type=int, default=8,
                        help="blocks for the detector probe [8]")
    parser.add_argument("--no-device", action="store_true",
                        help="host-only checks (skip detector/pipeline)")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable output")
    args = parser.parse_args(argv)

    results = []
    _check(results, "versions", _versions)
    _check(results, "devices", _devices)
    _check(results, "native", _native)
    _check(results, "compile-cache", _compile_cache)
    if not args.no_device:
        _check(results, "detector", lambda: _detector(args.batch))
        _check(results, "pipeline", _pipeline)

    if args.json:
        print(json.dumps([{"check": n, "ok": ok, "detail": d}
                          for n, ok, d in results]))
    else:
        for name, ok, detail in results:
            print("{:14s} {}  {}".format(
                name, "ok  " if ok else "FAIL", detail))
    failed = [n for n, ok, _ in results if not ok]
    if failed and not args.json:
        print("doctor: FAILED: {}".format(", ".join(failed)),
              file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(_main())
