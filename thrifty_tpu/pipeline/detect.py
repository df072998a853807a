"""Streaming detect driver + CLI: .card / raw IQ -> .toad.

The host-side pump around the batched device detector: read fixed-size
batches of blocks, upload, detect, and serialize detections.  JAX's
async dispatch overlaps host IO/decode of batch k+1 with device compute
of batch k (the replacement for fastcard's producer/consumer ring
buffer, fastcard/circbuf.c); batches are padded to a static shape
so the program compiles exactly once.

CLI mirrors the reference's ``thrifty detect`` (thrifty/detect.py:
161-223): same config keys, same .toad output, same per-block summary
lines.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from thrifty_tpu.config import settings as settings_mod
from thrifty_tpu.config.parsers import normalize_freq_range
from thrifty_tpu.dsp import util
from thrifty_tpu.dsp.detector import BatchDetector, DetectorConfig
from thrifty_tpu.io import blocks as blocks_io
from thrifty_tpu.io import tpl as tpl_io
from thrifty_tpu.io import card, toad


class SummaryFormatter:
    """One-line per-block summary (reference thrifty/detect.py:103-158)."""

    def __init__(self, sample_rate, block_len):
        self.sample_rate = sample_rate
        self.block_len = block_len

    def __call__(self, block_idx, out, i):
        bin_idx = int(out["carrier_bin"][i])
        offset = float(out["carrier_offset"][i])
        freq = (util.fft_bin(bin_idx, self.block_len) + offset) \
            * self.sample_rate / self.block_len
        carrier_det = bool(out["carrier_detect"][i])
        snr = util.snr_db(float(out["carrier_energy"][i]),
                          float(out["carrier_noise"][i]))
        line = ("blk={blk}; carrier: {det} @ {freq:.3f} kHz"
                " / {idx:>3.0f}:{off:+.2f}, "
                "SNR = {ampl:>4.0f} / {noise:>2.0f} = {snr:>5.2f} dB"
                .format(blk=block_idx, det="yes" if carrier_det else "no ",
                        freq=freq / 1e3, idx=bin_idx, off=offset,
                        ampl=float(out["carrier_energy"][i]),
                        noise=float(out["carrier_noise"][i]), snr=snr))
        if carrier_det:
            det = bool(out["detected"][i])
            snr = util.snr_db(float(out["corr_energy"][i]),
                              float(out["corr_noise"][i]))
            line += ("; corr: {det} @ {idx:>4}{off:+.3f}"
                     ", SNR = {ampl:>4.0f}/{noise:>2.0f} = {snr:>5.2f} dB"
                     .format(det="yes" if det else "no ",
                             idx=int(out["corr_sample"][i]),
                             off=float(out["corr_offset"][i]),
                             ampl=float(out["corr_energy"][i]),
                             noise=float(out["corr_noise"][i]), snr=snr))
        return line


def detect_batches(detector, batches, batch_size, rxid=-1,
                   summary=None, summary_out=None,
                   txid_from_template=False, card_out=None,
                   device_unfold=False):
    """Run the detector over an iterator of (ts, idx, raw) batches.

    Yields detection record arrays (toad.DETECTION_DTYPE) per batch.
    Batches shorter than ``batch_size`` are padded (and the padding
    masked out), keeping the compiled program's shape static.
    ``card_out``: optional stream teeing the raw bytes of corr-detected
    blocks as .card lines (reference fastdet/fastdet.cpp:210-219) --
    the fused capture+detect path's sparse archive.
    ``device_unfold``: batches carry CONTIGUOUS new stream bytes
    ([n*2*new_len], from ``StreamPump.batches_contiguous``) and the
    overlap-save unfold runs on device against a device-resident
    carry (``detector.detect_raw_stream``); incompatible with
    ``card_out`` (overlap-save rows are never materialized on host).
    """
    if device_unfold and card_out is not None:
        raise ValueError("card_out needs host-side overlap-save rows; "
                         "incompatible with device_unfold")
    pending = []  # [(ts, idx, n_valid, raw, device_out)]

    def drain(entry):
        ts, idx, n, raw, dev_out = entry
        out = {k: np.asarray(v)[:n] for k, v in dev_out.items()}
        soa = detector.soa(idx, out["corr_sample"], out["corr_offset"])
        if summary is not None and summary_out is not None:
            for i in range(n):
                print(summary(int(idx[i]), out, i), file=summary_out)
        if card_out is not None and np.any(out["detected"]):
            keep = out["detected"]
            card.write_card(card_out, ts[keep], idx[keep], raw[:n][keep])
            card_out.flush()
        return toad.from_detector_output(
            ts, idx, soa, out, rxid=rxid,
            txid_from_template=txid_from_template)

    try:
        for ts, idx, raw in batches:
            n = len(ts)
            if n == 0:  # a batch can be all-junk rows
                continue
            if device_unfold:
                if n < batch_size:
                    raw = np.concatenate(
                        [raw, np.full((batch_size - n)
                                      * 2 * detector.new_len,
                                      128, np.uint8)])
                # Upload contiguous new bytes only (no repeated
                # history, 1.43x less transfer); the unfold is an
                # on-device gather.
                dev_out = detector.detect_raw_stream(raw)
            else:
                if n < batch_size:
                    pad = batch_size - n
                    raw = np.concatenate(
                        [raw, np.full((pad, raw.shape[1]), 128,
                                      np.uint8)])
                # Upload raw uint8 (2 B/sample); conversion runs on
                # device, fused into the first FFT's input read.
                dev_out = detector.detect_raw(raw)  # async dispatch
            pending.append((ts, idx, n, raw, dev_out))
            # Keep one batch in flight: overlap host decode with device
            # work.
            if len(pending) > 1:
                yield drain(pending.pop(0))
    except (IOError, KeyboardInterrupt):
        # The stream died (e.g. live SDR gone for good) or SIGTERM/
        # SIGINT arrived: results already detected on device must
        # still reach the output before the exception surfaces --
        # SIGTERM is how every live run under a supervisor ends, and
        # one batch is in flight by design.
        while pending:
            yield drain(pending.pop(0))
        raise
    while pending:
        yield drain(pending.pop(0))


def _main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("input", type=str, nargs="?", default="-",
                        help="input .card file ('-' streams from stdin)")
    parser.add_argument("--raw", action="store_true",
                        help="input is raw interleaved uint8 I/Q")
    parser.add_argument("--rtl-tcp", type=str, default=None,
                        metavar="HOST[:PORT]",
                        help="detect live from an rtl_tcp server "
                             "(implies --raw; configures freq/"
                             "sample-rate/gain on connect)")
    parser.add_argument("--rtlsdr", type=int, default=None, metavar="N",
                        help="detect live from USB RTL-SDR device N via "
                             "the in-process librtlsdr binding (implies "
                             "--raw; the reference's "
                             "fastcard/rtlsdr_reader.c role)")
    parser.add_argument("--ppm", type=int, default=None,
                        help="crystal frequency correction in ppm "
                             "forwarded to the dongle")
    parser.add_argument("--bias-tee", action="store_true",
                        help="with --rtl-tcp/--rtlsdr: enable the dongle's "
                             "bias tee (antenna power)")
    parser.add_argument("--reconnect", type=int, default=0, metavar="N",
                        help="with --rtl-tcp: survive server restarts, "
                             "retrying up to N times with exponential "
                             "backoff [default: 0 = exit on disconnect]")
    parser.add_argument("--t0", type=float, default=None,
                        help="with --raw: stamp blocks deterministically "
                             "as t0 + block_idx*block_dt instead of the "
                             "wall clock (recorded streams with a known "
                             "start time)")
    parser.add_argument("--device-unfold", action="store_true",
                        help="ship the contiguous raw stream to the "
                             "device and overlap-save there (1.43x "
                             "less host->device transfer, no host "
                             "unfold copy); raw/rtl_tcp inputs only, "
                             "incompatible with --card-out/--skip")
    parser.add_argument("-k", "--skip", type=int, default=0,
                        metavar="N",
                        help="with --raw/--rtl-tcp: discard the first N "
                             "blocks (SDR settling) and renumber the "
                             "survivors from 0, like fastdet "
                             "(fastcard.c:108-109; ignored for .card "
                             "input, which the reference also forces to "
                             "skip=0) [default: 0 -- fastdet defaults "
                             "to 1, but recorded raw streams should "
                             "not lose data silently]")
    parser.add_argument("--quiet", action="store_true",
                        help="do not print per-block summary lines")
    group = parser.add_mutually_exclusive_group()
    group.add_argument("-o", "--output", type=str,
                       help="output .toad file ('-' for stdout)")
    group.add_argument("-a", "--append", type=str,
                       help="output .toad file to append to")
    parser.add_argument("--corr-interp", type=str, default="gaussian",
                        choices=["gaussian", "parabolic", "cosine",
                                 "autocorr", "none", "maximise"],
                        help="sub-sample correlation-peak interpolator "
                             "(the reference's experimental set, "
                             "batched) [default: gaussian]")
    parser.add_argument("--carrier-interp", type=str, default="auto",
                        choices=["auto", "dirichlet", "parabolic",
                                 "polyfit", "gaussian", "cosine", "none"],
                        help="sub-bin carrier interpolator [default: "
                             "auto = dirichlet, or parabolic in integer "
                             "sync mode]")
    parser.add_argument("--fft-impl", type=str, default="auto",
                        choices=["auto", "matmul", "matmul3", "xla"],
                        help="FFT implementation [default: auto = "
                             "jnp.fft (cuFFT on the GPU); matmul = "
                             "four-step DFT-as-matmul transforms]")
    parser.add_argument("--fft-precision", type=str, default="highest",
                        choices=["highest", "high", "default"],
                        help="matmul-FFT contraction precision: 'high' "
                             "and 'default' allow TF32 on the GPU "
                             "[default: highest = full float32]")
    parser.add_argument("--carrier-fast", type=str, default="auto",
                        choices=["auto", "off"],
                        help="windowed-carrier fast path: 'off' "
                             "forces the full-FFT carrier stage "
                             "[default: auto = on when eligible]")
    parser.add_argument("--carrier-precision", type=str, default="auto",
                        choices=["auto", "highest", "high", "default"],
                        help="matmul precision for the CARRIER "
                             "transform only (fractional sync; 'high' "
                             "allows TF32 on the GPU) [default: auto = "
                             "follow --fft-precision]")
    parser.add_argument("--ramp-fast", type=str, default="auto",
                        choices=["auto", "off"],
                        help="separable fractional-sync ramp fused "
                             "into the matmul FFT: 'off' forces the "
                             "explicit full-ramp product [default: "
                             "auto = on under the matmul impl]")
    parser.add_argument("--gate-capacity", type=int, default=0,
                        metavar="C",
                        help="carrier-gated correlation compaction: "
                             "run the correlation stages on at most C "
                             "carrier-positive blocks per batch "
                             "(exact; in-program full-batch fallback "
                             "on overflow -- the reference's own "
                             "carrier-conditional dataflow, "
                             "thrifty/detect.py:64-71).  Size C above "
                             "the expected carrier blocks per batch, "
                             "e.g. batch/2 at <=25%% duty "
                             "[default: 0 = off]")
    parser.add_argument("--peak-filter", type=int, default=0,
                        metavar="LEN",
                        help="Dirichlet matched filter length for the "
                             "carrier peak search (-1 = auto width, "
                             "0 = off) [default: 0]")
    parser.add_argument("--card-out", type=str, default=None,
                        help="tee corr-detected blocks to this .card file "
                             "(the fastdet-style sparse capture archive)")
    parser.add_argument("--emit-txid", action="store_true",
                        help="write .toads lines with txid taken from the "
                             "winning template of a template bank (the "
                             "template file must hold a [T, L] array)")

    keys = ["sample_rate", "block_size", "block_history", "carrier_window",
            "carrier_threshold", "corr_threshold", "template", "rxid",
            "batch_size", "sync_mode", "tuner_freq", "tuner_gain"]
    config, args = settings_mod.load_args(parser, keys, argv=argv)

    # Usage errors before any expensive setup (template load, detector
    # construction) so conflicts surface instantly.
    if args.rtl_tcp is not None and args.rtlsdr is not None:
        parser.error("give either --rtl-tcp or --rtlsdr, not both")
    live = args.rtl_tcp if args.rtl_tcp is not None else args.rtlsdr
    if live is not None and args.input != "-":
        parser.error("give either an input file or a live SDR source, "
                     "not both")
    if args.device_unfold:
        if not args.raw and live is None:
            parser.error("--device-unfold needs a raw stream input "
                         "(--raw, --rtl-tcp or --rtlsdr); .card input "
                         "decodes to overlap-save rows already")
        if args.card_out:
            parser.error("--card-out needs host-side overlap-save "
                         "rows; incompatible with --device-unfold")
        if args.skip > 0:
            parser.error("--skip filters host-side rows; incompatible "
                         "with --device-unfold")

    template = tpl_io.load_template(config.template)
    if args.emit_txid and template.ndim != 2:
        parser.error("--emit-txid requires a template bank "
                     "(a 2-D [T, L] .npy array)")
    bin_freq = config.sample_rate / config.block_size
    window = normalize_freq_range(config.carrier_window, bin_freq)

    detector = BatchDetector(template, DetectorConfig(
        block_len=config.block_size,
        history_len=config.block_history,
        carrier_thresh=config.carrier_threshold,
        carrier_window=window,
        corr_thresh=config.corr_threshold,
        sync_mode=config.sync_mode,
        corr_interp=args.corr_interp,
        carrier_interp=args.carrier_interp,
        peak_filter_len=args.peak_filter,
        fft_impl=args.fft_impl,
        fft_precision=args.fft_precision,
        carrier_fast=args.carrier_fast,
        carrier_precision=args.carrier_precision,
        ramp_fast=args.ramp_fast,
        gate_capacity=args.gate_capacity,
    ))

    if args.rtlsdr is not None:
        from thrifty_tpu.io import rtlsdr as rtlsdr_mod

        in_stream = rtlsdr_mod.make_source_cli(
            args.rtlsdr, config, bias_tee=args.bias_tee,
            quiet=args.quiet, ppm=args.ppm)
        if in_stream is None:
            return 1
        args.raw = True
    elif args.rtl_tcp is not None:
        from thrifty_tpu.io import rtl_tcp as rtl_tcp_mod

        in_stream = rtl_tcp_mod.make_source_cli(
            args.rtl_tcp, config, bias_tee=args.bias_tee,
            reconnect=args.reconnect, quiet=args.quiet, ppm=args.ppm)
        if in_stream is None:
            return 1
        args.raw = True
    elif args.input == "-":
        in_stream = sys.stdin.buffer
    else:
        in_stream = open(args.input, "rb")
    pump = None
    if args.raw:
        try:
            from thrifty_tpu.io.stream import StreamPump
            pump = StreamPump(in_stream, config.block_size,
                              config.block_history, config.batch_size,
                              sample_rate=config.sample_rate, t0=args.t0)
            batches = (pump.batches_contiguous() if args.device_unfold
                       else pump.batches())
        except ImportError:
            if args.device_unfold:
                print("warning: native lib unavailable; --device-unfold "
                      "falling back to host unfold", file=sys.stderr)
                args.device_unfold = False
            stamper = None if args.t0 is None else \
                blocks_io.make_t0_stamper(
                    args.t0, config.block_size, config.block_history,
                    config.sample_rate)
            batches = blocks_io.raw_batches(
                in_stream, config.block_size, config.block_history,
                config.batch_size, timestamper=stamper)
    else:
        batches = card.iter_card_batches(in_stream, config.batch_size)
        try:
            # Parse/decode batches in a background thread so host IO
            # overlaps device compute.
            from thrifty_tpu.io.stream import prefetch_iter
            batches = prefetch_iter(batches, depth=2)
        except ImportError:
            pass

    if args.output == "-":
        out_stream, close_out = sys.stdout, False
    elif args.output:
        out_stream, close_out = open(args.output, "w"), True
    elif args.append:
        out_stream, close_out = open(args.append, "a"), True
    else:
        out_stream, close_out = None, False
    info_out = sys.stderr if out_stream is sys.stdout else sys.stdout

    summary = None if args.quiet else SummaryFormatter(
        config.sample_rate, config.block_size)

    card_out = open(args.card_out, "w") if args.card_out else None

    import signal
    import time as time_mod

    # Convert SIGTERM into a normal exit so open .toad output is flushed
    # and the stats report prints (cf. the reference's clean signal
    # handling, fastcard/fastcard_cli.c:138-141).
    def _terminate(signum, frame):
        raise KeyboardInterrupt

    try:
        signal.signal(signal.SIGTERM, _terminate)
    except ValueError:
        pass  # not the main thread (e.g. under a test harness)

    num = 0
    counter = {"blocks": 0}

    def counted(batch_iter):
        for ts, idx, raw in batch_iter:
            counter["blocks"] += len(ts)
            yield ts, idx, raw

    if args.raw and args.skip > 0:
        def skipped(batch_iter, skip=args.skip):
            # fastdet semantics: first `skip` blocks discarded, block
            # counter starts at -skip-1 so chunk k becomes index
            # k - skip (fastcard.c:108-109).
            for ts, idx, raw in batch_iter:
                keep = idx >= skip
                if not np.all(keep):
                    if not np.any(keep):
                        continue
                    ts, idx, raw = ts[keep], idx[keep], raw[keep]
                yield ts, idx - skip, raw
        batches = skipped(batches)

    exit_code = 0
    t_start = time_mod.perf_counter()
    try:
        for records in detect_batches(
                detector, counted(batches), config.batch_size,
                rxid=config.rxid, summary=summary, summary_out=info_out,
                txid_from_template=args.emit_txid, card_out=card_out,
                device_unfold=args.device_unfold):
            num += len(records)
            if out_stream is not None:
                toad.save(out_stream, records, with_txid=args.emit_txid)
                out_stream.flush()
    except KeyboardInterrupt:
        print("interrupted; output flushed", file=sys.stderr)
    except IOError as e:
        # A live stream has no legitimate end (e.g. rtl_tcp reconnect
        # retries exhausted): flush what we have, report, exit non-zero
        # so a supervisor (systemd) restarts the capture.
        print("stream error: {}; output flushed".format(e),
              file=sys.stderr)
        exit_code = 1
    finally:
        if close_out:
            out_stream.close()
        if card_out is not None:
            card_out.close()
        if in_stream is not sys.stdin.buffer:
            in_stream.close()
    elapsed = time_mod.perf_counter() - t_start
    if not args.quiet:
        print("{} detections".format(num), file=info_out)
        rate = counter["blocks"] * detector.new_len / max(elapsed, 1e-9)
        print("throughput: {:.0f} blocks in {:.2f} s = {:.3g} IQ samples/s "
              "({:.1f}x realtime @ {:.1f} Msps)".format(
                  counter["blocks"], elapsed, rate,
                  rate / config.sample_rate,
                  config.sample_rate / 1e6), file=info_out)
        if pump is not None:
            # Real-time margin report (cf. fastcard's at-exit stats).
            print(pump.stats_line(), file=info_out)
        if hasattr(in_stream, "stats_line"):
            # USB ring occupancy/overflow report
            # (rtlsdr_reader.c:310-325).
            print(in_stream.stats_line(), file=info_out)
    if pump is not None:
        pump.close()
    return exit_code


if __name__ == "__main__":
    sys.exit(_main())
