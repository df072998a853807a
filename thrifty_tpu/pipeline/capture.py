"""CLI: capture -- raw IQ stream -> carrier-gated .card archive.

This is fastcard's actual job (capture thinning): run the carrier
threshold detector over every overlap-save block of a raw uint8 I/Q
stream and archive *only the blocks that pass* as base64 ``.card``
lines (reference fastcard/fastcard_cli.c:156-196), turning a continuous
2.4 MB/s stream into a sparse, re-analyzable capture.

Batched redesign: instead of a per-block FFTW loop, blocks are
batched [B, N] and gated by one jit-compiled XLA program (uint8->complex
conversion fused into the FFT input read, batched FFT, windowed argmax +
noise + threshold).  Only the pass/fail verdicts and peak stats cross
back to the host; raw bytes of passing blocks are base64-encoded by the
native SWAR encoder.

The legacy mode (spawning an external SDR capture binary, reference
thrifty/fastcard_capture.py:35-93) remains available via --capture-cmd
when no --raw-in stream is given.
"""

from __future__ import annotations

import argparse
import shlex
import signal
import subprocess
import sys
import time as time_mod

import numpy as np

from thrifty_tpu.config import settings as settings_mod
from thrifty_tpu.config.parsers import normalize_freq_range


class CarrierGate:
    """Batched carrier-threshold gate: raw uint8 [B, 2N] -> verdicts.

    One compiled XLA program per batch shape: fused raw->complex
    conversion, batched FFT, and the reference's carrier detector
    (fastcard/cardet.c:7-41 semantics via thrifty_tpu.dsp.carrier).
    Returns per-block (detected, argmax, magnitude, noise, threshold).
    """

    def __init__(self, block_len, carrier_window, carrier_thresh,
                 history_len=None, fft_impl="auto",
                 fft_precision="highest"):
        import jax

        from thrifty_tpu.dsp import carrier, mxu_fft

        self.block_len = block_len
        self.history_len = history_len  # needed for gate_stream only
        self._mask = carrier.window_mask(carrier_window, block_len)
        self._thresh = tuple(carrier_thresh)
        self._fft_impl = fft_impl
        self._fft_precision = fft_precision
        # Windowed-DFT fast path: eligibility and numerics shared with
        # the detector's carrier stage through
        # dsp.carrier.windowed_selection/detect_windowed -- the gate
        # consumes only the windowed argmax and the Parseval energy,
        # so the full FFT + [B, N] magnitude array collapse to half a
        # four-step transform.  Off on the jnp.fft path (bit-exact
        # numerics for the golden archives) and under a stddev
        # threshold term (needs every bin's magnitude).
        self._win = carrier.windowed_selection(
            carrier_window, self._thresh, block_len, fft_impl)
        self._jit = jax.jit(self._program)
        self._stream_carry = None

    def _detect_blocks(self, blocks):
        import jax.numpy as jnp

        from thrifty_tpu.dsp import carrier, mxu_fft

        if self._win is not None:
            sel, ext = self._win
            det, idx, peak_mag, noise, thresh_sq, _, _ = \
                carrier.detect_windowed(
                    blocks, sel, ext, 0, self._thresh,
                    self._fft_impl, self._fft_precision)
            return det, idx, peak_mag, noise, jnp.sqrt(
                jnp.maximum(thresh_sq, 0.0))

        mag = jnp.abs(mxu_fft.fft(blocks, self._fft_impl,
                                  self._fft_precision))
        det, idx, peak_mag, noise = carrier.detect(
            mag, self._mask, self._thresh)
        # Report the DECISION threshold, rebuilt with the same
        # signed-variance semantics as carrier.detect (an ultra-strong
        # carrier drives the variance negative; recomputing from the
        # zero-clamped noise_rms would print a threshold ABOVE the
        # magnitude of a block that WAS detected).
        energy = jnp.sum(jnp.square(mag), axis=-1)
        _, thresh_sq = carrier.noise_and_threshold_sq(
            energy, jnp.square(peak_mag), self.block_len, self._thresh)
        d = self._thresh[2]
        if d:
            thresh_sq = thresh_sq + d * jnp.var(mag, axis=-1)
        return det, idx, peak_mag, noise, jnp.sqrt(
            jnp.maximum(thresh_sq, 0.0))

    def _program(self, raw):
        from thrifty_tpu.dsp import iq

        return self._detect_blocks(iq.raw_to_iq_jax(raw))

    def _program_stream(self, new_u16, carry):
        from thrifty_tpu.dsp import iq
        from thrifty_tpu.dsp.unfold import unfold_stream

        rows, new_carry = unfold_stream(new_u16, carry,
                                        self.block_len,
                                        self.history_len)
        return self._detect_blocks(iq.u16_to_iq_jax(rows)), new_carry

    def __call__(self, raw):
        import jax.numpy as jnp

        return self._jit(jnp.asarray(raw))

    def gate_stream(self, new_raw):
        """Gate CONTIGUOUS raw stream bytes uint8 [B*2*new_len]; the
        overlap-save unfold runs on device against a device-resident
        carry (pre-stream history = 0x80 zero-signal bytes).  The
        carry protocol is the detector's own (`dsp.unfold.StreamCarry`),
        so gate and detect numerics share one convention."""
        import jax

        if self.history_len is None:
            raise ValueError("gate_stream needs history_len")
        if not hasattr(self, "_stream_jit"):
            self._stream_jit = jax.jit(self._program_stream)
        if self._stream_carry is None:
            from thrifty_tpu.dsp.unfold import StreamCarry
            self._stream_carry = StreamCarry(self.history_len)
        # new_len validation: a partial trailing block would be
        # silently dropped by the device unfold while the carry
        # advanced past it (callers must pad, like record_cards does).
        return self._stream_carry.call(
            self._stream_jit, new_raw,
            new_len=self.block_len - self.history_len)

    def reset_stream(self):
        """Reset the :meth:`gate_stream` carry to the pre-stream state
        (reuse the gate on a new stream)."""
        if self._stream_carry is not None:
            self._stream_carry.reset()


def card_header(config, window, tool="thrifty-tpu capture", sdr=False,
                t0=None):
    """Reference-format .card header (fastcard/fargs.c:194-214).

    ``t0``: deterministic stream start time; when given it is used as
    start_time (instead of the wall clock) so re-recording the same
    stream yields byte-identical archives.
    """
    c, s, _ = config.carrier_threshold
    lines = [
        "arguments: {{ carrier_bin: '{}-{}', threshold: '{:g}c+{:g}s', "
        "block_size: {}, history_size: {} }}".format(
            window[0], window[1], c, s,
            config.block_size, config.block_history),
    ]
    if sdr:
        lines.append("tuner: {{ freq: {}; sample_rate: {}; gain: {} }}"
                     .format(int(config.tuner_freq),
                             int(config.sample_rate), config.tuner_gain))
    lines.append("tool: '{}'".format(tool))
    lines.append("start_time: {:.6f}".format(
        time_mod.time() if t0 is None else t0))
    return "\n".join(lines)


def record_cards(gate, batches, batch_size, out_stream, info_out=None,
                 skip=0, stats=None, device_unfold=False):
    """Drive the gate over raw batches, writing .card lines for hits.

    ``batches`` yields (timestamps [b], indices [b], raw [b, 2N]).
    The first ``skip`` blocks are discarded (SDR settling, reference
    fastcard_cli.c:148-171) and the surviving blocks are RENUMBERED so
    the first kept block continues from index 0 -- the reference
    initializes the block counter to ``-skip - 1`` (fastcard.c:108-109),
    so stream chunk k is archived as index k - skip (cross-validated
    against the compiled fastcard in tests/test_golden_fastdet.py).
    Keeps one batch in flight so host IO and
    base64 encoding overlap device compute.  Returns (blocks_read,
    blocks_written); pass a ``stats`` dict to see the running counts
    even when the stream dies mid-run (the at-exit summary must
    reflect what actually reached the archive, not zeros).
    """
    from thrifty_tpu.io import card as card_io

    pending = []
    if stats is None:
        stats = {}
    stats.update(read=0, written=0)
    if device_unfold:
        from numpy.lib.stride_tricks import as_strided

        hist_bytes = 2 * gate.history_len
        new_bytes = 2 * (gate.block_len - gate.history_len)
        # Host-side tail of the previous batch: only HIT rows are
        # materialized, cut out of [prev_tail | new bytes].
        host_tail = np.full(hist_bytes, 128, np.uint8)

    def drain(entry):
        ts, idx, n, raw, tail, dev = entry
        det, amax, mag, noise, thr = (np.asarray(a)[:n] for a in dev)
        keep = det & (idx >= skip)
        idx = idx - skip
        stats["read"] += n
        if info_out is not None:
            for i in np.nonzero(keep)[0]:
                print("block #{}: mag[{}] = {:.1f} (thresh = {:.1f}, "
                      "noise = {:.1f})".format(
                          int(idx[i]), int(amax[i]), float(mag[i]),
                          float(thr[i]), float(noise[i])), file=info_out)
        if np.any(keep):
            if device_unfold:
                full = np.concatenate([tail, raw[:n * new_bytes]])
                rows = as_strided(
                    full, (n, hist_bytes + new_bytes), (new_bytes, 1))
                rows = rows[keep]  # fancy index copies the hit rows
            else:
                rows = raw[:n][keep]
            card_io.write_card(out_stream, ts[keep], idx[keep], rows)
            out_stream.flush()
            stats["written"] += int(np.count_nonzero(keep))

    try:
        for ts, idx, raw in batches:
            n = len(ts)
            if n == 0:
                continue
            if device_unfold:
                if n < batch_size:
                    raw = np.concatenate(
                        [raw, np.full((batch_size - n) * new_bytes,
                                      128, np.uint8)])
                dev = gate.gate_stream(raw)  # async dispatch
                # raw stays valid while <= BUF_POOL-1 further batches
                # are drawn (StreamPump contract); pending holds one.
                valid = raw[:n * new_bytes]
                prev_tail, host_tail = host_tail, (
                    valid[-hist_bytes:].copy()
                    if len(valid) >= hist_bytes else np.concatenate(
                        [host_tail, valid])[-hist_bytes:])
                pending.append((ts, idx, n, valid, prev_tail, dev))
            else:
                if n < batch_size:
                    pad = batch_size - n
                    raw = np.concatenate(
                        [raw, np.full((pad, raw.shape[1]), 128,
                                      np.uint8)])
                dev = gate(raw)  # async dispatch
                pending.append((ts, idx, n, raw, None, dev))
            if len(pending) > 1:
                drain(pending.pop(0))
    except (IOError, KeyboardInterrupt):
        # Stream died or SIGTERM/SIGINT arrived: flush gated blocks
        # already in flight before surfacing, so the archive keeps
        # everything that reached the host -- SIGTERM is how every
        # live run under a supervisor normally ends, and one batch is
        # in flight by design.
        while pending:
            drain(pending.pop(0))
        raise
    while pending:
        drain(pending.pop(0))
    return stats["read"], stats["written"]


def build_args(config, output=None):
    """Translate settings into fastcard-style CLI flags."""
    window = normalize_freq_range(
        config.carrier_window, config.sample_rate / config.block_size)
    thresh_c, thresh_s, thresh_d = config.carrier_threshold
    if thresh_d:
        print("warning: stddev threshold not supported by capture backends",
              file=sys.stderr)
    args = [
        "-i", "rtlsdr",
        "-s", str(config.sample_rate),
        "-f", str(config.tuner_freq),
        "-g", str(config.tuner_gain),
        "-b", str(config.block_size),
        "-h", str(config.block_history),
        "-w", "{}-{}".format(window[0], window[1]),
        "-t", "{}c{}s".format(thresh_c, thresh_s),
        "-k", str(config.capture_skip),
    ]
    if output:
        args += ["-o", output]
    return args


def _record_main(config, args):
    """The native carrier-gated raw -> .card recorder path."""
    window = normalize_freq_range(
        config.carrier_window, config.sample_rate / config.block_size)
    gate = CarrierGate(config.block_size, window, config.carrier_threshold,
                       history_len=config.block_history,
                       fft_impl=args.fft_impl)
    device_unfold = bool(getattr(args, "device_unfold", False))

    sdr = False
    if getattr(args, "rtlsdr", None) is not None:
        from thrifty_tpu.io import rtlsdr as rtlsdr_mod

        in_stream = rtlsdr_mod.make_source_cli(
            args.rtlsdr, config,
            bias_tee=getattr(args, "bias_tee", False), quiet=args.quiet,
            ppm=getattr(args, "ppm", None))
        if in_stream is None:
            return 1
        sdr = True
    elif getattr(args, "rtl_tcp", None):
        from thrifty_tpu.io import rtl_tcp as rtl_tcp_mod

        in_stream = rtl_tcp_mod.make_source_cli(
            args.rtl_tcp, config,
            bias_tee=getattr(args, "bias_tee", False),
            reconnect=getattr(args, "reconnect", 0), quiet=args.quiet,
            ppm=getattr(args, "ppm", None))
        if in_stream is None:
            return 1
        sdr = True
    elif args.raw_in == "-":
        in_stream = sys.stdin.buffer
    else:
        in_stream = open(args.raw_in, "rb")
    if args.output and args.output != "-":
        out_stream, close_out = open(args.output, "w"), True
    else:
        out_stream, close_out = sys.stdout, False
    info_out = sys.stderr if out_stream is sys.stdout else sys.stdout
    if args.quiet:
        info_out = None

    out_stream.write("# " + card_header(config, window, sdr=sdr,
                                        t0=args.t0).replace(
        "\n", "\n# ") + "\n")

    try:
        from thrifty_tpu.io.stream import StreamPump
        pump = StreamPump(in_stream, config.block_size,
                          config.block_history, config.batch_size,
                          sample_rate=config.sample_rate, t0=args.t0)
        batches = (pump.batches_contiguous() if device_unfold
                   else pump.batches())
    except ImportError:
        from thrifty_tpu.io import blocks as blocks_io
        pump = None
        if device_unfold:
            print("warning: native lib unavailable; --device-unfold "
                  "falling back to host unfold", file=sys.stderr)
            device_unfold = False
        stamper = None if args.t0 is None else \
            blocks_io.make_t0_stamper(
                args.t0, config.block_size, config.block_history,
                config.sample_rate)
        batches = blocks_io.raw_batches(
            in_stream, config.block_size, config.block_history,
            config.batch_size, timestamper=stamper)

    def _terminate(signum, frame):
        raise KeyboardInterrupt

    try:
        signal.signal(signal.SIGTERM, _terminate)
    except ValueError:
        pass  # not the main thread

    exit_code = 0
    t_start = time_mod.perf_counter()
    stats = {"read": 0, "written": 0}
    try:
        record_cards(
            gate, batches, config.batch_size, out_stream,
            info_out=info_out, skip=config.capture_skip, stats=stats,
            device_unfold=device_unfold)
    except KeyboardInterrupt:
        print("interrupted; output flushed", file=sys.stderr)
    except IOError as e:
        # Live stream died (e.g. rtl_tcp reconnect retries exhausted):
        # flush, report, exit non-zero so a supervisor restarts us.
        print("stream error: {}; output flushed".format(e),
              file=sys.stderr)
        exit_code = 1
    finally:
        if close_out:
            out_stream.close()
        if in_stream is not sys.stdin.buffer:
            in_stream.close()
    elapsed = time_mod.perf_counter() - t_start
    if info_out is not None:
        new_len = config.block_size - config.block_history
        rate = stats["read"] * new_len / max(elapsed, 1e-9)
        print("\nRead {} blocks, wrote {} ({:.1f}x realtime @ {:.1f} Msps)"
              .format(stats["read"], stats["written"],
                      rate / config.sample_rate,
                      config.sample_rate / 1e6), file=info_out)
        if pump is not None:
            print(pump.stats_line(), file=info_out)
        if hasattr(in_stream, "stats_line"):
            # USB source's at-exit ring report (the reference's
            # rtlsdr_reader_print_histogram, rtlsdr_reader.c:310-325).
            print(in_stream.stats_line(), file=info_out)
    if pump is not None:
        pump.close()
    return exit_code


def _main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--raw-in", type=str, default=None,
                        help="raw interleaved uint8 I/Q stream to gate "
                             "natively ('-' for stdin); without this, an "
                             "external capture binary is spawned")
    parser.add_argument("-o", "--output", type=str, default=None,
                        help="output .card file ('-'/default: stdout in "
                             "--raw-in mode)")
    parser.add_argument("--device-unfold", action="store_true",
                        help="carrier-gate the contiguous stream with "
                             "the overlap-save unfold on device; only "
                             "HIT rows are materialized on the host")
    parser.add_argument("--quiet", action="store_true",
                        help="suppress per-block detection lines")
    parser.add_argument("--t0", type=float, default=None,
                        help="stamp blocks deterministically as "
                             "t0 + block_idx*block_dt instead of the "
                             "wall clock (re-analyzing recorded raw "
                             "streams with a known start time)")
    parser.add_argument("--rtl-tcp", type=str, default=None,
                        metavar="HOST[:PORT]",
                        help="capture live from an rtl_tcp server "
                             "(configures freq/sample-rate/gain on "
                             "connect; the network replacement for the "
                             "reference's in-process librtlsdr binding)")
    parser.add_argument("--rtlsdr", type=int, default=None, metavar="N",
                        help="capture live from USB RTL-SDR device N via "
                             "the in-process librtlsdr binding "
                             "(async USB thread -> ring, nearest gain "
                             "from the device's own table; the "
                             "reference's fastcard/rtlsdr_reader.c)")
    parser.add_argument("--ppm", type=int, default=None,
                        help="crystal frequency correction in ppm "
                             "forwarded to the rtl_tcp dongle")
    parser.add_argument("--bias-tee", action="store_true",
                        help="with --rtl-tcp/--rtlsdr: enable the dongle's "
                             "bias tee (antenna power)")
    parser.add_argument("--reconnect", type=int, default=0, metavar="N",
                        help="with --rtl-tcp: survive server restarts, "
                             "retrying up to N times with exponential "
                             "backoff [default: 0 = exit on disconnect]")
    parser.add_argument("--fft-impl", type=str, default="auto",
                        choices=["auto", "matmul", "matmul3", "xla"],
                        help="FFT implementation for the carrier gate "
                             "(dsp/mxu_fft.py; 'auto' = jnp.fft; "
                             "'matmul' adds the windowed-DFT gate) "
                             "[default: auto]")
    parser.add_argument("--capture-cmd", type=str, default="fastcard",
                        help="capture binary to spawn [default: fastcard]")
    keys = ["sample_rate", "tuner_freq", "tuner_gain", "block_size",
            "block_history", "carrier_window", "carrier_threshold",
            "capture_skip", "batch_size"]
    config, args = settings_mod.load_args(parser, keys, argv=argv)

    given = [o for o, v in (("--raw-in", args.raw_in),
                            ("--rtl-tcp", args.rtl_tcp),
                            ("--rtlsdr", args.rtlsdr)) if v is not None]
    if len(given) > 1:
        parser.error("give only one of {}".format(" / ".join(given)))
    if given:
        return _record_main(config, args)

    cmd = shlex.split(args.capture_cmd) + build_args(config, args.output)
    print("capture:", " ".join(cmd), file=sys.stderr)
    try:
        proc = subprocess.Popen(cmd)
    except FileNotFoundError:
        print("error: capture binary {!r} not found (SDR capture requires "
              "external hardware support)".format(cmd[0]), file=sys.stderr)
        return 1

    def forward(signum, frame):
        proc.send_signal(signal.SIGTERM)

    signal.signal(signal.SIGINT, forward)
    signal.signal(signal.SIGTERM, forward)
    return proc.wait()


if __name__ == "__main__":
    sys.exit(_main())
