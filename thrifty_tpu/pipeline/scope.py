"""CLI: scope -- live time/frequency/histogram views with level triggers.

The reference's scope (thrifty/scope.py) is a GNU Radio + PyQt4 flow
graph reading directly from an osmosdr source: a time sink with an
amplitude level trigger, a complex freq (FFT) sink with a dB level
trigger, and a magnitude histogram.  This re-design keeps the
instrument but swaps the front-end: instead of binding to SDR hardware
(absent on GPU hosts), it consumes the same raw interleaved uint8 I/Q
stream every other stage uses -- a file, a FIFO fed by ``rtl_sdr``, or
stdin -- so the scope works on live pipes and on recorded captures
alike.

Views per frame (one overlap-free block of ``block_size`` samples):
time (|x|, I, Q with the time trigger level), spectrum (dB, with the
freq trigger level), sample histogram, and a scrolling waterfall.
Level triggers mirror the reference's defaults (0.4 amplitude,
-40 dB): when armed, the display only updates on blocks that cross
the level, holding the last triggered frame otherwise.

Headless operation (``--export PREFIX``) renders up to ``--frames``
triggered frames to PNG files instead of opening a window -- the mode
used in tests and over SSH.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from thrifty_tpu.config import settings as settings_mod
from thrifty_tpu.dsp import iq


class ScopeState:
    """Trigger logic + per-frame arrays for the scope views."""

    def __init__(self, block_size, sample_rate,
                 trigger_time=0.4, trigger_freq=-40.0,
                 waterfall_rows=64):
        self.block_size = block_size
        self.sample_rate = sample_rate
        self.trigger_time = trigger_time
        self.trigger_freq = trigger_freq
        self.freqs = np.fft.fftshift(
            np.fft.fftfreq(block_size, 1.0 / sample_rate))
        self.waterfall = np.full((waterfall_rows, block_size), -120.0)
        self.frame = None  # last triggered frame

    def feed(self, block):
        """Process one complex block; returns True when triggered."""
        mag = np.abs(block)
        spec = np.fft.fftshift(np.fft.fft(block))
        with np.errstate(divide="ignore"):
            spec_db = 20.0 * np.log10(np.abs(spec) / len(block) + 1e-12)
        self.waterfall = np.roll(self.waterfall, 1, axis=0)
        self.waterfall[0] = spec_db
        triggered = (mag.max() >= self.trigger_time
                     or spec_db.max() >= self.trigger_freq)
        if triggered:
            self.frame = {
                "i": block.real.copy(), "q": block.imag.copy(),
                "mag": mag, "spec_db": spec_db,
            }
        return triggered

    def render(self, fig):
        """Draw the current frame onto a matplotlib figure."""
        fig.clear()
        axes = fig.subplots(2, 2)
        (ax_t, ax_f), (ax_h, ax_w) = axes
        f = self.frame
        if f is not None:
            ax_t.plot(f["mag"], lw=0.4, label="|x|")
            ax_t.plot(f["i"], lw=0.3, alpha=0.6, label="I")
            ax_t.plot(f["q"], lw=0.3, alpha=0.6, label="Q")
            ax_f.plot(self.freqs / 1e3, f["spec_db"], lw=0.4)
            ax_h.hist(f["mag"], bins=64)
        ax_t.axhline(self.trigger_time, color="r", lw=0.6, ls="--",
                     label="trigger")
        ax_t.set_ylim(-1.2, 1.5)
        ax_t.set_title("time (amplitude)")
        ax_t.legend(loc="upper right", fontsize=6)
        ax_f.axhline(self.trigger_freq, color="r", lw=0.6, ls="--")
        ax_f.set_ylim(-120, 10)
        ax_f.set_xlabel("kHz")
        ax_f.set_title("spectrum (dB)")
        ax_h.set_title("magnitude histogram")
        ax_w.imshow(self.waterfall, aspect="auto", origin="upper",
                    vmin=-110, vmax=0,
                    extent=[self.freqs[0] / 1e3, self.freqs[-1] / 1e3,
                            len(self.waterfall), 0])
        ax_w.set_title("waterfall")
        fig.tight_layout()


def iter_blocks(stream, block_size):
    """Yield complex blocks from a raw uint8 I/Q byte stream.

    Accumulates across short reads (sockets and pipes deliver partial
    chunks routinely); a trailing partial block at EOF is dropped.
    """
    nbytes = 2 * block_size
    buf = b""
    while True:
        chunk = stream.read(nbytes - len(buf))
        if not chunk:
            return
        buf += chunk
        if len(buf) < nbytes:
            continue
        raw = np.frombuffer(buf, dtype=np.uint8)
        buf = b""
        yield iq.raw_to_iq(raw[None, :])[0]


def _main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("input", nargs="?", type=str, default="-",
                        help="raw uint8 I/Q stream: file, FIFO, or '-' "
                             "for stdin [default: -]")
    parser.add_argument("--trigger-time", type=float, default=0.4,
                        help="time-domain amplitude trigger level "
                             "[default: 0.4, reference scope.py]")
    parser.add_argument("--trigger-freq", type=float, default=-40.0,
                        help="frequency-domain trigger level in dB "
                             "[default: -40]")
    parser.add_argument("--free-run", action="store_true",
                        help="update on every block (triggers ignored)")
    parser.add_argument("--export", type=str, default=None, metavar="PREFIX",
                        help="headless: write triggered frames to "
                             "PREFIX<n>.png instead of opening a window")
    parser.add_argument("--frames", type=int, default=10,
                        help="stop after this many exported frames "
                             "[default: 10]")
    parser.add_argument("--rtl-tcp", type=str, default=None,
                        metavar="HOST[:PORT]",
                        help="scope a live rtl_tcp stream (configures "
                             "freq/sample-rate/gain on connect) -- the "
                             "role of the reference's GNU Radio "
                             "scope.grc")
    parser.add_argument("--rtlsdr", type=int, default=None, metavar="N",
                        help="scope USB RTL-SDR device N via the "
                             "in-process librtlsdr binding")
    parser.add_argument("--ppm", type=int, default=None,
                        help="crystal frequency correction in ppm "
                             "forwarded to the dongle (use the "
                             "same value as detect/capture, or the "
                             "scope shows carriers shifted by the "
                             "crystal error)")
    keys = ["sample_rate", "block_size", "tuner_freq", "tuner_gain"]
    config, args = settings_mod.load_args(parser, keys, argv=argv)

    import matplotlib
    if args.export:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    state = ScopeState(config.block_size, config.sample_rate,
                       trigger_time=args.trigger_time,
                       trigger_freq=args.trigger_freq)
    if args.free_run:
        state.trigger_time = -1.0  # every block crosses

    if args.rtlsdr is not None:
        from thrifty_tpu.io import rtlsdr as rtlsdr_mod

        in_stream = rtlsdr_mod.make_source_cli(args.rtlsdr, config,
                                               ppm=args.ppm)
        if in_stream is None:
            return 1
    elif args.rtl_tcp is not None:
        from thrifty_tpu.io import rtl_tcp as rtl_tcp_mod

        in_stream = rtl_tcp_mod.make_source_cli(args.rtl_tcp, config,
                                                ppm=args.ppm)
        if in_stream is None:
            return 1
    elif args.input == "-":
        in_stream = sys.stdin.buffer
    else:
        in_stream = open(args.input, "rb")
    blocks = iter_blocks(in_stream, config.block_size)

    try:
        if args.export:
            fig = plt.figure(figsize=(10, 7))
            count = 0
            for block in blocks:
                if count >= args.frames:  # before writing: frames=0
                    break                 # must export nothing
                if state.feed(block):
                    state.render(fig)
                    path = "{}{:04d}.png".format(args.export, count)
                    fig.savefig(path, dpi=80)
                    print("wrote", path)
                    count += 1
                    if count >= args.frames:
                        break
            if count == 0 and args.frames > 0:
                print("no blocks crossed the trigger level",
                      file=sys.stderr)
                return 1
            return 0

        # Interactive mode: animate as blocks arrive.
        plt.ion()
        fig = plt.figure(figsize=(10, 7))
        for block in blocks:
            if state.feed(block) or state.frame is not None:
                state.render(fig)
                fig.canvas.draw_idle()
                plt.pause(0.01)
            if not plt.fignum_exists(fig.number):
                break
        plt.ioff()
        if state.frame is not None:
            plt.show()
        return 0
    except KeyboardInterrupt:
        return 0
    except IOError as e:
        # Mid-stream failure (e.g. rtl_tcp stall timeout): same
        # supervisor-friendly exit as detect/capture, not a traceback.
        print("stream error: {}".format(e), file=sys.stderr)
        return 1
    finally:
        if in_stream is not sys.stdin.buffer:
            in_stream.close()


if __name__ == "__main__":
    sys.exit(_main())
