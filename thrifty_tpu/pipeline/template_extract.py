"""CLI: extract a matched-filter template from captured data.

Finds the strongest well-centred detection in a capture, removes the
carrier from that block, and cuts/normalizes the OOK envelope into a
bipolar template (reference thrifty/template_extract.py:36-58).
"""

from __future__ import annotations

import sys
import argparse

import numpy as np

from thrifty_tpu.config import settings as settings_mod
from thrifty_tpu.config.parsers import normalize_freq_range
from thrifty_tpu.dsp.detector import BatchDetector, DetectorConfig
from thrifty_tpu.io import card
from thrifty_tpu.io import tpl as tpl_io

MAX_OFFSET = 0.2


def best_detection(out, max_offset=MAX_OFFSET):
    """Index of the strongest detection with |offset| <= max_offset."""
    ok = np.asarray(out["detected"]) \
        & (np.abs(np.asarray(out["corr_offset"])) <= max_offset)
    if not np.any(ok):
        return None
    energy = np.where(ok, np.asarray(out["corr_energy"]), -np.inf)
    return int(np.argmax(energy))


def shifted_time_signal(block, shift_bins):
    """Remove the carrier from one block (time domain, host float64)."""
    n = len(block)
    freqs = np.arange(n) / n - 0.5
    return block * np.exp(2j * np.pi * shift_bins * freqs)


def extract_template(signal, start, template_len):
    """Cut the code portion and normalize OOK -> zero-mean bipolar."""
    cut = np.abs(signal[start:start + template_len])
    cut = cut * 2.0 / (np.mean(cut) + np.std(cut))
    return cut - np.mean(cut)


def _main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("input", type=str, help="input .card file")
    parser.add_argument("-o", "--output", type=str, default="capture.npy",
                        help="output file (.npy) [default: capture.npy]")
    parser.add_argument("-p", "--plot", nargs="?",
                        const="template_extract.png", default=None,
                        metavar="FILE",
                        help="save an extracted-vs-base template overlay "
                             "(reference template_extract.py:61-72; "
                             "written to FILE -- GPU hosts are headless)")
    keys = ["sample_rate", "block_size", "block_history", "carrier_window",
            "carrier_threshold", "corr_threshold", "template"]
    config, args = settings_mod.load_args(parser, keys, argv=argv)

    base_template = tpl_io.load_template(config.template)
    window = normalize_freq_range(
        config.carrier_window, config.sample_rate / config.block_size)
    detector = BatchDetector(base_template, DetectorConfig(
        block_len=config.block_size, history_len=config.block_history,
        carrier_thresh=config.carrier_threshold, carrier_window=window,
        corr_thresh=config.corr_threshold))

    ts, idx, blocks = card.read_card_blocks(args.input)
    out = {k: np.asarray(v) for k, v in detector(blocks).items()}
    best = best_detection(out)
    if best is None:
        print("no suitable detection found")
        return 1

    shift = -(int(out["carrier_bin"][best])
              + float(out["carrier_offset"][best]))
    signal = shifted_time_signal(
        blocks[best].astype(np.complex128), shift)
    template = extract_template(
        signal, int(out["corr_sample"][best]), len(base_template))
    np.save(args.output, template)
    print("Captured template from block #{} (timestamp: {:.6f}): "
          "offset={:+.3f}; corr_ampl={}".format(
              int(idx[best]), float(ts[best]),
              float(out["corr_offset"][best]),
              float(out["corr_energy"][best])))
    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        offset = float(out["corr_offset"][best])
        xdata = np.arange(len(template), dtype=np.float64)
        fig, ax = plt.subplots()
        ax.plot(xdata, template, ".-", label="New")
        ax.plot(xdata - offset, base_template, ".-", label="Base")
        ax.set_xlabel("sample")
        ax.legend()
        fig.savefig(args.plot)
        plt.close(fig)
        print("template overlay written to", args.plot)


if __name__ == "__main__":
    sys.exit(_main())
