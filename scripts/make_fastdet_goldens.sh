#!/bin/bash
# Build the ACTUAL reference C implementation (fastcard + fastdet,
# /root/reference) against minimal self-written backend shims, run it on
# committed inputs, and write golden outputs to tests/golden/fastdet/.
#
# The build hosts have no FFTW, volk, or librtlsdr, so this script
# substitutes:
#   * fftw3.h      -> own iterative radix-2 FFT (double-precision
#                     internal, float in/out; power-of-two only).
#                     Deviation from a real FFTWf build is below the
#                     float32 rounding scale the comparison tests
#                     already tolerate.
#   * volk/volk.h  -> straightforward scalar kernels with the generic
#                     volk semantics (first-max-wins argmax, etc.).
#   * rtlsdr_reader -> stub (never used: inputs are .card/raw files).
#
# Everything else -- overlap-save geometry, carrier detection,
# integer-bin roll, Gaussian/parabolic interpolation with 0.5 clips,
# thresholds, SoA assembly, .card/.toad serialization -- is the
# reference's own compiled C/C++ (fastcard/*.c, fastdet/*.cpp).
# The build happens in /tmp; no reference code enters the repo.
#
# Outputs:
#   tests/golden/fastdet/rxN_fastdet.toad   fastdet on tests/golden/input/rxN.card
#   tests/golden/fastdet/gated.card         fastcard carrier-gating the
#                                           committed raw stream
#   tests/golden/fastdet/tee.card           fastdet --card-output tee
#
# Usage: scripts/make_fastdet_goldens.sh [REFERENCE_DIR] [OUT_DIR]
set -euo pipefail

REF=${1:-/root/reference}
REPO=$(cd "$(dirname "$0")/.." && pwd)
OUT=${2:-$REPO/tests/golden/fastdet}
WORK=$(mktemp -d /tmp/reffastdet.XXXXXX)
trap 'rm -rf "$WORK"' EXIT

"$REPO/scripts/build_fastdet_shim.sh" "$REF" "$WORK"


# --- goldens ---
IN="$REPO/tests/golden/input"
FIN="$REPO/tests/golden/fastdet/input"
cd "$WORK/run"
python3 "$REPO/scripts/npy_to_tpl.py" "$IN/template.npy" template.tpl

mkdir -p "$OUT"
# fastdet on the scenario-1 cards (same thresholds as detector.cfg:
# carrier 0c+15s over bins 7-110, corr 15s).  NOTE: --card must precede
# -i: fargs_parse_opt's ARGP_KEY_CARD case falls through into case 'i'
# with arg == NULL (fargs.c:114-116), clobbering input_file -- a genuine
# upstream bug masked by their habitual argument order.
for i in 0 1 2; do
    "$WORK/bin/fastdet" --card -i "$IN/rx$i.card" -b 16384 -h 4920 \
        -w 7-110 -t 15s -u 15s -z template.tpl -r "$i" \
        -o "rx${i}_fastdet.toad" -q
    cp "rx${i}_fastdet.toad" "$OUT/"
done

# fastdet .card tee on detection (fastdet.cpp:210-219).
"$WORK/bin/fastdet" --card -i "$IN/rx0.card" -b 16384 -h 4920 \
    -w 7-110 -t 15s -u 15s -z template.tpl -r 0 \
    -o /dev/null -x tee.card -q
cp tee.card "$OUT/"

# fastcard carrier-gating the committed raw stream (the capture
# thinning loop, fastcard_cli.c:156-196).  Timestamps are wall-clock
# (not deterministic); comparisons use index + payload only.
"$WORK/bin/fastcard" -i "$FIN/rx0.raw" -b 16384 -h 4920 \
    -w 7-110 -t 15s -o gated.card -q
cp gated.card "$OUT/"

# fastdet on the raw stream with its default skip=1 (renumbered time
# base): pins detect --raw -k 1.  Wall-clock timestamps again.
"$WORK/bin/fastdet" -i "$FIN/rx0.raw" -b 16384 -h 4920 \
    -w 7-110 -t 15s -u 15s -z template.tpl -r 0 \
    -o raw_skip1_fastdet.toad -q
cp raw_skip1_fastdet.toad "$OUT/"

echo "goldens written to $OUT"
