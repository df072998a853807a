"""Time the detector's plain peak/energy reductions on the device.

The detect program reduces each [B, N] spectrum or correlation with
|x|^2, a masked (windowed) argmax, a peak gather and a total-energy sum.
XLA fuses these into one or two reduction kernels that read the complex
array once.  This script times that math, jitted as the detector runs
it, at the production shape ([256, 16384] complex64 = 32 MiB), and sets
it against one read of the input at the card's memory bandwidth and
against a plain copy of the same array.  Successive iterations read
different copies of the input (--copies of them, 128 MiB by default),
so no iteration finds its input in the card's L2 cache (50 MB on an
H100).

Timing is the in-program scan-slope method (bench.time_slope's idea):
K and 2K chained iterations inside one program, per-iteration time =
(T(2K) - T(K)) / K, so launch overhead cancels.

Usage:  python scripts/reduction_time.py [--batch 256] [--k 200]
                                        [--copies 4]

Prints one JSON line with the device, the per-call times and the
bandwidth bound.
"""

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Device-memory bandwidth by device_kind (bytes/s), NVIDIA data sheets.
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def plain_reductions(x, mask):
    """Windowed argmax of |x|^2, its peak power and the total power --
    the math of the removed fused kernel's jnp reference, which the
    detector's carrier and correlation stages compute."""
    import jax.numpy as jnp

    power = jnp.square(x.real) + jnp.square(x.imag)
    idx = jnp.argmax(jnp.where(mask, power, -1.0), axis=-1).astype(jnp.int32)
    peak = jnp.take_along_axis(power, idx[:, None], axis=-1)[:, 0]
    return idx, peak, jnp.sum(power, axis=-1)


def slope_time(body, xs, k, repeats):
    """Per-iteration seconds of ``body(x, carry) -> carry`` chained K
    and 2K times inside one program; iteration i reads copy
    ``i % len(xs)`` of the input."""
    import jax
    from jax import lax

    def make(length):
        @jax.jit
        def prog(xs):
            def step(i, c):
                x = lax.dynamic_index_in_dim(xs, i % xs.shape[0],
                                             keepdims=False)
                return body(x, c)
            return lax.fori_loop(0, length, step, jax.numpy.float32(0.0))
        return prog

    progs = {n: make(n) for n in (k, 2 * k)}
    for p in progs.values():
        np.asarray(p(xs))  # compile + warm up
    slopes = []
    for _ in range(repeats):
        t = {}
        for n, p in progs.items():
            t0 = time.perf_counter()
            np.asarray(p(xs))
            t[n] = time.perf_counter() - t0
        slopes.append((t[2 * k] - t[k]) / k)
    return statistics.median(slopes), slopes


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--n", type=int, default=16384)
    parser.add_argument("--k", type=int, default=200)
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--copies", type=int, default=4,
                        help="distinct input copies read in turn, so "
                             "the input never sits in L2 [default: 4]")
    args = parser.parse_args(argv)

    import jax
    import jax.numpy as jnp

    if jax.default_backend() == "cpu":
        print("reduction_time.py: no accelerator found", file=sys.stderr)
        return 2

    from thrifty_tpu.compile_cache import enable_compile_cache
    from thrifty_tpu.dsp import carrier

    enable_compile_cache()
    rng = np.random.default_rng(0)
    shape = (args.copies, args.batch, args.n)
    xs = jax.device_put((rng.normal(size=shape)
                         + 1j * rng.normal(size=shape)).astype(np.complex64))
    mask = jnp.asarray(carrier.window_mask((7, 110), args.n))

    def reduce_body(x, c):
        # The carry perturbs the input (fused into the reduction's read)
        # so no iteration can be hoisted or cached.
        idx, peak, total = plain_reductions(x + c, mask)
        return (jnp.sum(peak) + jnp.sum(total) + jnp.sum(idx)) * 0.0

    def copy_body(x, c):
        y = jax.lax.optimization_barrier(x + c)
        return y[0, 0].real * 0.0

    red, red_runs = slope_time(reduce_body, xs, args.k, args.repeats)
    cpy, cpy_runs = slope_time(copy_body, xs, args.k, args.repeats)
    dev = jax.devices()[0]
    nbytes = xs[0].size * xs.dtype.itemsize
    peak_bw = PEAK_BYTES_PER_S.get(dev.device_kind)
    print(json.dumps({
        "metric": "plain_reduction_time",
        "shape": [args.batch, args.n], "input_bytes": nbytes,
        "copies": args.copies,
        "reductions_s": red, "reductions_runs_s": red_runs,
        "copy_s": cpy, "copy_runs_s": cpy_runs,
        "read_bound_s": nbytes / peak_bw if peak_bw else None,
        "reductions_achieved_read_bytes_per_s": nbytes / red,
        "copy_achieved_bytes_per_s": 2 * nbytes / cpy,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
