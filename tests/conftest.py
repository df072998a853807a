"""Force tests onto a virtual 8-device CPU mesh (no GPU required).

The program runs on the GPU (chip_smoke.py, bench.py); unit tests
exercise the same code paths on the CPU with 8 virtual devices so the
sharding tests run anywhere.  The platform is also forced via
jax.config after import, before any backend initializes, so a machine
with a GPU still runs the suite on the CPU.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# Allow float64 in tests: oracle comparisons need f64 inputs to stay f64.
# Device-path tests still exercise f32 (their inputs are complex64/float32).
jax.config.update("jax_enable_x64", True)
