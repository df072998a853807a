"""thrifty-tpu: a batched JAX TDOA detection & positioning framework.

A from-scratch re-design of the capabilities of swkrueger/Thrifty
(proof-of-concept SDR TDOA positioning of wildlife trackers) for
accelerators: all DSP runs as batched JAX/XLA programs on the GPU,
scaled over device meshes with jax.sharding, with a C++ host layer for
stream I/O.

Layer map (mirrors reference SURVEY.md section 1):
  ingest   -- .card / raw IQ readers, overlap-save blocking  (thrifty_tpu.io)
  detect   -- carrier detect + sync + matched filter + SoA   (thrifty_tpu.dsp)
  server   -- identify / match / tdoa / pos                  (thrifty_tpu.pipeline)
  parallel -- mesh sharding, halo exchange                   (thrifty_tpu.parallel)
"""

__version__ = "0.1.0"
