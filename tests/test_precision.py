"""Device-path contraction precision and the FFT route per backend.

On the GPU a float32 contraction with no precision argument may run in
TF32 (a 10-bit mantissa).  CPU results cannot show that, so these tests
read the traced programs instead: every dot_general on the device path
must ask for Precision.HIGHEST.
"""

import numpy as np
import pytest

import jax
from jax import lax
import jax.extend.core as jax_core

from thrifty_tpu import sim
from thrifty_tpu.dsp import dirichlet, mxu_fft
from thrifty_tpu.dsp.detector import BatchDetector, DetectorConfig


def _subjaxprs(value):
    """Jaxprs nested in one equation parameter (pjit, scan, cond
    branches, custom rules, linear solves)."""
    if isinstance(value, jax_core.ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, jax_core.Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _subjaxprs(v)


def dot_precisions(jaxpr):
    """The precision parameter of every dot_general in ``jaxpr``,
    nested jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for value in eqn.params.values():
            for sub in _subjaxprs(value):
                out.extend(dot_precisions(sub))
    return out


def assert_all_highest(precisions):
    for p in precisions:
        pair = p if isinstance(p, tuple) else (p, p)
        assert pair == (lax.Precision.HIGHEST, lax.Precision.HIGHEST), p


@pytest.fixture(scope="module")
def template():
    return sim.make_template()


@pytest.mark.parametrize("fft_impl", ["xla", "matmul", "matmul3"])
@pytest.mark.parametrize("sync_mode", ["fractional", "integer", "preshift"])
def test_detect_program_contractions_highest(template, sync_mode, fft_impl):
    """The whole detect program at production geometry (traced, not
    compiled): four-step transforms, windowed carrier DFT, separable
    ramp, interpolators."""
    det = BatchDetector(template, DetectorConfig(
        carrier_window=(7, 110), sync_mode=sync_mode, fft_impl=fft_impl))
    blocks = jax.ShapeDtypeStruct((4, 16384), np.complex64)
    precisions = dot_precisions(jax.make_jaxpr(det._detect_batch)(blocks)
                                .jaxpr)
    if fft_impl != "xla":
        assert precisions, "no contraction found on the matmul path"
    assert_all_highest(precisions)


def test_gated_and_filtered_program_highest(template):
    """The carrier peak filter's FIR and the gated correlation branch."""
    det = BatchDetector(template, DetectorConfig(
        carrier_window=(7, 110), peak_filter_len=-1, gate_capacity=2))
    blocks = jax.ShapeDtypeStruct((4, 16384), np.complex64)
    precisions = dot_precisions(jax.make_jaxpr(det._detect_batch)(blocks)
                                .jaxpr)
    assert precisions, "the peak filter's tensordot was not traced"
    assert_all_highest(precisions)


def test_polyfit_interpolator_highest():
    interp = dirichlet.make_polyfit_interpolator(6)
    mag = jax.ShapeDtypeStruct((4, 2048), np.float32)
    idx = jax.ShapeDtypeStruct((4,), np.int32)
    precisions = dot_precisions(jax.make_jaxpr(interp)(mag, idx).jaxpr)
    assert precisions, "the polyfit projection was not traced"
    assert_all_highest(precisions)


def test_gauss_newton_solver_highest():
    from thrifty_tpu.pipeline import pos

    solver = pos._make_batched_solver(2, 4, 1e-2)
    # float64, as solve_groups_batched passes it (the tests enable x64).
    f64 = lambda *shape: jax.ShapeDtypeStruct(shape, np.float64)  # noqa
    jaxpr = jax.make_jaxpr(solver)(f64(8, 4), f64(8, 4), f64(8, 4),
                                   f64(8, 4, 2), f64(8, 4, 2), f64(2),
                                   f64(2)).jaxpr
    precisions = dot_precisions(jaxpr)
    assert len(precisions) >= 2, "the normal equations were not traced"
    assert_all_highest(precisions)


@pytest.mark.parametrize("backend", ["cpu", "gpu", "rocm"])
def test_auto_fft_impl_per_backend(monkeypatch, backend):
    """'auto' is jnp.fft on every backend: on the GPU cuFFT won the
    on-card A/B of the whole detect program (PERF.md)."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert mxu_fft.resolve_impl("auto") == "xla"
    assert not mxu_fft._use_matmul("auto")
    for explicit in ("matmul", "matmul3", "xla"):
        assert mxu_fft.resolve_impl(explicit) == explicit


def test_auto_keeps_fast_paths_off(monkeypatch, template):
    """Under 'auto' the matmul-only fast paths (windowed carrier DFT,
    separable ramp) stay off, on the GPU as on the CPU."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    det = BatchDetector(template, DetectorConfig(carrier_window=(7, 110)))
    assert det._carrier_win is None
    det = BatchDetector(template, DetectorConfig(
        carrier_window=(7, 110), fft_impl="matmul"))
    assert det._carrier_win is not None


def test_unknown_fft_impl_rejected():
    with pytest.raises(ValueError, match="fft impl"):
        mxu_fft.resolve_impl("cufft")
