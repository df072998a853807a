"""Persistent compile cache (the FFTW-wisdom analog) in the CLI path."""

import os

import numpy as np

from thrifty_tpu import sim
from thrifty_tpu.dsp import iq
from thrifty_tpu.io import card


def test_enable_compile_cache_env_override(tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR is honoured: the cache goes there and
    no other directory is configured."""
    import jax

    cache_dir = str(tmp_path / "wisdom")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", cache_dir)
    from thrifty_tpu.compile_cache import enable_compile_cache

    assert enable_compile_cache() == cache_dir
    assert jax.config.jax_compilation_cache_dir == cache_dir


def test_default_cache_dir_is_fixed(tmp_path, monkeypatch):
    """Unset, the cache lives at <checkout>/.jax_cache: the same path
    whatever the working directory, process or time (the path is part
    of what lets a later run find the cache)."""
    import jax

    from thrifty_tpu import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    expected = os.path.join(repo, ".jax_cache")
    first = compile_cache.enable_compile_cache()
    monkeypatch.chdir(tmp_path)
    assert compile_cache.enable_compile_cache() == first == expected
    assert jax.config.jax_compilation_cache_dir == expected
    assert compile_cache.DEFAULT_DIR == expected
    assert str(os.getpid()) not in expected


def test_detect_cli_populates_cache(tmp_path, monkeypatch):
    """A cold `thrifty-tpu detect` leaves compiled executables in the
    persistent cache so the next invocation skips compilation
    (reference wisdom files, fastcard/fastcard.c:32-37)."""
    cache_dir = str(tmp_path / "wisdom")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", cache_dir)
    # Earlier tests may have initialized the persistent cache at another
    # location and populated the in-memory executable cache; reset both
    # so this cold start actually compiles into the new directory.
    import jax
    jax.clear_caches()
    try:
        from jax._src import compilation_cache as _cc
        _cc.reset_cache()
    except (ImportError, AttributeError):
        pass

    tpl = sim.make_template(bits=7)  # unique geometry -> fresh compile
    cap = sim.synth_capture(
        num_blocks=4, bursts_every=2, template=tpl, block_len=4096,
        history_len=400, carrier_bin=40.25, seed=3)
    card_path = str(tmp_path / "rx.card")
    card.write_card(card_path, cap.timestamps, cap.indices,
                    iq.iq_to_raw(cap.blocks))
    tpl_path = str(tmp_path / "t.npy")
    np.save(tpl_path, tpl)

    from thrifty_tpu import cli
    rc = cli.main([
        "detect", card_path, "-o", str(tmp_path / "rx.toad"), "--quiet",
        "--carrier-window", "7-110", "--template", tpl_path,
        "--block-size", "4096", "--history", "400"])
    assert rc == 0
    entries = [f for f in os.listdir(cache_dir)] if \
        os.path.isdir(cache_dir) else []
    assert entries, "compile cache directory was not populated"
