"""utils/cache.enable: where the persistent compile cache goes."""

import os

import jax
import pytest

from sfm_mvs_tpu.utils import cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("from_env", [True, False], ids=["env-set", "env-unset"])
def test_enable_picks_cache_dir(from_env, tmp_path, monkeypatch):
    if from_env:
        want = str(tmp_path / "jax_cache")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    else:
        want = os.path.join(ROOT, ".jax_cache")
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    saved = (
        jax.config.jax_compilation_cache_dir,
        jax.config.jax_persistent_cache_min_compile_time_secs,
    )
    try:
        got = cache.enable()
        assert got == want == jax.config.jax_compilation_cache_dir
        assert os.path.isdir(want)
    finally:
        jax.config.update("jax_compilation_cache_dir", saved[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])
    # The default never depends on where or when the process runs.
    assert os.path.commonpath([cache.DEFAULT_DIR, ROOT]) == ROOT
