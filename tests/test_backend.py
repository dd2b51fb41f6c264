"""Backend decisions in one place (utils/backend.py) and what follows from
them: kernel choice, host offload, memory budget, compile cache, and the
precision of the set-up matrix products."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jwas_tpu.engine import mcmc as eng
from jwas_tpu.ops import grouped as gr
from jwas_tpu.ops import markers as mk
from jwas_tpu.utils import backend


def test_use_pallas_true_raises_without_kernel():
    assert jax.default_backend() == "cpu"
    assert backend.kernel_available() is False
    with pytest.raises(ValueError, match="no compiled inner-round kernel"):
        backend.resolve_use_pallas(True)
    assert backend.resolve_use_pallas("auto") is False
    assert backend.resolve_use_pallas(False) is False


def test_engine_kernel_choice(monkeypatch):
    """"auto" gives the XLA sweep on the CPU; where a kernel exists it is
    chosen for the blocked BayesB/C/R sweeps of one device only."""
    assert eng._resolve_use_pallas("auto", True, "BayesC", None) is False
    with pytest.raises(ValueError):
        eng._resolve_use_pallas(True, True, "BayesC", None)
    monkeypatch.setattr(backend, "kernel_available", lambda: True)
    assert eng._resolve_use_pallas("auto", True, "BayesC", None) is True
    assert eng._resolve_use_pallas("auto", True, "BayesR", None) is True
    assert eng._resolve_use_pallas("auto", True, "RR-BLUP", None) is False
    assert eng._resolve_use_pallas("auto", False, "BayesC", None) is False
    mesh = object()
    assert eng._resolve_use_pallas("auto", True, "BayesC", mesh) is False
    with pytest.raises(ValueError, match="single-device"):
        eng._resolve_use_pallas(True, True, "BayesC", mesh)


def test_host_offload_requested_where_unsupported_raises():
    assert gr.host_memory_supported() is False      # CPU: no in-jit staging
    with pytest.raises(ValueError, match="host_offload_genotypes=True"):
        eng._resolve_host_offload(True, 1)
    assert eng._resolve_host_offload("auto", 1 << 60) is False
    assert eng._resolve_host_offload(False, 1 << 60) is False


class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform = platform
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_memory_budget(monkeypatch):
    with pytest.raises(RuntimeError, match="bytes_limit"):
        backend.device_memory_bytes(_FakeDevice("gpu", None))
    with pytest.raises(RuntimeError):
        backend.device_memory_bytes(_FakeDevice("gpu", {"bytes_in_use": 1}))
    assert backend.device_memory_bytes(
        _FakeDevice("gpu", {"bytes_limit": 123})) == 123
    monkeypatch.setenv("JWAS_HBM_BYTES", "5e9")
    assert backend.device_memory_bytes(_FakeDevice("cpu", None)) == 5 * 10**9
    monkeypatch.delenv("JWAS_HBM_BYTES")
    assert backend.device_memory_bytes(_FakeDevice("cpu", {})) == 16 * 1024**3


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache(env_set, monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert backend.enable_compile_cache() == str(tmp_path)
            # JAX's own setting stands: nothing is written into the config
            assert jax.config.jax_compilation_cache_dir is None
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = backend.enable_compile_cache()
            root = os.path.dirname(os.path.dirname(os.path.abspath(
                backend.__file__)))
            assert path == os.path.join(os.path.dirname(root), ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
            # a second call keeps the same fixed path
            assert backend.enable_compile_cache() == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


_F32_ALGORITHM = ("lhs_precision_type = f32, rhs_precision_type = f32, "
                  "accumulation_type = f32")


def _dot_lines(text):
    lines = [ln for ln in text.splitlines() if "dot_general" in ln]
    assert lines, "no dot_general in the lowered module"
    return lines


def test_gram_products_request_float32_algorithm():
    """Set-up products are lowered with the float32 dot algorithm (a GPU
    runs float32 products in TF32 otherwise, and Precision.HIGHEST is not
    float32 for a batched product there); float64 operands take HIGHEST."""
    X = jnp.ones((16, 32), jnp.float32)
    text = jax.jit(lambda x: mk.build_marker_blocks(x, block_size=8)).lower(
        X).as_text()
    for ln in _dot_lines(text):
        assert _F32_ALGORITHM in ln, ln
    store = jnp.zeros((2, 16, 4), jnp.uint8)
    text = gr.grouped_stats.lower(
        store, jnp.zeros((32,)), jnp.ones((32,)), None, None, b=8,
        n_obs=16).as_text()
    for ln in _dot_lines(text):
        assert _F32_ALGORITHM in ln, ln
    assert mk.full_precision(jnp.float64) == jax.lax.Precision.HIGHEST


@pytest.mark.parametrize("n", [300, 5000])
def test_gram_products_match_float64(n):
    """300 rows take one product; 5000 are summed in chunks of rows."""
    rng = np.random.default_rng(0)
    X = rng.binomial(2, 0.3, size=(n, 24)).astype(np.float32)
    X -= X.mean(axis=0)
    md = mk.build_marker_blocks(jnp.asarray(X), block_size=8)
    for i in range(3):
        Xb = X[:, i * 8:(i + 1) * 8].astype(np.float64)
        g64 = Xb.T @ Xb
        scale = np.sqrt(np.outer(np.diag(g64), np.diag(g64)))
        err = np.abs(np.asarray(md.grams)[:, :, i].T - g64) / scale
        assert err.max() <= 1e-5, err.max()
        np.testing.assert_allclose(np.asarray(md.xpx)[i * 8:(i + 1) * 8],
                                   np.diag(g64), rtol=1e-5)


def test_gram_tiles_chunked_sum_equals_one_product():
    rng = np.random.default_rng(1)
    X = jnp.asarray(rng.normal(size=(1000, 3, 4)), jnp.float32)
    W = X * jnp.asarray(rng.uniform(0.5, 2.0, size=(1000, 1, 1)), jnp.float32)
    one = mk.gram_tiles(X, W, obs_chunk=1000)
    chunked = mk.gram_tiles(X, W, obs_chunk=300)      # 4 chunks, last padded
    assert chunked.shape == one.shape == (4, 4, 3)
    np.testing.assert_allclose(np.asarray(chunked), np.asarray(one),
                               rtol=1e-5, atol=1e-4)
