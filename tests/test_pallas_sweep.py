"""GPU inner-round kernels (ops/pallas_sweep.py) against the XLA scan.

The kernels are Pallas programs for the Triton route; here they run in the
Pallas interpreter on the CPU. They consume the same pre-drawn uniforms,
normals and Gumbel panels as the XLA path and apply the same update order,
so outputs match the scan up to float rounding of the rhs update. The
compiled kernels are checked against the scan on a GPU by chip_smoke.py
(phase "kernel").
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from jwas_tpu.ops import markers as mk
from jwas_tpu.ops import pallas_sweep as ps


def _problem(n, b, nblocks, seed):
    rng = np.random.default_rng(seed)
    X = jnp.asarray(rng.normal(size=(n, b * nblocks)), jnp.float32)
    md = mk.build_marker_blocks(X, block_size=b)
    y = jnp.asarray(rng.normal(size=(n,)), jnp.float32)
    return rng, md, y


@pytest.mark.parametrize("tiling", ["whole_tiles", "padded_tile"])
@pytest.mark.parametrize("nreps", [1, 3])
@pytest.mark.parametrize("method", ["abc", "bayesr"])
def test_pallas_matches_xla_scan(method, nreps, tiling, monkeypatch):
    """Interpret-mode kernel == XLA blocked sweep on the same draws. With
    a small SM hint several blocks share a program, so "padded_tile" (9
    blocks, b=12) exercises both a padded block tile and rows padded to a
    power of two; "whole_tiles" is 8 blocks of b=8 in whole tiles."""
    monkeypatch.setattr(ps, "NUM_SMS_HINT", 2)
    b, nblocks = (8, 8) if tiling == "whole_tiles" else (12, 9)
    L = ps._blocks_per_program(nblocks)
    assert L > 1 and (nblocks % L == 0) == (tiling == "whole_tiles")
    rng, md, y = _problem(48, b, nblocks, seed=nreps)
    p = md.X.shape[1]
    key = jax.random.PRNGKey(7 + nreps)
    vare = jnp.asarray(1.3, jnp.float32)
    if method == "abc":
        alpha = jnp.asarray(rng.normal(size=(p,)) * 0.1, jnp.float32)
        delta = jnp.ones((p,), jnp.int32)
        pi = jnp.full((p,), 0.9, jnp.float32)
        args = (md, alpha, alpha, delta, y, None, vare, jnp.float32(0.02), pi,
                key)
        ref = mk.sweep_blocks_abc(*args, nreps=nreps, sync_every=2)
        got = mk.sweep_blocks_abc(*args, nreps=nreps, sync_every=2,
                                  use_pallas=True, interpret=True)
        didx = 2
    else:
        pi = jnp.broadcast_to(
            jnp.asarray([0.9, 0.05, 0.03, 0.02], jnp.float32), (p, 4))
        args = (md, jnp.zeros((p,), jnp.float32), jnp.zeros((p,), jnp.int32),
                y, None, vare, jnp.float32(0.4), pi, key)
        ref = mk.sweep_blocks_bayesr(*args, nreps=nreps, sync_every=2)
        got = mk.sweep_blocks_bayesr(*args, nreps=nreps, sync_every=2,
                                     use_pallas=True, interpret=True)
        didx = 1
    np.testing.assert_array_equal(np.asarray(ref[didx]),
                                  np.asarray(got[didx]))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(np.asarray(r), np.asarray(g), rtol=1e-5,
                                   atol=1e-5)


def test_pallas_under_vmap_over_chains():
    """The multichain driver vmaps the whole step over chains: the kernel's
    batching rule must give each chain its own result."""
    _, md, y = _problem(40, 8, 4, seed=3)
    p = md.X.shape[1]
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(3))
    alpha = jnp.zeros((3, p), jnp.float32)
    delta = jnp.ones((3, p), jnp.int32)
    pi = jnp.full((p,), 0.8, jnp.float32)

    def run(use_pallas):
        f = lambda a, d, k: mk.sweep_blocks_abc(  # noqa: E731
            md, a, a, d, y, None, jnp.float32(1.0), jnp.float32(0.05), pi, k,
            nreps=2, use_pallas=use_pallas, interpret=use_pallas)
        return jax.vmap(f)(alpha, delta, keys)

    for r, g in zip(run(False), run(True)):
        np.testing.assert_allclose(np.asarray(r), np.asarray(g), rtol=1e-5,
                                   atol=1e-5)


def test_layout_helpers_round_trip():
    """Block-major padding keeps every real entry in place; padded rows and
    blocks take the fill value; Gram rows come out block-major."""
    b, nblocks, nbp, bp = 3, 5, 6, 4
    x = jnp.arange(b * nblocks, dtype=jnp.float32).reshape(b, nblocks)
    rows = ps._to_block_major(x, nbp, bp, -1.0)
    assert rows.shape == (nbp, bp)
    np.testing.assert_array_equal(np.asarray(rows[:nblocks, :b]),
                                  np.asarray(x.T))
    assert float(rows[nblocks:].max()) == -1.0
    assert float(rows[:, b:].max()) == -1.0
    g = jnp.arange(b * b * nblocks, dtype=jnp.float32).reshape(b, b, nblocks)
    gb = ps._grams_block_major(g, nbp, bp)
    np.testing.assert_array_equal(np.asarray(gb[2, 1, :b]),
                                  np.asarray(g[1, :, 2]))
    assert float(jnp.abs(gb[nblocks:]).max()) == 0.0
    assert ps._pow2(24) == 32 and ps._pow2(128) == 128 and ps._pow2(1) == 1
