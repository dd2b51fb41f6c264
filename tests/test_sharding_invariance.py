"""Multi-chip correctness: marker-sharded runs equal single-device runs.

The blocked sweep consumes counter-based draws keyed only by (key, round), so
a marker-sharded execution sees the SAME random numbers as the unsharded one;
the only difference is XLA's reduction order in the residual-sync GEMVs
(SURVEY.md §2.9 P2: psum over the marker axis). These tests pin that down on
the 8-device CPU mesh: one sweep agrees to float tolerance with identical
inclusion decisions, a 20-iteration chain stays on the same trajectory, and a
full 2-chain x 4-marker-shard runMCMC clears the EBV accuracy bar.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from jwas_tpu.ops import markers as mk
from jwas_tpu.parallel.mesh import make_mesh, shard_st

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device CPU test mesh"
)


def _toy(n=64, p=256, block=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.binomial(2, 0.4, size=(n, p)).astype(np.float32)
    X = X - X.mean(axis=0)
    md = mk.build_marker_blocks(jnp.asarray(X), block_size=block)
    y = jnp.asarray(
        X @ (rng.normal(0, 0.3, p) * (rng.uniform(size=p) < 0.1))
        + rng.normal(0, 1.0, n),
        jnp.float32,
    )
    return md, y


def test_single_sweep_sharded_equals_unsharded():
    from jax.sharding import NamedSharding, PartitionSpec as P

    md, y = _toy()
    p_pad = md.X.shape[1]
    alpha = jnp.zeros((p_pad,), jnp.float32)
    beta = alpha
    delta = jnp.ones((p_pad,), jnp.int32)
    pi = jnp.full((p_pad,), 0.9, jnp.float32)
    key = jax.random.PRNGKey(5)
    args = (md, alpha, beta, delta, y, None, jnp.float32(1.0),
            jnp.float32(0.05), pi, key)

    a1, b1, d1, y1 = mk.sweep_blocks_abc(*args, nreps=4, sync_every=2)

    mesh = make_mesh(n_chains=1, n_marker_shards=8)
    mrk = NamedSharding(mesh, P("marker"))
    md_s = mk.MarkerBlocks(
        X=jax.device_put(md.X, NamedSharding(mesh, P(None, "marker"))),
        xpx=jax.device_put(md.xpx, mrk),
        grams=jax.device_put(md.grams, NamedSharding(mesh, P(None, None, "marker"))),
        valid=jax.device_put(md.valid, mrk),
    )
    a2, b2, d2, y2 = mk.sweep_blocks_abc(
        md_s, jax.device_put(alpha, mrk), jax.device_put(beta, mrk),
        jax.device_put(delta, mrk), y, None, jnp.float32(1.0),
        jnp.float32(0.05), jax.device_put(pi, mrk), key,
        nreps=4, sync_every=2,
    )
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))
    np.testing.assert_allclose(np.asarray(a1), np.asarray(a2), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y2), rtol=1e-4, atol=1e-4)


def test_full_step_chain_sharded_matches_unsharded():
    """20 full Gibbs iterations through the jitted engine step, sharded vs
    unsharded: same key => same draw stream; trajectories must agree."""
    import __graft_entry__ as ge
    from jwas_tpu.engine.mcmc import _init_accum, make_run_window

    cfg, data, state = ge._toy_problem(n=48, p=256, block=8, seed=3)
    rw = make_run_window(cfg)
    accum0 = _init_accum(cfg, data, state)

    s1, a1, o1 = rw(state, data, accum0, 20, True)

    mesh = make_mesh(n_chains=1, n_marker_shards=8)
    data_s, state_s = shard_st(mesh, cfg, data, state)
    s2, a2, o2 = rw(state_s, data_s, accum0, 20, True)

    np.testing.assert_allclose(float(s1.vare), float(s2.vare), rtol=2e-3)
    a1m = np.asarray(a1.alpha_m)
    a2m = np.asarray(a2.alpha_m)
    assert np.corrcoef(a1m, a2m)[0, 1] > 0.999
    np.testing.assert_allclose(np.asarray(o1.ebv), np.asarray(o2.ebv),
                               rtol=5e-2, atol=5e-2)


def test_runmcmc_chains_by_markers_mesh():
    """End-to-end: 2 chains x 4 marker shards through the public API."""
    from jwas_tpu import build_model, get_genotypes, runMCMC
    from jwas_tpu.io.datasets import simulate_genomic_data

    sim = simulate_genomic_data(n=300, p=128, n_qtl=10, h2=0.5, seed=8)
    geno = get_genotypes(sim["genotypes"], method="BayesC", name="geno",
                         quality_control=False)
    model = build_model("y = intercept + geno", genotypes=geno)
    mesh = make_mesh(n_chains=2, n_marker_shards=4)
    out = runMCMC(model, sim["phenotypes"], chain_length=480, burnin=96,
                  seed=9, n_chains=2, mesh=mesh, fast_blocks=8,
                  output_samples_frequency=8, output_folder="")
    acc = np.corrcoef(out["EBV_y"].EBV, sim["true_bv"])[0, 1]
    assert acc > 0.8, f"sharded multichain EBV accuracy {acc:.3f}"
    assert "PSRF" in out


def test_packed_store_sharded_along_markers():
    """The 2-bit packed store shards along its marker-major rows; the packed
    sweep under sharding equals the single-device packed sweep."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from jwas_tpu.ops.packed import (
        PackedMarkers,
        packed_markers_from_arrays,
        sweep_blocks_abc_packed,
    )

    rng = np.random.default_rng(6)
    n, b, nblocks = 48, 8, 32
    p = b * nblocks
    codes = rng.integers(0, 3, size=(p, n)).astype(np.uint8)
    n_pad = -(-n // 4) * 4
    cp = np.zeros((p, n_pad), np.uint8)
    cp[:, :n] = codes
    packed = (cp[:, 0::4] | (cp[:, 1::4] << 2) | (cp[:, 2::4] << 4)
              | (cp[:, 3::4] << 6))
    means = codes.mean(axis=1).astype(np.float32)
    pm = packed_markers_from_arrays(packed, means, np.ones(p, np.float32),
                                    None, n, b)
    X = (codes.astype(np.float32) - means[:, None]).T
    y = jnp.asarray(X @ (rng.normal(size=p) * 0.05) + rng.normal(size=n),
                    jnp.float32)
    alpha = jnp.zeros((p,), jnp.float32)
    args = (alpha, alpha, jnp.ones((p,), jnp.int32), y, None,
            jnp.float32(1.0), jnp.float32(0.05),
            jnp.full((p,), 0.9, jnp.float32), jax.random.PRNGKey(2))

    a1, _, d1, y1 = sweep_blocks_abc_packed(pm, *args, nreps=4, sync_every=2)

    mesh = make_mesh(n_chains=1, n_marker_shards=8)
    mrk = NamedSharding(mesh, P("marker"))
    pm_s = PackedMarkers(
        packed=jax.device_put(pm.packed, NamedSharding(mesh, P("marker", None))),
        means=jax.device_put(pm.means, mrk),
        row_perm=None,
        xpx=jax.device_put(pm.xpx, mrk),
        grams=jax.device_put(pm.grams, NamedSharding(mesh, P(None, None, "marker"))),
        valid=jax.device_put(pm.valid, mrk),
    )
    a2, _, d2, y2 = sweep_blocks_abc_packed(
        pm_s, *args, nreps=4, sync_every=2,
    )
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))
    np.testing.assert_allclose(np.asarray(a1), np.asarray(a2), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y2), rtol=1e-4, atol=1e-4)


def test_runmcmc_packed_store_on_marker_sharded_mesh():
    """The production packed-store path on >1 device: a 2-bit store under a
    marker-sharded mesh routes through the FLAT sharded packed sweep (the
    grouped schedule is single-device by design, engine/mcmc.py), warns
    that host_offload_genotypes=True is ignored, and still recovers the
    signal. The same store without a mesh routes grouped — both
    configurations must deliver the same accuracy."""
    import warnings

    from jwas_tpu import build_model, get_genotypes, runMCMC
    from jwas_tpu.engine import mcmc as eng
    from jwas_tpu.io.datasets import simulate_genomic_data
    from jwas_tpu.io.packed import prepare_packed_genotypes
    from jwas_tpu.parallel.mesh import make_mesh

    sim = simulate_genomic_data(n=360, p=256, n_qtl=12, h2=0.6, seed=21)
    store = prepare_packed_genotypes(sim["genotypes"])
    accs = {}
    seen = {}
    orig = eng.make_run_window

    def spy(cfg):
        seen["grouped"] = cfg.grouped
        seen["is_packed"] = cfg.is_packed
        return orig(cfg)

    for label, mesh, offload in (
        ("mesh", make_mesh(n_chains=2, n_marker_shards=4), True),
        ("single", None, False),
    ):
        geno = get_genotypes(store, method="BayesC", name="geno")
        model = build_model("y = intercept + geno", genotypes=geno)
        eng.make_run_window = spy
        try:
            with warnings.catch_warnings(record=True) as wlog:
                warnings.simplefilter("always")
                out = runMCMC(model, sim["phenotypes"], chain_length=480,
                              burnin=96, seed=13, mesh=mesh,
                              n_chains=(2 if mesh is not None else 1),
                              fast_blocks=8, output_folder="",
                              host_offload_genotypes=offload)
        finally:
            eng.make_run_window = orig
        accs[label] = np.corrcoef(out["EBV_y"].EBV, sim["true_bv"])[0, 1]
        assert seen["is_packed"] is True
        if label == "mesh":
            assert seen["grouped"] is False     # mesh bypasses grouped
            assert any("host_offload_genotypes=True is ignored" in
                       str(w.message) for w in wlog), (
                "missing the documented mesh-bypass warning")
        else:
            assert seen["grouped"] is True
    assert accs["mesh"] > 0.8, accs
    assert accs["single"] > 0.8, accs
    assert abs(accs["mesh"] - accs["single"]) < 0.1, accs
