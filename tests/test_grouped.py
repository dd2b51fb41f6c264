"""Group-streamed packed sweep tests (the out-of-core execution mode).

Covers the gaps called out for the runtime out-of-core path (reference
analogue: src/1.JWAS/src/markers/streaming_genotypes.jl:978-1027): the
grouped schedule's math vs the flat packed sweep, host-store bit-exactness
vs the device-resident store, the streamed Gram precompute (f32 and
exact-bf16) vs the dense GibbsMats, and end-to-end accuracy with multiple
sequential groups.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jwas_tpu.ops import grouped as gr
from jwas_tpu.ops import markers as mk
from jwas_tpu.ops.packed import (
    PackedMarkers,
    packed_markers_from_arrays,
    sweep_blocks_abc_packed,
)


def _pack_codes(codes):
    """(p, n) int codes in {0,1,2,3} -> (p, ceil(n/4)) uint8."""
    p, n = codes.shape
    n_pad = -(-n // 4) * 4
    c = np.zeros((p, n_pad), dtype=np.uint8)
    c[:, :n] = codes
    c = c.reshape(p, n_pad // 4, 4)
    return (c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4)
            | (c[:, :, 3] << 6)).astype(np.uint8)


def _make_problem(n=48, p=64, b=8, gb=4, seed=0, signal=0.15):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 3, size=(p, n))
    packed = _pack_codes(codes)
    means = codes.mean(axis=1).astype(np.float32)
    X = codes.T.astype(np.float32) - means[None, :]
    beta_true = rng.normal(size=p) * (rng.uniform(size=p) < signal)
    y = (X @ beta_true + rng.normal(size=n) * 0.5).astype(np.float32)
    ngroups = p // (b * gb)
    store3 = jnp.asarray(packed.reshape(ngroups, b * gb, -1))
    means_j = jnp.asarray(means)
    valid = jnp.ones((p,), jnp.float32)
    grams, xpx = gr.grouped_stats(store3, means_j, valid, None, None, b, n)
    gm = gr.GroupedPackedMarkers(store=store3, means=means_j, row_perm=None,
                                 xpx=xpx, grams=grams, valid=valid)
    pm = packed_markers_from_arrays(
        jnp.asarray(packed), means_j, valid, None, n, b
    )
    return gm, pm, jnp.asarray(X), jnp.asarray(y), beta_true


def _init(p, y, pi0=0.9, vare=None, var_eff=None):
    dtype = jnp.float32
    vy = float(np.var(np.asarray(y)))
    if vare is None:
        vare = 0.5 * vy
    if var_eff is None:
        var_eff = 0.5 * vy / (p * (1.0 - pi0))
    return dict(
        alpha=jnp.zeros((p,), dtype), beta=jnp.zeros((p,), dtype),
        delta=jnp.ones((p,), jnp.int32), ycorr=jnp.asarray(y, dtype),
        vare=jnp.asarray(vare, dtype), var_eff=jnp.asarray(var_eff, dtype),
        pi=jnp.full((p,), pi0, dtype),
    )


def test_grouped_stats_match_dense_gram():
    gm, pm, X, y, _ = _make_problem()
    md = mk.build_marker_blocks(X, block_size=8)
    np.testing.assert_allclose(np.asarray(gm.grams), np.asarray(md.grams),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(gm.xpx), np.asarray(md.xpx),
                               rtol=1e-5, atol=1e-4)
    # and against the flat packed builder
    np.testing.assert_allclose(np.asarray(gm.grams), np.asarray(pm.grams),
                               rtol=1e-5, atol=1e-4)


def test_grouped_stats_exact_bf16_path():
    """The integer-code bf16 Gram (Z'Z - m s' - s m' + n m m') equals the f32
    decode path: products of {0,1,2} and their sums are exact in bf16xbf16
    -> f32 accumulation."""
    gm, _, X, _, _ = _make_problem(n=52, p=64, b=8, gb=8)
    grams16, xpx16 = gr.grouped_stats(
        gm.store, gm.means, gm.valid, None, None, 8, 52, exact_bf16=True
    )
    np.testing.assert_allclose(np.asarray(grams16), np.asarray(gm.grams),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(xpx16), np.asarray(gm.xpx),
                               rtol=1e-4, atol=1e-3)


def test_grouped_matvec_rhs_match_dense():
    gm, _, X, y, _ = _make_problem()
    v = jnp.asarray(np.random.default_rng(3).normal(size=X.shape[1]),
                    jnp.float32)
    np.testing.assert_allclose(
        np.asarray(gr.grouped_matvec(gm, v, n_obs=X.shape[0])),
        np.asarray(X @ v), rtol=1e-4, atol=1e-4,
    )
    w = jnp.asarray(y)
    np.testing.assert_allclose(
        np.asarray(gr.grouped_rhs(gm, w)), np.asarray(X.T @ w),
        rtol=1e-4, atol=1e-3,
    )


def test_single_group_equals_flat_packed_sweep():
    """With one group the grouped schedule IS the flat packed sweep; the
    per-group key fold makes draws identical when the flat sweep is keyed
    with fold_in(key, 0)."""
    gm, pm, X, y, _ = _make_problem(n=48, p=64, b=8, gb=8)  # ngroups = 1
    st = _init(64, y)
    key = jax.random.PRNGKey(11)
    out_g = gr.sweep_blocks_abc_grouped(
        gm, st["alpha"], st["beta"], st["delta"], st["ycorr"], None,
        st["vare"], st["var_eff"], st["pi"], key, nreps=4, sync_every=2,
        use_planes=False,   # the flat sweep uses the decode-tile GEMVs
    )
    out_p = sweep_blocks_abc_packed(
        pm, st["alpha"], st["beta"], st["delta"], st["ycorr"], None,
        st["vare"], st["var_eff"], st["pi"], jax.random.fold_in(key, 0),
        nreps=4, sync_every=2,
    )
    for a, b_ in zip(out_g, out_p):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b_),
                                   rtol=2e-5, atol=2e-5)


def test_grouped_host_store_bit_equal_device_store():
    """host_store=True must stream the same bits: outputs are identical to
    the device-resident store (on backends that cannot stage pinned-host
    memory the store stays on the device; on a GPU this is the out-of-core
    equivalence, also checked by chip_smoke.py)."""
    gm, _, X, y, _ = _make_problem(n=40, p=128, b=8, gb=4)  # 4 groups
    st = _init(128, y)
    key = jax.random.PRNGKey(5)
    args = (gm, st["alpha"], st["beta"], st["delta"], st["ycorr"], None,
            st["vare"], st["var_eff"], st["pi"], key)
    out_dev = gr.sweep_blocks_abc_grouped(*args, nreps=3, sync_every=3)
    store_h = gr.to_host_memory(gm.store)
    gm_h = gm._replace(store=store_h)
    out_host = gr.sweep_blocks_abc_grouped(
        gm_h, *args[1:], nreps=3, sync_every=3,
        host_store=gr.host_memory_supported(),
    )
    for a, b_ in zip(out_dev, out_host):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b_))


def test_grouped_multigroup_accuracy_and_agreement():
    """Sequential multi-group chains recover the signal and agree with the
    flat packed sweep's posterior (different update schedule -> compare
    posterior summaries, not draws)."""
    gm, pm, X, y, beta_true = _make_problem(n=160, p=128, b=8, gb=4, seed=2,
                                            signal=0.1)
    n, p = X.shape

    def run(sweep_fn, key, iters=150):
        st = _init(p, y, pi0=0.9)
        alpha, beta, delta, ycorr = (st["alpha"], st["beta"], st["delta"],
                                     st["ycorr"])
        acc = jnp.zeros((p,))
        for i in range(iters):
            alpha, beta, delta, ycorr = sweep_fn(
                alpha, beta, delta, ycorr, st["vare"], st["var_eff"],
                st["pi"], jax.random.fold_in(key, i),
            )
            if i >= 50:
                acc = acc + alpha
        return acc / (iters - 50)

    # per-rep residual sync on the flat sweep (cross-block staleness spans
    # ALL of p there; the grouped schedule confines it to one group)
    def grouped_fn(alpha, beta, delta, ycorr, vare, var_eff, pi, key):
        return gr.sweep_blocks_abc_grouped(
            gm, alpha, beta, delta, ycorr, None, vare, var_eff, pi, key,
            nreps=4, sync_every=4,
        )

    def packed_fn(alpha, beta, delta, ycorr, vare, var_eff, pi, key):
        return sweep_blocks_abc_packed(
            pm, alpha, beta, delta, ycorr, None, vare, var_eff, pi, key,
            nreps=4, sync_every=1,
        )

    am_g = np.asarray(run(grouped_fn, jax.random.PRNGKey(0)))
    am_p = np.asarray(run(packed_fn, jax.random.PRNGKey(0)))
    ebv_g = np.asarray(X) @ am_g
    ebv_p = np.asarray(X) @ am_p
    truth = np.asarray(X) @ beta_true
    assert np.corrcoef(ebv_g, truth)[0, 1] > 0.85
    assert np.corrcoef(ebv_g, ebv_p)[0, 1] > 0.98


def test_grouped_bayesb_per_marker_variance():
    """BayesB: per-marker var_eff vector flows through the grouped schedule."""
    gm, _, X, y, _ = _make_problem(n=40, p=64, b=8, gb=4)
    st = _init(64, y)
    var_b = jnp.asarray(
        np.random.default_rng(1).uniform(0.02, 0.08, size=64), jnp.float32
    )
    out = gr.sweep_blocks_abc_grouped(
        gm, st["alpha"], st["beta"], st["delta"], st["ycorr"], None,
        st["vare"], var_b, st["pi"], jax.random.PRNGKey(3), nreps=2,
    )
    assert np.isfinite(np.asarray(out[0])).all()
    assert np.isfinite(np.asarray(out[3])).all()


def test_pick_group_blocks():
    assert gr.pick_group_blocks(16384) == 256
    assert gr.pick_group_blocks(8192) == 256
    assert gr.pick_group_blocks(128) == 128
    assert gr.pick_group_blocks(96) == 96
    assert gr.pick_group_blocks(7) == 7


def test_plane_gemvs_match_decode_tile():
    """The plane-decomposed GEMVs (sum_j C_j @ w[j::4] with mean/missing
    corrections) equal the decode-tile GEMVs — including missing codes, a
    row permutation, and sub-byte tail padding."""
    rng = np.random.default_rng(8)
    p, n = 96, 45                         # n % 4 != 0: tail padding exercised
    codes = rng.integers(0, 3, size=(p, n))
    codes[rng.uniform(size=(p, n)) < 0.1] = 3          # missing
    packed = jnp.asarray(_pack_codes(codes))
    obs = np.where(codes != 3, codes, np.nan)
    means = np.nanmean(obs, axis=1).astype(np.float32)
    X = np.where(codes == 3, means[:, None], codes).T - means[None, :]
    perm = rng.permutation(n).astype(np.int32)
    Xp = X[perm]                                        # observation order
    w = jnp.asarray(rng.normal(size=n), jnp.float32)
    v = jnp.asarray(rng.normal(size=p), jnp.float32)
    mns = jnp.asarray(means)
    bpm = packed.shape[1]
    w_pad = gr._pad_w(w, bpm, jnp.asarray(perm))
    rhs = gr._plane_rhs(packed, mns, w_pad, has_missing=True)
    np.testing.assert_allclose(np.asarray(rhs), Xp.T @ np.asarray(w),
                               rtol=1e-4, atol=1e-3)
    mv = gr._plane_matvec(packed, mns, v, n, jnp.asarray(perm),
                          has_missing=True)
    np.testing.assert_allclose(np.asarray(mv), Xp @ np.asarray(v),
                               rtol=1e-4, atol=1e-3)
    # identity-perm + sub-chunked variants
    w_pad0 = gr._pad_w(w, bpm, None)
    rhs0 = gr._tile_rhs_planes(packed, mns, w_pad0, sc=32, has_missing=True)
    np.testing.assert_allclose(np.asarray(rhs0), X.T @ np.asarray(w),
                               rtol=1e-4, atol=1e-3)
    mv0 = gr._tile_matvec_planes(packed, mns, v, n, None, sc=32,
                                 has_missing=True)
    np.testing.assert_allclose(np.asarray(mv0), X @ np.asarray(v),
                               rtol=1e-4, atol=1e-3)


def test_grouped_sweep_planes_vs_decode_statistics():
    """The plane and decode-tile GEMVs differ only in float summation order;
    posterior summaries of the grouped sweep must agree."""
    gm, pm, X, y, beta_true = _make_problem(n=160, p=128, b=8, gb=4, seed=2,
                                            signal=0.1)
    st = _init(128, y)
    key = jax.random.PRNGKey(0)

    def run(use_planes):
        alpha, beta, delta, ycorr = (st["alpha"], st["beta"], st["delta"],
                                     st["ycorr"])
        acc = jnp.zeros((128,))
        for i in range(120):
            alpha, beta, delta, ycorr = gr.sweep_blocks_abc_grouped(
                gm, alpha, beta, delta, ycorr, None, st["vare"],
                st["var_eff"], st["pi"], jax.random.fold_in(key, i),
                nreps=4, sync_every=4, use_planes=use_planes,
                has_missing=False,
            )
            if i >= 40:
                acc = acc + alpha
        return np.asarray(acc / 80)

    am_p = run(True)
    am_d = run(False)
    ebv_p = np.asarray(X) @ am_p
    ebv_d = np.asarray(X) @ am_d
    assert np.corrcoef(ebv_p, ebv_d)[0, 1] > 0.98


def test_runmcmc_host_offload_end_to_end(monkeypatch):
    """host_offload_genotypes routes runMCMC through the grouped streaming
    sweep end-to-end (the runtime analogue of the reference's streaming
    driver, streaming_genotypes.jl:978-1027). True on a backend that cannot
    stage pinned-host memory in a jitted sweep (the CPU) raises instead of
    quietly keeping the store on the device; "auto" there runs the
    device-resident grouped sweep; True with staging available takes the
    out-of-core path (CPU stands in for the staging here)."""
    from jwas_tpu import build_model, get_genotypes, runMCMC
    from jwas_tpu.engine import mcmc as eng
    from jwas_tpu.io.datasets import simulate_genomic_data
    from jwas_tpu.io.packed import prepare_packed_genotypes

    sim = simulate_genomic_data(n=400, p=150, n_qtl=15, h2=0.6, seed=77)
    store = prepare_packed_genotypes(sim["genotypes"])
    geno = get_genotypes(store, method="BayesC", name="geno")
    model = build_model("y = intercept + geno", genotypes=geno)
    assert not gr.host_memory_supported()
    with pytest.raises(ValueError, match="host_offload_genotypes=True"):
        runMCMC(model, sim["phenotypes"], chain_length=600, burnin=150,
                seed=5, output_folder="", host_offload_genotypes=True)
    out = runMCMC(model, sim["phenotypes"], chain_length=600, burnin=150,
                  seed=5, output_folder="", host_offload_genotypes="auto")
    acc = np.corrcoef(out["EBV_y"].EBV, sim["true_bv"])[0, 1]
    assert acc > 0.85, f"grouped BayesC EBV accuracy {acc:.3f}"
    # the decision itself where staging exists: True offloads, "auto"
    # offloads only past 60% of the device budget
    monkeypatch.setattr(gr, "host_memory_supported", lambda: True)
    assert eng._resolve_host_offload(True, 10) is True
    assert eng._resolve_host_offload("auto", 10) is False
    assert eng._resolve_host_offload(False, 1 << 60) is False


# ---------------------------------------------------------------------------
# BayesR over the packed / grouped store (an engine capability beyond the
# reference, whose streaming backend is BayesC-only:
# input_data_validation.jl:81-111 vs BayesR.jl:45-97).
# ---------------------------------------------------------------------------


def _init_bayesr(p, y, pi4=(0.9, 0.05, 0.03, 0.02)):
    dtype = jnp.float32
    vy = float(np.var(np.asarray(y)))
    pi_mat = jnp.tile(jnp.asarray(pi4, dtype)[None, :], (p, 1))
    return dict(
        alpha=jnp.zeros((p,), dtype), delta=jnp.zeros((p,), jnp.int32),
        ycorr=jnp.asarray(y, dtype), vare=jnp.asarray(0.5 * vy, dtype),
        sigma_sq=jnp.asarray(0.5 * vy / (p * 0.05), dtype), pi=pi_mat,
    )


def test_bayesr_packed_matches_dense_blocks():
    """The packed BayesR sweep consumes the same draws as the dense blocked
    sweep and must produce the same chain (decode(X) == dense X exactly)."""
    from jwas_tpu.ops.packed import sweep_blocks_bayesr_packed

    gm, pm, X, y, _ = _make_problem(n=48, p=64, b=8, gb=8)
    st = _init_bayesr(64, y)
    key = jax.random.PRNGKey(21)
    md = mk.build_marker_blocks(X, block_size=8)
    out_d = mk.sweep_blocks_bayesr(
        md, st["alpha"], st["delta"], st["ycorr"], None, st["vare"],
        st["sigma_sq"], st["pi"], key, nreps=4, sync_every=2,
    )
    out_p = sweep_blocks_bayesr_packed(
        pm, st["alpha"], st["delta"], st["ycorr"], None, st["vare"],
        st["sigma_sq"], st["pi"], key, nreps=4, sync_every=2,
    )
    np.testing.assert_array_equal(np.asarray(out_d[1]), np.asarray(out_p[1]))
    for a, b_ in zip(out_d, out_p):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b_),
                                   rtol=2e-5, atol=2e-5)


def test_bayesr_single_group_equals_flat_packed():
    """One group: the grouped BayesR schedule IS the flat packed sweep
    (key convention fold_in(key, 0), like the ABC sweeps)."""
    from jwas_tpu.ops.packed import sweep_blocks_bayesr_packed

    gm, pm, X, y, _ = _make_problem(n=48, p=64, b=8, gb=8)  # ngroups = 1
    st = _init_bayesr(64, y)
    key = jax.random.PRNGKey(13)
    out_g = gr.sweep_blocks_bayesr_grouped(
        gm, st["alpha"], st["delta"], st["ycorr"], None, st["vare"],
        st["sigma_sq"], st["pi"], key, nreps=4, sync_every=2,
        use_planes=False,
    )
    out_p = sweep_blocks_bayesr_packed(
        pm, st["alpha"], st["delta"], st["ycorr"], None, st["vare"],
        st["sigma_sq"], st["pi"], jax.random.fold_in(key, 0),
        nreps=4, sync_every=2,
    )
    np.testing.assert_array_equal(np.asarray(out_g[1]), np.asarray(out_p[1]))
    for a, b_ in zip(out_g, out_p):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b_),
                                   rtol=2e-5, atol=2e-5)


def test_bayesr_grouped_host_store_bit_equal():
    """host_store=True streams the same bits for the BayesR grouped sweep."""
    gm, _, X, y, _ = _make_problem(n=40, p=128, b=8, gb=4)  # 4 groups
    st = _init_bayesr(128, y)
    key = jax.random.PRNGKey(7)
    args = (st["alpha"], st["delta"], st["ycorr"], None, st["vare"],
            st["sigma_sq"], st["pi"], key)
    out_dev = gr.sweep_blocks_bayesr_grouped(gm, *args, nreps=3, sync_every=3)
    gm_h = gm._replace(store=gr.to_host_memory(gm.store))
    out_host = gr.sweep_blocks_bayesr_grouped(
        gm_h, *args, nreps=3, sync_every=3,
        host_store=gr.host_memory_supported(),
    )
    for a, b_ in zip(out_dev, out_host):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b_))


def test_bayesr_grouped_multigroup_accuracy():
    """Sequential multi-group BayesR recovers the signal; class labels stay
    in {0..3} and the spike class dominates under a sparse simulation."""
    gm, pm, X, y, beta_true = _make_problem(n=160, p=128, b=8, gb=4, seed=2,
                                            signal=0.1)
    st = _init_bayesr(128, y)
    key = jax.random.PRNGKey(0)
    alpha, delta, ycorr = st["alpha"], st["delta"], st["ycorr"]
    acc = jnp.zeros((128,))
    for i in range(150):
        alpha, delta, ycorr = gr.sweep_blocks_bayesr_grouped(
            gm, alpha, delta, ycorr, None, st["vare"], st["sigma_sq"],
            st["pi"], jax.random.fold_in(key, i), nreps=4, sync_every=4,
        )
        if i >= 50:
            acc = acc + alpha
    am = np.asarray(acc / 100)
    d = np.asarray(delta)
    assert d.min() >= 0 and d.max() <= 3
    ebv = np.asarray(X) @ am
    truth = np.asarray(X) @ beta_true
    assert np.corrcoef(ebv, truth)[0, 1] > 0.8


def test_grouped_pallas_matches_xla_abc_and_bayesr():
    """use_pallas=True (interpret) reproduces the XLA grouped sweeps exactly
    for both the spike-slab and the BayesR kernels (2 sequential groups of
    128 blocks)."""
    gm, pm, X, y, _ = _make_problem(n=40, p=8 * 256, b=8, gb=128, seed=9)
    p = X.shape[1]
    st = _init(p, y)
    key = jax.random.PRNGKey(21)
    args = (st["alpha"], st["beta"], st["delta"], st["ycorr"], None,
            st["vare"], st["var_eff"], st["pi"], key)
    out_x = gr.sweep_blocks_abc_grouped(gm, *args, nreps=3, sync_every=2)
    out_p = gr.sweep_blocks_abc_grouped(gm, *args, nreps=3, sync_every=2,
                                        use_pallas=True, interpret=True)
    for a, b_ in zip(out_x, out_p):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b_),
                                   rtol=1e-5, atol=1e-5)

    pi_r = jnp.broadcast_to(
        jnp.asarray([0.9, 0.05, 0.03, 0.02], jnp.float32), (p, 4)
    )
    argsr = (st["alpha"], jnp.zeros((p,), jnp.int32), st["ycorr"], None,
             st["vare"], jnp.asarray(0.3, jnp.float32), pi_r, key)
    out_xr = gr.sweep_blocks_bayesr_grouped(gm, *argsr, nreps=3, sync_every=2)
    out_pr = gr.sweep_blocks_bayesr_grouped(gm, *argsr, nreps=3, sync_every=2,
                                            use_pallas=True, interpret=True)
    np.testing.assert_array_equal(np.asarray(out_xr[1]), np.asarray(out_pr[1]))
    np.testing.assert_allclose(np.asarray(out_xr[0]), np.asarray(out_pr[0]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out_xr[2]), np.asarray(out_pr[2]),
                               rtol=1e-4, atol=1e-4)


def test_runmcmc_packed_bayesr_end_to_end():
    """runMCMC with storage='2bit' + BayesR routes through the grouped
    BayesR sweep (offload off, and "auto") and recovers the signal."""
    from jwas_tpu import build_model, get_genotypes, runMCMC
    from jwas_tpu.io.datasets import simulate_genomic_data
    from jwas_tpu.io.packed import prepare_packed_genotypes

    sim = simulate_genomic_data(n=400, p=150, n_qtl=15, h2=0.6, seed=78)
    store = prepare_packed_genotypes(sim["genotypes"])
    for offload in (False, "auto"):
        geno = get_genotypes(store, method="BayesR", name="geno")
        model = build_model("y = intercept + geno", genotypes=geno)
        out = runMCMC(model, sim["phenotypes"], chain_length=600, burnin=150,
                      seed=5, output_folder="",
                      host_offload_genotypes=offload)
        acc = np.corrcoef(out["EBV_y"].EBV, sim["true_bv"])[0, 1]
        assert acc > 0.85, (
            f"packed BayesR (offload={offload}) EBV accuracy {acc:.3f}"
        )
        pi = out["pi_geno"]
        assert len(pi) == 4 and abs(pi["Estimate"].sum() - 1.0) < 0.05


def test_hybrid_dev_store_matches_host_only():
    """A GroupedPackedMarkers with the leading k groups duplicated on
    'device' (hybrid out-of-core split) produces BIT-IDENTICAL sweeps: the
    split only changes where bytes are fetched from."""
    gm, pm, X, y, _ = _make_problem(n=48, p=128, b=8, gb=4, seed=6)  # 4 groups
    st = _init(128, y)
    key = jax.random.PRNGKey(2)
    args = (st["alpha"], st["beta"], st["delta"], st["ycorr"], None,
            st["vare"], st["var_eff"], st["pi"], key)
    base = gr.sweep_blocks_abc_grouped(gm, *args, nreps=4, sync_every=2)
    for k in (1, 2, 4):
        gm_h = gm._replace(dev_store=jnp.asarray(np.asarray(gm.store[:k])))
        out = gr.sweep_blocks_abc_grouped(gm_h, *args, nreps=4, sync_every=2)
        for a, b_ in zip(base, out):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b_))
    # BayesR sweep through the same split
    pi_r = jnp.broadcast_to(jnp.asarray([0.9, 0.05, 0.03, 0.02], jnp.float32),
                            (128, 4))
    argsr = (st["alpha"], jnp.zeros((128,), jnp.int32), st["ycorr"], None,
             st["vare"], jnp.asarray(0.3, jnp.float32), pi_r, key)
    base_r = gr.sweep_blocks_bayesr_grouped(gm, *argsr, nreps=3, sync_every=3)
    gm_h = gm._replace(dev_store=jnp.asarray(np.asarray(gm.store[:2])))
    out_r = gr.sweep_blocks_bayesr_grouped(gm_h, *argsr, nreps=3, sync_every=3)
    for a, b_ in zip(base_r, out_r):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b_))


def test_plan_device_groups_budget():
    assert gr.plan_device_groups(10, 100, 50, 0, budget=7 << 29) == 0
    k = gr.plan_device_groups(128, 16384, 12544, 1 << 30,
                              budget=16_000_000_000)
    assert 0 < k < 128
    assert k * 16384 * 12544 <= 16_000_000_000 - (1 << 30) - (7 << 29)


def test_pick_stable_blocks_caps_stale_set():
    """The parallel-stale set b*gb never exceeds STALE_FRACTION * n; 128
    blocks per group are kept by shrinking b when possible."""
    for n, b_req, p in [(50_000, 224, 2_097_152), (25_000, 158, 1_048_576),
                        (12_000, 112, 1_048_576), (2_000, 48, 100_000),
                        (400, 24, 150), (300, 24, 5_000)]:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            b, gb = gr.pick_stable_blocks(n, b_req, p)
        cap = min(max(8, int(gr.STALE_FRACTION * n)), max(p, 8))
        assert b * gb <= cap, (n, b_req, p, b, gb)
        assert b >= 8 and b % 8 == 0
        assert gb >= 1
        if n >= 2_560 and -(-p // 8) >= 128:
            assert gb == 128, (n, p, b, gb)   # tuned geometry preserved


def test_runmcmc_device_packed_routes_grouped():
    """Device-resident packed stores run the grouped schedule (bounded stale
    set) — the flat sweep's all-of-p staleness is metastable at p >> n."""
    from jwas_tpu import build_model, get_genotypes, runMCMC
    from jwas_tpu.io.datasets import simulate_genomic_data
    from jwas_tpu.io.packed import prepare_packed_genotypes
    from jwas_tpu.engine import mcmc as eng

    sim = simulate_genomic_data(n=300, p=120, n_qtl=10, h2=0.6, seed=17)
    store = prepare_packed_genotypes(sim["genotypes"])
    geno = get_genotypes(store, method="BayesC", name="geno")
    model = build_model("y = intercept + geno", genotypes=geno)
    seen = {}
    orig = eng.make_run_window

    def spy(cfg):
        seen["grouped"] = cfg.grouped
        seen["host_offload"] = cfg.host_offload
        return orig(cfg)

    eng.make_run_window = spy
    try:
        out = runMCMC(model, sim["phenotypes"], chain_length=400, burnin=100,
                      seed=3, output_folder="", host_offload_genotypes=False)
    finally:
        eng.make_run_window = orig
    assert seen["grouped"] is True
    assert seen["host_offload"] is False     # device-resident store
    acc = np.corrcoef(out["EBV_y"].EBV, sim["true_bv"])[0, 1]
    assert acc > 0.8, acc


def test_materialize_grouped_host_roundtrip():
    def gen(g):
        return jax.random.randint(
            jax.random.fold_in(jax.random.PRNGKey(0), g), (16, 8), 0, 255,
            jnp.uint8,
        )

    store = gr.materialize_grouped_host(gen, ngroups=3, G=16, bpm=8)
    assert store.shape == (3, 16, 8)
    ref = np.stack([np.asarray(gen(g)) for g in range(3)])
    np.testing.assert_array_equal(np.asarray(store), ref)


# ---------------------------------------------------------------------------
# Lowering-constant guard: every jitted function that touches a grouped store
# must take the store as a TRACED argument. Closing over a pinned-host store
# captures it as a lowering constant (26 GB at the north-star shape) — the
# exact bug class that broke hybridize/out-of-core runMCMC in round 4. This
# runs on CPU (tracing does not need pinned-host memory).
# ---------------------------------------------------------------------------

_CONST_LIMIT_BYTES = 1 << 20  # 1 MB


def _closed_jaxpr_const_bytes(closed):
    """Total bytes of materialized constants, recursing into sub-jaxprs
    (pjit / scan / cond bodies carry their own ClosedJaxpr consts)."""
    total = 0
    seen = set()

    def walk(cj):
        if id(cj) in seen:
            return
        seen.add(id(cj))
        for c in cj.consts:
            total_nbytes = getattr(c, "nbytes", None)
            if total_nbytes is None:
                total_nbytes = np.asarray(c).nbytes
            nonlocal total
            total += int(total_nbytes)
        for eqn in cj.jaxpr.eqns:
            for v in eqn.params.values():
                if hasattr(v, "jaxpr") and hasattr(v, "consts"):
                    walk(v)
                elif isinstance(v, (list, tuple)):
                    for vv in v:
                        if hasattr(vv, "jaxpr") and hasattr(vv, "consts"):
                            walk(vv)

    walk(closed)
    return total


def test_no_large_lowering_constants_in_grouped_store_fns():
    gm, pm, X, y, _ = _make_problem(n=48, p=128, b=8, gb=4, seed=3)
    st = _init(128, y)
    key = jax.random.PRNGKey(0)
    pi4 = jnp.broadcast_to(
        jnp.asarray([0.9, 0.05, 0.03, 0.02], jnp.float32), (128, 4)
    )
    cases = [
        ("_hybrid_copy",
         lambda s: gr._hybrid_copy(s, k=2), (gm.store,)),
        ("grouped_matvec",
         lambda g, v: gr.grouped_matvec(g, v, n_obs=48), (gm, st["alpha"])),
        ("grouped_rhs",
         lambda g, w: gr.grouped_rhs(g, w), (gm, st["ycorr"])),
        ("grouped_stats",
         lambda s, m, v: gr.grouped_stats(s, m, v, None, None, b=8, n_obs=48),
         (gm.store, gm.means, gm.valid)),
        ("sweep_blocks_abc_grouped",
         lambda g, a, b_, d, yc, va, ve, pi, k: gr.sweep_blocks_abc_grouped(
             g, a, b_, d, yc, None, va, ve, pi, k, nreps=2),
         (gm, st["alpha"], st["beta"], st["delta"], st["ycorr"],
          st["vare"], st["var_eff"], st["pi"], key)),
        ("sweep_blocks_bayesr_grouped",
         lambda g, a, d, yc, va, s2, pi, k: gr.sweep_blocks_bayesr_grouped(
             g, a, d, yc, None, va, s2, pi, k, nreps=2),
         (gm, st["alpha"], jnp.zeros((128,), jnp.int32), st["ycorr"],
          st["vare"], jnp.asarray(0.3, jnp.float32), pi4, key)),
    ]
    for name, fn, args in cases:
        closed = jax.make_jaxpr(fn)(*args)
        nbytes = _closed_jaxpr_const_bytes(closed)
        assert nbytes < _CONST_LIMIT_BYTES, (
            f"{name} captures {nbytes} bytes of lowering constants "
            f"(limit {_CONST_LIMIT_BYTES}); pass arrays as jit arguments, "
            f"never close over a (pinned-host) store"
        )


def test_hybridize_does_not_close_over_store():
    """hybridize's copy routine takes the store as a traced jit argument —
    its jaxpr must reference the store only through an input var (the
    round-4 regression captured the full store as a 26 GB constant)."""
    gm, *_ = _make_problem(n=48, p=128, b=8, gb=4, seed=4)
    closed = jax.make_jaxpr(lambda s: gr._hybrid_copy(s, k=3))(gm.store)
    assert _closed_jaxpr_const_bytes(closed) < _CONST_LIMIT_BYTES
    dev = gr._hybrid_copy(gm.store, k=3)
    np.testing.assert_array_equal(np.asarray(dev), np.asarray(gm.store[:3]))


def test_pick_stable_blocks_tiny_n_stays_under_cap():
    """For n < 160 the cap is NOT floored at 64 (a 64-marker stale set at
    n=100 is q=0.64, at the measured divergence threshold — advisor
    regression): tiny problems degrade to q <= 0.4 via b=8, gb=1."""
    for n in (20, 50, 100, 150):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            b, gb = gr.pick_stable_blocks(n, 64, 5_000)
        assert b * gb <= max(8, int(gr.STALE_FRACTION * n)), (n, b, gb)


def test_pick_stable_blocks_warns_on_override():
    with pytest.warns(UserWarning, match="stability cap"):
        gr.pick_stable_blocks(100, 224, 2_097_152)
    # honored request: no warning
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        gr.pick_stable_blocks(50_000, 128, 2_097_152)
