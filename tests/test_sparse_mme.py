"""Sparse (matrix-free) location-MME: matvec/diag exactness vs dense,
PO-CG draw moments, and end-to-end engine equivalence.

The reference runs its location Gibbs on a sparse LHS
(src/1.JWAS/src/iterative_solver/solver.jl:105-162, assembly
build_MME.jl:300-382); ops/sparse_mme.py is the accelerator analogue
(matrix-free operators + joint perturbation-optimization CG draws).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

from jwas_tpu.engine.state import REGroupCfg
from jwas_tpu.io.pedigree import get_pedigree
from jwas_tpu.ops import sparse_mme as sm


def _random_pedigree(n, seed=0):
    rng = np.random.default_rng(seed)
    ids = [f"a{i}" for i in range(n)]
    sire, dam = [], []
    for i in range(n):
        if i < 4:
            sire.append("missing")
            dam.append("missing")
        else:
            s, d = rng.choice(i, size=2, replace=False)
            sire.append(ids[s])
            dam.append(ids[d])
    return get_pedigree(
        pd.DataFrame({"ID": ids, "Sire": sire, "Dam": dam})
    )


def _small_problem(n=60, seed=1):
    """Intercept + covariate + pedigree random term + iid litter term."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    ped = _random_pedigree(24, seed)
    q = 24
    lit_q = 6
    # W = [1 | x | Z_animal | Z_litter]
    animal = rng.integers(0, q, n)
    litter = rng.integers(0, lit_q, n)
    x = rng.normal(size=n)
    W = np.zeros((n, 2 + q + lit_q))
    W[:, 0] = 1.0
    W[:, 1] = x
    W[np.arange(n), 2 + animal] = 1.0
    W[np.arange(n), 2 + q + litter] = 1.0
    rinv = rng.uniform(0.5, 2.0, n)

    hAi = ped.a_inverse_factor()
    Ai = (hAi.T @ hAi).tocsr()

    class G:  # minimal REGroupData stand-in
        pass

    g1 = G()
    g1.n_levels = q
    g1.Vinv = Ai
    g1.Vinv_factor = hAi
    g2 = G()
    g2.n_levels = lit_q
    g2.Vinv = None
    g2.Vinv_factor = None
    re_groups = [g1, g2]
    re_cfgs = [
        REGroupCfg(starts=(2,), n_levels=q, df=4.0, has_vinv=True,
                   random_type="A", factor_rows=hAi.shape[0]),
        REGroupCfg(starts=(2 + q,), n_levels=lit_q, df=4.0, has_vinv=False,
                   random_type="I"),
    ]
    sl = sm.build_sparse_loc(sp.csr_matrix(W), rinv, re_groups, re_cfgs)
    return W, rinv, Ai, sl, re_cfgs, (2, q, lit_q)


def _dense_A(W, rinv, Ai, gis, vare, layout):
    off, q, lit_q = layout
    A = (W * rinv[:, None]).T @ W
    A[off:off + q, off:off + q] += np.asarray(Ai.todense()) * gis[0] * vare
    A[off + q:, off + q:] += np.eye(lit_q) * gis[1] * vare
    return A


def test_matvec_and_diag_match_dense():
    W, rinv, Ai, sl, re_cfgs, layout = _small_problem()
    K = W.shape[1]
    gis = [np.array([[0.7]]), np.array([[2.1]])]
    vare = 1.3
    A = _dense_A(W, rinv, Ai, [0.7, 2.1], vare, layout)
    x = np.random.default_rng(2).normal(size=K)

    got = sm.mme_matvec(sl, re_cfgs, jnp.asarray(x, jnp.float32),
                        [jnp.asarray(g, jnp.float32) for g in gis],
                        jnp.asarray(vare, jnp.float32),
                        jnp.asarray(rinv, jnp.float32), W.shape[0])
    np.testing.assert_allclose(np.asarray(got), A @ x, rtol=2e-4, atol=2e-4)

    d = sm.mme_diag(sl, re_cfgs,
                    [jnp.asarray(g, jnp.float32) for g in gis],
                    jnp.asarray(vare, jnp.float32))
    np.testing.assert_allclose(np.asarray(d), np.diag(A), rtol=2e-4)

    # W matvec / rhs
    v = np.random.default_rng(3).normal(size=W.shape[0])
    np.testing.assert_allclose(
        np.asarray(sm.w_matvec(sl, jnp.asarray(x, jnp.float32), W.shape[0])),
        W @ x, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        np.asarray(sm.w_rhs(sl, jnp.asarray(v, jnp.float32), K)),
        W.T @ v, rtol=2e-4, atol=2e-4)


def test_cg_solve_matches_dense_solve():
    W, rinv, Ai, sl, re_cfgs, layout = _small_problem()
    K = W.shape[1]
    gis_np = [0.9, 1.7]
    vare = 0.8
    A = _dense_A(W, rinv, Ai, gis_np, vare, layout)
    b = np.random.default_rng(4).normal(size=K)
    x_ref = np.linalg.solve(A, b)
    x = sm.cg_solve(sl, re_cfgs, jnp.asarray(b, jnp.float32),
                    [jnp.asarray([[g]], jnp.float32) for g in gis_np],
                    jnp.asarray(vare, jnp.float32),
                    jnp.asarray(rinv, jnp.float32), W.shape[0],
                    tol=1e-10, maxiter=500)
    np.testing.assert_allclose(np.asarray(x), x_ref, rtol=5e-3, atol=5e-3)


def test_po_draw_moments():
    """sol ~ N(A^-1 rhs, vare A^-1): joint-draw mean and covariance match
    the analytic Gaussian (the kernel-exactness test pattern,
    test_multitrait_mcmc.jl:6-60)."""
    W, rinv, Ai, sl, re_cfgs, layout = _small_problem(n=40)
    K = W.shape[1]
    gis_np = [1.1, 2.0]
    vare = 0.7
    A = _dense_A(W, rinv, Ai, gis_np, vare, layout)
    rhs = np.random.default_rng(5).normal(size=K)
    mu = np.linalg.solve(A, rhs)
    cov = vare * np.linalg.inv(A)

    gis = [jnp.asarray([[g]], jnp.float32) for g in gis_np]
    chols = [jnp.linalg.cholesky(g) for g in gis]
    draw = jax.jit(lambda k: sm.sample_location_po(
        k, sl, re_cfgs, jnp.asarray(rhs, jnp.float32), gis,
        jnp.asarray(vare, jnp.float32), jnp.asarray(rinv, jnp.float32),
        W.shape[0], chols, tol=1e-10, maxiter=400))
    keys = jax.random.split(jax.random.PRNGKey(0), 3000)
    xs = np.asarray(jax.vmap(draw)(keys))
    se = np.sqrt(np.diag(cov) / len(xs))
    assert np.all(np.abs(xs.mean(0) - mu) < 5 * se + 5e-3), (
        np.max(np.abs(xs.mean(0) - mu) / (se + 1e-9)))
    # covariance: compare a stable summary (variances) within MC error
    var_emp = xs.var(0)
    var_ref = np.diag(cov)
    np.testing.assert_allclose(var_emp, var_ref, rtol=0.25, atol=5e-3)


def test_runmcmc_sparse_matches_dense_location():
    """End-to-end: a pedigree model run with sparse_location=True produces
    the same posterior means (within MC error) and EBV ordering as the
    dense single-site engine."""
    from jwas_tpu import build_model, runMCMC, set_random

    rng = np.random.default_rng(7)
    ped = _random_pedigree(120, seed=7)
    n_ids = len(ped.ids)
    A = ped.a_matrix()
    u = np.linalg.cholesky(A + 1e-8 * np.eye(n_ids)) @ rng.normal(
        size=n_ids)
    ids = list(ped.ids)
    y = 3.0 + u + rng.normal(size=n_ids) * 0.7
    df = pd.DataFrame({"ID": ids, "y": y})

    outs = {}
    for mode in (False, True):
        model = build_model("y = intercept + ID")
        set_random(model, "ID", ped, np.array(1.0))
        outs[mode] = runMCMC(
            model, df, chain_length=3000, burnin=500, seed=10,
            output_folder="", sparse_location=mode, outputEBV=True,
            printout_model_info=False,
        )
    ebv_d = outs[False]["EBV_y"].set_index("ID").EBV
    ebv_s = outs[True]["EBV_y"].set_index("ID").EBV
    ebv_s = ebv_s.reindex(ebv_d.index)
    corr = np.corrcoef(ebv_d, ebv_s)[0, 1]
    assert corr > 0.95, corr
    acc_s = np.corrcoef(ebv_s.reindex(ids), u)[0, 1]
    acc_d = np.corrcoef(ebv_d.reindex(ids), u)[0, 1]
    assert acc_s > acc_d - 0.1, (acc_s, acc_d)
    # variance components agree within MC error
    vc_d = float(outs[False]["location parameters variances"]["Estimate"].iloc[0]) \
        if "location parameters variances" in outs[False] else None
    for k in outs[False]:
        if "residual variance" in k:
            rd = float(np.asarray(outs[False][k]["Estimate"])[0])
            rs = float(np.asarray(outs[True][k]["Estimate"])[0])
            assert abs(rd - rs) / rd < 0.3, (k, rd, rs)


def test_solve_sparse_100k_levels():
    """solve() on a pedigree MME with 1e5 levels — impossible dense (the
    (K, K) LHS alone is 80 GB): the sparse path (auto at K > 20k) assembles
    SciPy CSR and solves with CG/Jacobi. BLUP accuracy is checked against
    breeding values simulated through the exact A factor (u = hAi^-1 z)."""
    import time

    import scipy.sparse as sp
    from scipy.sparse.linalg import spsolve_triangular

    from jwas_tpu import build_model, set_random, solve

    n_ped = 100_000
    rng = np.random.default_rng(17)
    ids = np.array([f"i{k}" for k in range(n_ped)])
    anc = rng.integers(0, np.maximum(np.arange(n_ped), 1), size=(2, n_ped))
    sire = np.where(np.arange(n_ped) < 50, "missing", ids[anc[0]])
    dam = np.where(np.arange(n_ped) < 50, "missing", ids[anc[1]])
    t0 = time.time()
    ped = get_pedigree(pd.DataFrame({"ID": ids, "S": sire, "D": dam}))
    hAi = ped.a_inverse_factor()
    # u ~ N(0, A): A^-1 = hAi' hAi => u = hAi^-1 z (hAi is lower triangular
    # in topological order)
    z = rng.normal(size=n_ped)
    u = spsolve_triangular(hAi.tocsr(), z, lower=True)
    u = u / u.std()

    n_obs = 30_000
    obs = rng.choice(n_ped, size=n_obs, replace=False)
    code = {s: i for i, s in enumerate(ped.ids)}
    y = 5.0 + u[[code[ids[i]] for i in obs]] + rng.normal(size=n_obs)
    df = pd.DataFrame({"ID": ids[obs], "y": y})

    def fresh_model():
        m = build_model("y = intercept + ID")
        set_random(m, "ID", ped, np.array(1.0))
        return m

    out = solve(fresh_model(), df, solver="CG", maxiter=500, tolerance=1e-10)
    assert len(out) == 1 + n_ped
    est = out["Estimate"].to_numpy()[1:]          # animal block
    # order of levels = ped.ids (set_random names)
    acc = np.corrcoef(est, u)[0, 1]
    assert acc > 0.55, acc                        # h2=0.5, 30% phenotyped
    elapsed = time.time() - t0
    assert elapsed < 300, f"sparse solve at 1e5 levels took {elapsed:.0f}s"

    # Jacobi agrees with CG on the same system (models are consumed by
    # solve, as in the reference: rebuild)
    out_j = solve(fresh_model(), df, solver="Jacobi", maxiter=2000,
                  tolerance=1e-12)
    cj = np.corrcoef(out_j["Estimate"].to_numpy()[1:], est)[0, 1]
    assert cj > 0.999, cj


def test_sparse_location_forced_invalid_combos_raise():
    from jwas_tpu import build_model, runMCMC

    rng = np.random.default_rng(2)
    ids = [f"q{i}" for i in range(30)]
    df = pd.DataFrame({"ID": ids, "y1": rng.normal(size=30),
                       "y2": rng.normal(size=30)})
    model = build_model("y1 = intercept\ny2 = intercept")
    with pytest.raises(ValueError, match="single-trait"):
        runMCMC(model, df, chain_length=5, output_folder="",
                sparse_location=True)


def test_runmcmc_sparse_multi_term_group_matches_dense():
    """A TWO-term correlated pedigree group (direct + maternal) through the
    sparse engine: exercises the k>1 branches of the PO sampler's
    (L_G x F') prior-noise term and the sparse VC quadratic forms, which
    the single-term tests cannot reach. Dense and sparse runs must agree
    on EBVs and the 2x2 VC estimate within MC error."""
    from jwas_tpu import build_model, runMCMC, set_random

    rng = np.random.default_rng(21)
    ped = _random_pedigree(150, seed=21)
    ids = list(ped.ids)
    n_ids = len(ids)
    A = ped.a_matrix()
    Lch = np.linalg.cholesky(A + 1e-8 * np.eye(n_ids))
    G0 = np.array([[1.0, 0.4], [0.4, 0.6]])
    LG = np.linalg.cholesky(G0)
    z = rng.normal(size=(n_ids, 2)) @ LG.T
    u = Lch @ z                        # (n, 2) correlated direct+maternal
    dam_of = {ids[i]: (ids[ped.dam[i]] if ped.dam[i] >= 0 else ids[0])
              for i in range(n_ids)}
    y = (2.0 + u[:, 0]
         + np.array([u[ids.index(dam_of[s]), 1] for s in ids])
         + rng.normal(size=n_ids) * 0.8)
    df = pd.DataFrame({"ID": ids, "dam": [dam_of[s] for s in ids], "y": y})

    outs = {}
    for mode in (False, True):
        model = build_model("y = intercept + ID + dam")
        set_random(model, "ID dam", ped, G0)
        outs[mode] = runMCMC(model, df, chain_length=2500, burnin=500,
                             seed=6, output_folder="", sparse_location=mode,
                             printout_model_info=False)
    ebv_d = outs[False]["EBV_y"].set_index("ID").EBV
    ebv_s = outs[True]["EBV_y"].set_index("ID").EBV.reindex(ebv_d.index)
    corr = np.corrcoef(ebv_d, ebv_s)[0, 1]
    assert corr > 0.9, corr
    # the 2x2 VC estimates agree within MC error
    key = [k for k in outs[False] if "polygenic" in k or "ID" in k
           and "variance" in k.lower()]
    for k in outs[False]:
        if "variance" in k.lower() and "residual" not in k.lower():
            vd = np.asarray(outs[False][k]["Estimate"], dtype=float)
            vs = np.asarray(outs[True][k]["Estimate"], dtype=float)
            if vd.size:
                assert np.all(np.abs(vd - vs) / (np.abs(vd) + 0.2) < 0.5), (
                    k, vd, vs)
