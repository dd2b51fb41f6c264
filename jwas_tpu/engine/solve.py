"""Non-MCMC solution of the mixed-model equations.

Equivalent of the reference `solve` (src/1.JWAS/src/iterative_solver/solver.jl:7-54):
builds the MME for the (marker-free) model and solves it with Jacobi,
Gauss-Seidel, or a multi-pass Gibbs sampler.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from jwas_tpu.engine.setup import MCMCOptions, prepare_workspace
from jwas_tpu.models.model import Model
from jwas_tpu.ops.location import gauss_seidel, gibbs_solver, jacobi
from jwas_tpu.utils.backend import enable_compile_cache


def solve(
    model: Model,
    df: pd.DataFrame,
    *,
    solver: str = "default",
    printout_frequency: int = 100,
    tolerance: float = 1e-6,
    maxiter: int = 5000,
    heterogeneous_residuals: bool = False,
    double_precision: bool = False,
    sparse_location=None,
):
    """Solve the MME without estimating variance components.

    Returns a DataFrame [name, estimate] for iterative solvers, or the tuple
    (names, X, LHS, RHS) for solver="default".

    sparse_location: None (auto: single-trait and K > 20_000), True, or
    False. The sparse path assembles a SciPy CSR LHS — the reference's
    SparseArrays MME (build_MME.jl:300-382) — and supports 'Jacobi',
    'Gauss-Seidel' (via sparse triangular solves), 'CG', and 'Gibbs'
    (joint perturbation-optimization draws, ops/sparse_mme.py); it scales
    to >= 1e5 levels where the dense (K, K) LHS cannot exist.
    """
    enable_compile_cache()
    opts = MCMCOptions(
        heterogeneous_residuals=heterogeneous_residuals,
        double_precision=double_precision,
        outputEBV=False,
        output_heritability=False,
        output_folder="",
        sparse_location=sparse_location,
    )
    ws = prepare_workspace(model, df, opts)
    if ws.W_sparse is not None:
        return _solve_sparse(model, ws, solver=solver, tolerance=tolerance,
                             maxiter=maxiter)
    W = ws.W
    rinv = ws.rinv if ws.rinv is not None else np.ones(ws.n_obs * ws.n_traits)
    if ws.n_traits == 1:
        LHS = (W * rinv[:, None]).T @ W
        RHS = W.T @ (rinv * ws.y)
    else:
        # W' (Ri x I_n) W assembled per trait-block pair — NEVER materializes
        # the (n t, n t) kron, so the MME scales to the reference's sparse
        # solver sizes (solver.jl:7-54): LHS[k,l] = sum_{s,u} Ri[s,u]
        # (W_s' W_u)[k,l] with W_s = the trait-s row block of W.
        import scipy.sparse as sp

        t_, n_ = ws.n_traits, ws.n_obs
        Ri = np.linalg.inv(ws.vare0)
        Wb = [sp.csr_matrix(W[s * n_ : (s + 1) * n_]) for s in range(t_)]
        yb = ws.y.reshape(t_, n_)
        K = W.shape[1]
        LHS = np.zeros((K, K))
        RHS = np.zeros(K)
        for s in range(t_):
            for u in range(t_):
                if Ri[s, u] == 0.0:
                    continue
                LHS += Ri[s, u] * np.asarray((Wb[s].T @ Wb[u]).todense())
                RHS += Ri[s, u] * (Wb[s].T @ yb[u])

    # random-effect parts (addVinv): lambda version for single trait
    for grp in ws.re_groups:
        Gi = np.linalg.inv(grp.G0)
        q = grp.n_levels
        for i, si in enumerate(grp.starts):
            for j, sj in enumerate(grp.starts):
                lam = Gi[i, j] * (float(ws.vare0) if ws.n_traits == 1 else 1.0)
                block = grp.Vinv if grp.Vinv is not None else np.eye(q)
                LHS[si : si + q, sj : sj + q] += block * lam

    names = model.term_names()
    if solver == "default":
        print("To solve the equations, please choose a solver: "
              "'Jacobi', 'Gauss-Seidel', or 'Gibbs'.")
        return names, W, LHS, RHS
    if solver == "Jacobi":
        x = jacobi(LHS, RHS, tolerance=tolerance, maxiter=maxiter)
    elif solver == "Gauss-Seidel":
        x = gauss_seidel(LHS, RHS, tolerance=tolerance, maxiter=maxiter)
    elif solver == "CG":
        # same surface as the sparse path so solver='CG' works regardless
        # of which side of the auto-sparse threshold the model lands on
        import scipy.sparse as sp
        from scipy.sparse.linalg import cg as sp_cg

        D = np.diag(LHS)
        free = D > 0
        Dsafe = np.where(free, D, 1.0)
        A = LHS + np.diag((~free).astype(np.float64))
        x, _ = sp_cg(A, np.where(free, RHS, 0.0),
                     rtol=max(tolerance, 1e-12), maxiter=maxiter,
                     M=sp.diags(1.0 / Dsafe))
        x = np.where(free, x, 0.0)
    elif solver == "Gibbs":
        vare = float(ws.vare0) if ws.n_traits == 1 else None
        x = np.asarray(gibbs_solver(LHS, RHS, vare=vare, niter=maxiter))
    else:
        raise ValueError(
            "solver must be 'default', 'Jacobi', 'Gauss-Seidel', 'CG', or "
            "'Gibbs'"
        )
    return pd.DataFrame({"Name": names, "Estimate": np.asarray(x)})


def _solve_sparse(model, ws, *, solver, tolerance, maxiter):
    """Sparse-LHS solve for large location MMEs (single-trait lambda form).

    The LHS is assembled once as SciPy CSR — the analogue of the reference's
    sparse getMME (build_MME.jl:300-382) — then solved with the requested
    iterative method. 'Gibbs' draws joint PO-CG samples (exact draws from
    N(LHS^-1 RHS, vare LHS^-1); ops/sparse_mme.py) and returns the running
    mean, matching the dense Gibbs solver's estimand (solver.jl:105-140)
    without its sequential scalar pass.
    """
    import scipy.sparse as sp
    from scipy.sparse.linalg import cg as sp_cg
    from scipy.sparse.linalg import spsolve_triangular

    if ws.n_traits != 1:
        raise ValueError("sparse solve supports single-trait models; pass "
                         "sparse_location=False for multi-trait")
    W = ws.W_sparse.tocsr()
    n = ws.n_obs
    K = W.shape[1]
    rinv = ws.rinv if ws.rinv is not None else np.ones(n)
    vare = float(ws.vare0)
    Rw = sp.diags(rinv)
    LHS = (W.T @ Rw @ W).tocsr()
    RHS = W.T @ (rinv * ws.y)
    # random-effect blocks assembled as one offset-shifted COO (lil block
    # assignment is quadratic-ish at q ~ 1e5)
    rr, cc, vv = [], [], []
    for grp in ws.re_groups:
        Gi = np.linalg.inv(grp.G0)
        q = grp.n_levels
        V = sp.coo_matrix(grp.Vinv) if grp.Vinv is not None else sp.coo_matrix(sp.eye(q))
        for i, si in enumerate(grp.starts):
            for j, sj in enumerate(grp.starts):
                lam = Gi[i, j] * vare
                if lam == 0.0:
                    continue
                rr.append(V.row + si)
                cc.append(V.col + sj)
                vv.append(V.data * lam)
    if rr:
        P = sp.coo_matrix(
            (np.concatenate(vv), (np.concatenate(rr), np.concatenate(cc))),
            shape=(K, K),
        )
        LHS = (LHS + P).tocsr()
    names = model.term_names()

    if solver == "default":
        print("To solve the equations, please choose a solver: "
              "'Jacobi', 'Gauss-Seidel', 'CG', or 'Gibbs'.")
        return names, W, LHS, RHS

    D = LHS.diagonal()
    free = D > 0
    Dsafe = np.where(free, D, 1.0)
    if not free.all():
        # pin empty fixed-effect equations to 0 exactly as the reference's
        # solvers skip zero-diagonal rows (solver.jl:146): unit diagonal on
        # pinned rows keeps every triangular/CG solve nonsingular
        LHS = (LHS + sp.diags((~free).astype(np.float64))).tocsr()
        RHS = np.where(free, RHS, 0.0)
    if solver == "Jacobi":
        x = np.zeros(K)
        p = 0.7
        for _ in range(maxiter):
            err = RHS - LHS @ x
            x = np.where(free, p * (err / Dsafe + x) + (1 - p) * x, 0.0)
            if np.sum(err[free] ** 2) / K <= tolerance:
                break
    elif solver == "Gauss-Seidel":
        # x <- (L + D)^-1 (b - U x): one sparse triangular solve per sweep
        Ltri = sp.tril(LHS, k=0, format="csr")
        Utri = sp.triu(LHS, k=1, format="csr")
        x = np.zeros(K)
        for _ in range(maxiter + 1):
            x = spsolve_triangular(Ltri, RHS - Utri @ x, lower=True,
                                   unit_diagonal=False)
            err = RHS - LHS @ x
            if np.sum(err[free] ** 2) / K <= tolerance:
                break
        x = np.where(free, x, 0.0)
    elif solver == "CG":
        M = sp.diags(1.0 / Dsafe)
        x, _ = sp_cg(LHS, RHS, rtol=max(tolerance, 1e-12), maxiter=maxiter,
                     M=M)
        x = np.where(free, x, 0.0)
    elif solver == "Gibbs":
        import jax
        import jax.numpy as jnp

        from jwas_tpu.engine.state import REGroupCfg
        from jwas_tpu.ops.sparse_mme import (build_sparse_loc,
                                             sample_location_po)

        re_cfgs = [
            REGroupCfg(
                starts=g.starts, n_levels=g.n_levels, df=g.df,
                has_vinv=g.Vinv is not None, random_type=g.random_type,
                factor_rows=(
                    0 if g.Vinv is None
                    else (g.Vinv_factor.shape[0]
                          if g.Vinv_factor is not None else g.n_levels)
                ),
            )
            for g in ws.re_groups
        ]
        sl = build_sparse_loc(W, ws.rinv, ws.re_groups, re_cfgs,
                              dtype=jnp.float32)
        gis = [jnp.asarray(np.linalg.inv(g.G0), jnp.float32)
               for g in ws.re_groups]
        chols = [jnp.linalg.cholesky(g) for g in gis]
        rhs_j = jnp.asarray(RHS, jnp.float32)
        rinv_j = None if ws.rinv is None else jnp.asarray(rinv, jnp.float32)
        draw = jax.jit(lambda k, x0: sample_location_po(
            k, sl, re_cfgs, rhs_j, gis, jnp.asarray(vare, jnp.float32),
            rinv_j, n, chols, x0=x0, tol=1e-6, maxiter=500))
        ndraws = min(int(maxiter), 1000)
        key = jax.random.PRNGKey(0)
        xj = jnp.zeros((K,), jnp.float32)
        mean = jnp.zeros((K,), jnp.float32)
        for it in range(ndraws):
            xj = draw(jax.random.fold_in(key, it), xj)
            mean = mean + (xj - mean) / (it + 1)
        x = np.asarray(mean, dtype=np.float64)
    else:
        raise ValueError(
            "solver must be 'default', 'Jacobi', 'Gauss-Seidel', 'CG', or "
            "'Gibbs'"
        )
    return pd.DataFrame({"Name": names, "Estimate": x})
