"""Sparse location-MME: matrix-free CG solves and joint Gaussian draws.

The reference runs its location-parameter Gibbs and its non-MCMC solvers on
a SPARSE mixed-model-equation LHS (reference:
src/1.JWAS/src/iterative_solver/solver.jl:105-162, sparse assembly
build_MME.jl:300-382), which is what makes single-step analyses with
hundreds of thousands of pedigree animals feasible (SSBR.jl:22-53 adds an
imputation-residual term with sparse Vinv = A_nn). A dense (K, K) LHS is
1 TB at K = 5e5 — the accelerator's answer is not a sparse matrix type (XLA
has none worth using) but a MATRIX-FREE operator:

    A x = W' R^-1 (W x) + sum_g (Gi_g ⊗ Vinv_g) x * vare        (lambda-MME)

with W and each Vinv held as padded COO index/value arrays; matvecs lower
to gathers + scatter-adds, which XLA fuses and runs at memory bandwidth.

Sampling: the reference's sequential single-site Gibbs pass is a scalar
chain over K coordinates — the worst possible shape for an accelerator at
large K.
We replace it with an exact JOINT draw via perturbation-optimization
(Papandreou & Yuille 2010; standard in large GMRF samplers): with
A = W'R^-1 W + P where the prior precision P = sum_g Gi_g ⊗ Vinv_g * vare
factors as Vinv_g = F_g' F_g (Henderson's hAi for pedigree terms — already
built by io/pedigree.py — and trivially for identity terms),

    e   = sqrt(vare) W' R^-1/2 z0 + vare * sum_g (L_g ⊗ F_g') z_g,
    sol = A^-1 (rhs + e)      solved by Jacobi-preconditioned CG
    =>  sol ~ N(A^-1 rhs, vare A^-1)    exactly (up to CG tolerance),

where L_g = chol(Gi_g) and z ~ N(0, I). A joint draw mixes *better* than
the single-site pass (no coordinate-wise random walk), so posterior parity
with the reference holds with margin; the draw-for-draw stream differs by
design (SURVEY.md §7 hard-part 3).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class SparseREGroup(NamedTuple):
    """One random-effect group's sparse structure (arrays only; static
    geometry lives in engine.state.REGroupCfg)."""

    v_rows: jnp.ndarray   # (nnz_v,) int32 — Vinv COO (empty => identity)
    v_cols: jnp.ndarray   # (nnz_v,)
    v_vals: jnp.ndarray   # (nnz_v,) f32
    v_diag: jnp.ndarray   # (q,) diag(Vinv) (ones for identity)
    f_rows: jnp.ndarray   # (nnz_f,) int32 — factor F with Vinv = F' F
    f_cols: jnp.ndarray   # (nnz_f,)
    f_vals: jnp.ndarray   # (nnz_f,) f32


class SparseLoc(NamedTuple):
    """Matrix-free single-trait location design + random-effect structure.

    W is (n, K) in COO; `free` masks MME columns that have any data or
    prior support (empty fixed-effect levels are pinned to zero exactly as
    the reference's Gibbs skips zero-diagonal equations, solver.jl:146)."""

    w_rows: jnp.ndarray   # (nnz,) int32
    w_cols: jnp.ndarray   # (nnz,) int32
    w_vals: jnp.ndarray   # (nnz,) f32
    diag_w: jnp.ndarray   # (K,) diag(W' R^-1 W)
    free: jnp.ndarray     # (K,) 1.0 = active equation
    groups: Tuple[SparseREGroup, ...]


def w_matvec(sl: SparseLoc, x, n_obs: int):
    """W @ x -> (n_obs,)."""
    out = jnp.zeros((n_obs,), x.dtype)
    return out.at[sl.w_rows].add(sl.w_vals * x[sl.w_cols])


def w_rhs(sl: SparseLoc, v, n_loc: int):
    """W' v -> (K,)."""
    out = jnp.zeros((n_loc,), v.dtype)
    return out.at[sl.w_cols].add(sl.w_vals * v[sl.w_rows])


def _vinv_matvec(grp: SparseREGroup, xq, identity: bool):
    if identity:
        return xq
    out = jnp.zeros_like(xq)
    return out.at[grp.v_rows].add(grp.v_vals * xq[grp.v_cols])


def prior_matvec(re_cfgs, groups, x, gis, vare):
    """sum_g (Gi_g ⊗ Vinv_g) x * vare over the MME coordinate layout."""
    out = jnp.zeros_like(x)
    for cfg, grp, Gi in zip(re_cfgs, groups, gis):
        q = cfg.n_levels
        xs = [jax.lax.dynamic_slice(x, (sj,), (q,)) for sj in cfg.starts]
        vs = [_vinv_matvec(grp, xj, not cfg.has_vinv) for xj in xs]
        for i, si in enumerate(cfg.starts):
            acc = jnp.zeros((q,), x.dtype)
            for j in range(len(cfg.starts)):
                acc = acc + (Gi[i, j] * vare) * vs[j]
            out = jax.lax.dynamic_update_slice(
                out, jax.lax.dynamic_slice(out, (si,), (q,)) + acc, (si,)
            )
    return out


def mme_matvec(sl: SparseLoc, re_cfgs, x, gis, vare, rinv, n_obs: int):
    """A x for the lambda-MME, matrix-free. Masked so pinned (non-free)
    coordinates act as identity rows (keeps the operator SPD)."""
    xm = sl.free * x
    wv = w_matvec(sl, xm, n_obs)
    if rinv is not None:
        wv = rinv * wv
    out = w_rhs(sl, wv, x.shape[0])
    out = out + prior_matvec(re_cfgs, sl.groups, xm, gis, vare)
    return sl.free * out + (1.0 - sl.free) * x


def mme_diag(sl: SparseLoc, re_cfgs, gis, vare):
    """diag(A) for Jacobi preconditioning."""
    d = sl.diag_w
    for cfg, grp, Gi in zip(re_cfgs, sl.groups, gis):
        q = cfg.n_levels
        for i, si in enumerate(cfg.starts):
            d = jax.lax.dynamic_update_slice(
                d,
                jax.lax.dynamic_slice(d, (si,), (q,))
                + (Gi[i, i] * vare) * grp.v_diag,
                (si,),
            )
    return jnp.where(sl.free > 0, jnp.maximum(d, 1e-30), 1.0)


def cg_solve(sl: SparseLoc, re_cfgs, b, gis, vare, rinv, n_obs: int,
             x0=None, tol: float = 1e-8, maxiter: int = 200):
    """Jacobi-preconditioned CG on the matrix-free lambda-MME."""
    d = mme_diag(sl, re_cfgs, gis, vare)
    A = partial(mme_matvec, sl, re_cfgs, gis=gis, vare=vare, rinv=rinv,
                n_obs=n_obs)
    M = lambda r: r / d  # noqa: E731
    b = sl.free * b
    x, _ = jax.scipy.sparse.linalg.cg(A, b, x0=x0, tol=tol, maxiter=maxiter,
                                      M=M)
    return sl.free * x


def sample_location_po(key, sl: SparseLoc, re_cfgs, rhs, gis, vare, rinv,
                       n_obs: int, chols, x0=None, tol: float = 1e-8,
                       maxiter: int = 200):
    """One exact joint draw sol ~ N(A^-1 rhs, vare A^-1).

    chols: per-group (k, k) lower Cholesky of Gi (traced; recomputed per
    iteration from the current VC state by the caller). The per-group
    factor contribution is vare * (L_g ⊗ F_g') z_g; identity groups use
    F = I."""
    keys = jax.random.split(key, 1 + len(re_cfgs))
    dtype = rhs.dtype
    z0 = jax.random.normal(keys[0], (n_obs,), dtype)
    if rinv is not None:
        z0 = jnp.sqrt(rinv) * z0
    e = jnp.sqrt(vare) * w_rhs(sl, z0, rhs.shape[0])
    for g, (cfg, grp) in enumerate(zip(re_cfgs, sl.groups)):
        q = cfg.n_levels
        m = cfg.factor_rows if cfg.has_vinv else q
        k = len(cfg.starts)
        z = jax.random.normal(keys[1 + g], (k, m), dtype)
        if cfg.has_vinv:
            # F' z_j per term: scatter over factor columns
            fz = jnp.zeros((k, q), dtype)
            fz = fz.at[:, grp.f_cols].add(grp.f_vals[None, :]
                                          * z[:, grp.f_rows])
        else:
            fz = z
        Lg = chols[g]
        for i, si in enumerate(cfg.starts):
            contrib = vare * jnp.einsum("j,jq->q", Lg[i, : k], fz)
            e = jax.lax.dynamic_update_slice(
                e, jax.lax.dynamic_slice(e, (si,), (q,)) + contrib, (si,)
            )
    return cg_solve(sl, re_cfgs, rhs + e, gis, vare, rinv, n_obs,
                    x0=x0, tol=tol, maxiter=maxiter)


# ---------------------------------------------------------------------------
# Host-side builders (NumPy/SciPy -> device arrays).
# ---------------------------------------------------------------------------


def build_sparse_loc(W_csr, rinv_np, re_groups, re_cfgs,
                     dtype=jnp.float32) -> SparseLoc:
    """Device SparseLoc from a SciPy CSR location design and the engine's
    REGroupData list (engine.setup). Each group needs either no Vinv
    (identity) or a sparse Vinv + sparse factor F with Vinv = F'F
    (io/pedigree.py's hAi for "A" terms; a column slice of hAi for SSBR's
    A_nn epsilon term — (U'U)[nn] = U[:, nn]' U[:, nn])."""
    import scipy.sparse as sp

    W = W_csr.tocoo()
    K = W_csr.shape[1]
    w_rows = jnp.asarray(W.row.astype(np.int32))
    w_cols = jnp.asarray(W.col.astype(np.int32))
    w_vals = jnp.asarray(W.data, dtype)
    r = np.ones(W_csr.shape[0]) if rinv_np is None else np.asarray(rinv_np)
    diag_w = np.zeros(K)
    np.add.at(diag_w, W.col, (W.data ** 2) * r[W.row])
    free = (diag_w > 0).astype(np.float64)
    groups = []
    for grp, cfg in zip(re_groups, re_cfgs):
        q = grp.n_levels
        for si in cfg.starts:
            free[si: si + q] = 1.0   # random equations always active
        if grp.Vinv is None:
            g = SparseREGroup(
                v_rows=jnp.zeros((0,), jnp.int32),
                v_cols=jnp.zeros((0,), jnp.int32),
                v_vals=jnp.zeros((0,), dtype),
                v_diag=jnp.ones((q,), dtype),
                f_rows=jnp.zeros((0,), jnp.int32),
                f_cols=jnp.zeros((0,), jnp.int32),
                f_vals=jnp.zeros((0,), dtype),
            )
        else:
            V = sp.coo_matrix(grp.Vinv)
            F = getattr(grp, "Vinv_factor", None)
            if F is None:
                # dense/small fallback: Cholesky of Vinv (F = L' upper)
                L = np.linalg.cholesky(np.asarray(
                    V.todense() if sp.issparse(grp.Vinv) else grp.Vinv
                ))
                F = sp.coo_matrix(L.T)
            else:
                F = sp.coo_matrix(F)
            g = SparseREGroup(
                v_rows=jnp.asarray(V.row.astype(np.int32)),
                v_cols=jnp.asarray(V.col.astype(np.int32)),
                v_vals=jnp.asarray(V.data, dtype),
                v_diag=jnp.asarray(
                    np.asarray(sp.csr_matrix(V).diagonal()), dtype
                ),
                f_rows=jnp.asarray(F.row.astype(np.int32)),
                f_cols=jnp.asarray(F.col.astype(np.int32)),
                f_vals=jnp.asarray(F.data, dtype),
            )
        groups.append(g)
    return SparseLoc(
        w_rows=w_rows, w_cols=w_cols, w_vals=w_vals,
        diag_w=jnp.asarray(diag_w, dtype),
        free=jnp.asarray(free, dtype), groups=tuple(groups),
    )
