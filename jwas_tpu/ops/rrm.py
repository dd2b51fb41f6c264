"""Random-regression (longitudinal) marker samplers.

From-scratch JAX equivalents of the reference RRM kernels (reference:
src/1.JWAS/src/RRM/RRM.jl):

- `generate_full_phi` — normalized Legendre basis over standardized time
  points (generatefullPhi, RRM.jl:24-39; the reference calls GSL's
  sf_legendre_Pl, here a numpy Legendre recurrence);
- `build_m_phiphi` — per-marker Gram matrices sum_obs m_ij^2 Phi_t Phi_t'
  over observed (individual, time) cells (get_mPhiPhiarray, RRM.jl:43-57);
- `sweep_rrm_abc` — per-marker joint update of the nCoeff regression
  coefficients over the 2^c inclusion labels, with the working residual kept
  on the (ntimes, nind) grid (BayesABCRRM!, RRM.jl:59-159).

Device design: the label loop is a batched (2^c, c, c) Cholesky
factorization; the marker loop is a `lax.scan` whose per-step residual update is
a rank-1 (ntimes x nind) outer product, the direct analogue of the reference's
per-time axpy chain.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def generate_full_phi(timevec, ncoeff: int = 3) -> np.ndarray:
    """Normalized Legendre polynomial basis (generatefullPhi, RRM.jl:24-39).

    Returns (ntimes, ncoeff) over the sorted unique time points, standardized
    to [-1, 1]; column n is sqrt((2n+1)/2) P_n(q).
    """
    times = np.sort(np.unique(np.asarray(timevec, dtype=np.float64)))
    tmin, tmax = times.min(), times.max()
    q = 2.0 * (times - tmin) / (tmax - tmin) - 1.0 if tmax > tmin else np.zeros_like(times)
    phi = np.empty((len(times), ncoeff))
    for i in range(ncoeff):
        n = i
        coeffs = np.zeros(n + 1)
        coeffs[n] = 1.0
        phi[:, i] = np.sqrt((2 * n + 1) / 2.0) * np.polynomial.legendre.legval(
            q, coeffs
        )
    return phi


def build_m_phiphi(X: np.ndarray, phi: np.ndarray, obs_mask: np.ndarray) -> np.ndarray:
    """Per-marker Gram matrices (get_mPhiPhiarray, RRM.jl:43-57).

    X: (nind, p) centered genotypes; phi: (ntimes, c); obs_mask: (ntimes, nind)
    1/0 observed cells. Returns (p, c, c) with
    mPhiPhi_j = sum_i m_ij^2 * (sum_t obs[t,i] phi_t phi_t').
    """
    B = np.einsum("ti,tc,td->icd", obs_mask, phi, phi)      # (nind, c, c)
    return np.einsum("ip,icd->pcd", np.asarray(X) ** 2, B)


def _labels(ncoeff: int) -> np.ndarray:
    """All 2^c inclusion patterns, bit k = coefficient k. (c is small.)"""
    L = 2**ncoeff
    return np.array(
        [[(s >> k) & 1 for k in range(ncoeff)] for s in range(L)], dtype=np.float64
    )


def sweep_rrm_abc(X, phi, mphiphi, obs_mask, alpha, beta, delta, Wgrid,
                  vare, Ginv, log_pi, key, estimate_delta: bool = True):
    """One full sequential pass over markers (BayesABCRRM!, RRM.jl:59-159).

    X: (nind, p); phi: (ntimes, c); mphiphi: (p, c, c); obs_mask (ntimes, nind);
    alpha/beta/delta: (c, p); Wgrid: (ntimes, nind) working residual grid with
    unobserved cells pinned at zero; Ginv: (c, c); log_pi: (L,) log prior over
    the static label set. Returns (alpha, beta, delta, Wgrid).
    """
    p = X.shape[1]
    c = phi.shape[1]
    dtype = Wgrid.dtype
    D = jnp.asarray(_labels(c), dtype)                       # (L, c)
    L_n = D.shape[0]

    def body(carry, inp):
        Wg, key_ = carry
        x, mpp, a_old, j = inp
        key_, k_lab, k_z = jax.random.split(key_, 3)

        xw_first = Wg @ x                                    # (ntimes,)
        xw = phi.T @ xw_first + mpp @ a_old                  # (c,)

        if estimate_delta:
            DD = D[:, :, None] * D[:, None, :]               # (L, c, c)
            lhs = DD * mpp[None] / vare + Ginv[None]         # (L, c, c)
            rhs = D * xw[None, :] / vare                     # (L, c)
            chol = jnp.linalg.cholesky(lhs)
            mu = jax.scipy.linalg.cho_solve((chol, True), rhs[..., None])[..., 0]
            logdet = 2.0 * jnp.sum(
                jnp.log(jnp.abs(jnp.diagonal(chol, axis1=1, axis2=2))), axis=1
            )
            logp = -0.5 * (logdet - jnp.einsum("lc,lc->l", rhs, mu)) + log_pi
            g = jax.random.gumbel(k_lab, (L_n,), dtype)
            sel = jnp.argmax(logp + g)
            d_new = D[sel]
            chol_s = chol[sel]
            mu_s = mu[sel]
        else:
            lhs = mpp / vare + Ginv
            chol_s = jnp.linalg.cholesky(lhs)
            mu_s = jax.scipy.linalg.cho_solve((chol_s, True), (xw / vare)[:, None])[:, 0]
            d_new = jnp.ones((c,), dtype)

        z = jax.random.normal(k_z, (c,), dtype)
        b_new = mu_s + jax.scipy.linalg.solve_triangular(chol_s.T, z, lower=False)
        a_new = d_new * b_new

        Wg = Wg + jnp.outer(phi @ (a_old - a_new), x) * obs_mask
        return (Wg, key_), (a_new, b_new, d_new)

    inp = (X.T, mphiphi, alpha.T, jnp.arange(p))
    (Wgrid, _), (a_out, b_out, d_out) = jax.lax.scan(body, (Wgrid, key), inp)
    return a_out.T, b_out.T, d_out.T, Wgrid
