"""Multi-trait marker-effect Gibbs samplers.

From-scratch accelerator re-design of the reference multi-trait samplers
(reference: src/1.JWAS/src/markers/BayesianAlphabet/MTBayesABC.jl,
MTBayesC0L.jl, GBLUP.jl:52-72; method of Cheng et al. 2018, Genetics 209).

- **Sampler I** (`mt_abc_*_I`): one trait's inclusion indicator at a time
  (MTBayesABC.jl:57-127). The trait loop (t small, static) is unrolled; the
  marker loop is a `lax.scan`; in blocked form every block advances in
  parallel along the block axis exactly like the single-trait sweeps.
- **Sampler II** (`mt_abc_*_II`): joint update over all 2^t inclusion states
  with per-state precision solves (MTBayesABC.jl:129-210).
- **MT BayesL / RR-BLUP** (`mt_c0l_*`): within-marker sequential trait Gibbs
  (MTBayesC0L.jl:11-51).
- **MT-GBLUP** (`mt_gblup`): joint MvNormal per pseudo-marker, batched over
  markers (GBLUP.jl:52-72).

Joint inclusion patterns are indexed canonically: pattern index
s = sum_k delta_k * 2^k (trait k = bit k); `pi` is the (2^t,) vector of
pattern probabilities in that order.

Shapes: alpha/beta (t, p_pad); delta (t, p_pad) float (0/1); ycorr (t, n);
vare (t, t); blocked state is j-major (b, t, nblocks) with the block axis
minor so per-step math vectorizes across blocks.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from jwas_tpu.ops.markers import full_precision
from jwas_tpu.ops.markers import MarkerBlocks


def _take_logpi(log_pi, idx):
    """Pattern-prior lookup: log_pi (S,) global or (B, S) per-marker
    (GlobalPiPrior / MarkerSpecificPiPrior, MTBayesABC.jl:6-18)."""
    if log_pi.ndim == 2:
        return jnp.take_along_axis(log_pi, idx[:, None], axis=1)[:, 0]
    return jnp.take(log_pi, idx)


def pattern_index(delta_t):
    """(t, ...) 0/1 indicators -> integer pattern index, bit k = trait k."""
    t = delta_t.shape[0]
    weights = (2 ** jnp.arange(t)).astype(jnp.int32)
    return jnp.tensordot(weights, delta_t.astype(jnp.int32), axes=1)


def all_patterns(t: int) -> jnp.ndarray:
    """(2^t, t) matrix of patterns in canonical order."""
    s = jnp.arange(2**t)
    return ((s[:, None] >> jnp.arange(t)[None, :]) & 1).astype(jnp.float32)


# ---------------------------------------------------------------------------
# Sampler I core: one marker, all traits, batched over a lane axis B.
# ---------------------------------------------------------------------------


def _mt_abc_marker_update_I(w, beta, delta, alpha, xpx_j, Rinv, Ginv_j,
                            log_pi, us, zs):
    """Per-marker sampler-I trait loop (MTBayesABC.jl:85-120), batched over B.

    w:      (t, B) rhs with own contribution added back
    beta:   (t, B), delta: (t, B) in {0,1}, alpha: (t, B)
    xpx_j:  (B,)
    Rinv:   (t, t) inverse residual covariance
    Ginv_j: (t, t) or (t, t, B) inverse marker-effect covariance
    log_pi: (2^t,) log pattern priors
    us, zs: (t, B) uniforms / normals
    Returns new (beta, delta, alpha).
    """
    t = w.shape[0]
    per_marker_g = Ginv_j.ndim == 3
    pow2 = [2**k for k in range(t)]

    new_alpha = alpha
    for k in range(t):
        nok = [m for m in range(t) if m != k]
        Ginv_kk = Ginv_j[k, k] if per_marker_g else Ginv_j[k, k]
        if nok:
            Ginv_knok = jnp.stack([Ginv_j[k, m] for m in nok])  # (t-1,[B])
            beta_nok = jnp.stack([beta[m] for m in nok])        # (t-1, B)
            delta_nok = jnp.stack([delta[m] for m in nok])
            Rinv_knok = jnp.stack([Rinv[k, m] for m in nok])    # (t-1,)
            if per_marker_g:
                rhs0 = -jnp.sum(Ginv_knok * beta_nok, axis=0)
                C12_beta = jnp.sum(
                    (Ginv_knok + xpx_j[None, :] * delta_nok * Rinv_knok[:, None])
                    * beta_nok,
                    axis=0,
                )
            else:
                rhs0 = -jnp.einsum("m,mB->B", Ginv_knok, beta_nok)
                C12_beta = jnp.sum(
                    (Ginv_knok[:, None] + xpx_j[None, :] * delta_nok * Rinv_knok[:, None])
                    * beta_nok,
                    axis=0,
                )
        else:
            rhs0 = jnp.zeros_like(xpx_j)
            C12_beta = jnp.zeros_like(xpx_j)

        C11 = Ginv_kk + Rinv[k, k] * xpx_j
        inv_lhs0 = 1.0 / Ginv_kk
        g_hat0 = rhs0 * inv_lhs0
        inv_lhs1 = 1.0 / C11
        rhs1 = jnp.einsum("tB,t->B", w, Rinv[:, k]) - C12_beta
        g_hat1 = rhs1 * inv_lhs1

        # pattern indices with delta_k forced to 0 / 1
        base = sum(pw * delta[m].astype(jnp.int32)
                   for m, pw in ((m, pow2[m]) for m in nok)) if nok else 0
        idx0 = base if nok else jnp.zeros_like(xpx_j, jnp.int32)
        if not nok:
            idx0 = jnp.zeros(xpx_j.shape, jnp.int32)
        idx1 = idx0 + pow2[k]
        lp0 = _take_logpi(log_pi, idx0)
        lp1 = _take_logpi(log_pi, idx1)

        log_d0 = -0.5 * (jnp.log(Ginv_kk) - g_hat0**2 * Ginv_kk) + lp0
        log_d1 = -0.5 * (jnp.log(C11) - g_hat1**2 * C11) + lp1
        prob1 = 1.0 / (1.0 + jnp.exp(log_d0 - log_d1))
        include = us[k] < prob1

        beta_k = jnp.where(
            include, g_hat1 + zs[k] * jnp.sqrt(inv_lhs1),
            g_hat0 + zs[k] * jnp.sqrt(inv_lhs0),
        )
        delta_k = include.astype(delta.dtype)
        alpha_k = jnp.where(include, beta_k, 0.0)
        beta = beta.at[k].set(beta_k)
        delta = delta.at[k].set(delta_k)
        new_alpha = new_alpha.at[k].set(alpha_k)
    return beta, delta, new_alpha


def _mt_to_j(x, nblocks, b):  # (t, p_pad) -> (b, t, nblocks)
    t = x.shape[0]
    return x.reshape(t, nblocks, b).transpose(2, 0, 1)


def _mt_from_j(x):  # (b, t, nblocks) -> (t, p_pad)
    return x.transpose(1, 2, 0).reshape(x.shape[1], -1)


def _ginv_jmajor(ginv, nblocks, b):
    """Per-locus (p_pad, t, t) inverse covariances -> j-major
    (b, nblocks, t, t) so step j slices a per-block batch; returns None for a
    shared (t, t) ginv (the common BayesC case)."""
    if ginv.ndim == 2:
        return None
    t = ginv.shape[1]
    return ginv.reshape(nblocks, b, t, t).transpose(1, 0, 2, 3)


@partial(jax.jit, static_argnames=("nreps", "sync_every"))
def mt_abc_blocks_I(md: MarkerBlocks, alpha, beta, delta, ycorr, rinv, vare,
                    ginv, pi, key, nreps: int = 1, sync_every=None):
    """Blocked multi-trait sampler I; all blocks in parallel, residual
    reconciled every `sync_every` inner reps (see markers._sync_rounds).

    alpha/beta/delta: (t, p_pad); ycorr: (t, n); vare: (t, t);
    ginv: (t, t) inverse marker-effect covariance (common across markers,
    BayesC) or (p_pad, t, t) per-locus covariances (MT BayesB,
    MTBayesABC.jl:37-52 `locus_effect_variances`);
    pi: (2^t,) pattern priors (padded markers handled by masking alpha).
    """
    from jwas_tpu.ops.markers import _sync_rounds

    b, _, nblocks = md.grams.shape
    t = alpha.shape[0]
    dtype = ycorr.dtype
    Rinv = jnp.linalg.inv(vare)
    log_pi = jnp.log(jnp.clip(pi.astype(dtype), 1e-12, 1.0))
    per_marker_pi = log_pi.ndim == 2
    if per_marker_pi:   # (p_pad, S) -> j-major (b, nblocks, S)
        log_pi = log_pi.reshape(nblocks, b, -1).transpose(1, 0, 2)
    xpx_b = md.xpx.reshape(nblocks, b).T                      # (b, nblocks)
    valid_b = md.valid.reshape(nblocks, b).T
    ginv_b = _ginv_jmajor(ginv, nblocks, b)

    def step(carry, inp):
        alpha_j, beta_j, delta_j, rhs_j = carry
        j, u, z = inp
        a_old = alpha_j[j]                                     # (t, nblocks)
        w = rhs_j[j] + xpx_b[j][None, :] * a_old
        ginv_j = ginv if ginv_b is None else jnp.moveaxis(ginv_b[j], 0, -1)
        lp_j = log_pi[j] if per_marker_pi else log_pi
        b_new, d_new, a_new = _mt_abc_marker_update_I(
            w, beta_j[j], delta_j[j], a_old, xpx_b[j], Rinv, ginv_j, lp_j, u, z
        )
        a_new = a_new * valid_b[j][None, :]
        d_new = d_new * valid_b[j][None, :]
        rhs_j = rhs_j + (a_old - a_new)[None, :, :] * md.grams[j][:, None, :]
        return (
            alpha_j.at[j].set(a_new), beta_j.at[j].set(b_new),
            delta_j.at[j].set(d_new), rhs_j,
        ), None

    def round_fn(stt, kr, reps):
        alpha_j, beta_j, delta_j, ycorr = stt
        w_r = ycorr if rinv is None else ycorr * rinv[None, :]
        rhs0 = _mt_to_j(jnp.einsum("np,tn->tp", md.X, w_r,
                                   precision=full_precision(dtype)),
                        nblocks, b)
        ku, kz = jax.random.split(kr)
        us = jax.random.uniform(ku, (reps * b, t, nblocks), dtype=dtype)
        zs = jax.random.normal(kz, (reps * b, t, nblocks), dtype=dtype)
        idx = jnp.tile(jnp.arange(b), reps)
        alpha_start = alpha_j
        (alpha_j, beta_j, delta_j, _), _ = jax.lax.scan(
            step, (alpha_j, beta_j, delta_j, rhs0), (idx, us, zs), unroll=2
        )
        d_alpha = _mt_from_j(alpha_start - alpha_j)            # (t, p_pad)
        ycorr = ycorr + jnp.einsum("np,tp->tn", md.X, d_alpha,
                                   precision=full_precision(dtype))
        return (alpha_j, beta_j, delta_j, ycorr)

    alpha_j, beta_j, delta_j, ycorr = _sync_rounds(
        nreps, sync_every, key, round_fn,
        (_mt_to_j(alpha, nblocks, b), _mt_to_j(beta, nblocks, b),
         _mt_to_j(delta, nblocks, b), ycorr),
    )
    return _mt_from_j(alpha_j), _mt_from_j(beta_j), _mt_from_j(delta_j), ycorr


@jax.jit
def mt_abc_exact_I(X, xpx, alpha, beta, delta, ycorr, rinv, vare, ginv, pi, key):
    """Sequential multi-trait sampler I (MTBayesABC.jl:57-127). ginv: (t, t)
    shared or (p, t, t) per-locus (MT BayesB)."""
    n, p = X.shape
    t = alpha.shape[0]
    dtype = ycorr.dtype
    Rinv = jnp.linalg.inv(vare)
    log_pi = jnp.log(jnp.clip(pi.astype(dtype), 1e-12, 1.0))
    per_marker_pi = log_pi.ndim == 2
    per_locus = ginv.ndim == 3
    ku, kz = jax.random.split(key)
    us = jax.random.uniform(ku, (p, t, 1), dtype=dtype)
    zs = jax.random.normal(kz, (p, t, 1), dtype=dtype)

    def step(carry, inp):
        alpha, beta, delta, ycorr = carry
        j, u, z = inp
        x = jax.lax.dynamic_slice(X, (0, j), (n, 1))[:, 0]
        xw = x if rinv is None else x * rinv
        a_old = alpha[:, j][:, None]
        w = (ycorr @ xw)[:, None] + xpx[j] * a_old
        ginv_j = ginv[j][:, :, None] if per_locus else ginv
        lp_j = log_pi[j][None, :] if per_marker_pi else log_pi
        b_new, d_new, a_new = _mt_abc_marker_update_I(
            w, beta[:, j][:, None], delta[:, j][:, None], a_old,
            xpx[j][None], Rinv, ginv_j, lp_j, u, z,
        )
        ycorr = ycorr + (a_old - a_new) * x[None, :]
        return (
            alpha.at[:, j].set(a_new[:, 0]), beta.at[:, j].set(b_new[:, 0]),
            delta.at[:, j].set(d_new[:, 0]), ycorr,
        ), None

    (alpha, beta, delta, ycorr), _ = jax.lax.scan(
        step, (alpha, beta, delta, ycorr), (jnp.arange(p), us, zs)
    )
    return alpha, beta, delta, ycorr


# ---------------------------------------------------------------------------
# Sampler II: joint update over all 2^t states.
# ---------------------------------------------------------------------------


def _mt_abc_marker_update_II(w, xpx_j, Rinv, Ginv, log_pi, patterns, gum, z):
    """Joint-state update for one marker, batched over B
    (MTBayesABC.jl:165-209).

    w: (t, B); xpx_j: (B,); Rinv: (t, t); Ginv: (t, t) shared or (B, t, t)
    per-locus (MT BayesB); patterns: (S, t);
    gum: (S, B) gumbel noise; z: (t, B) shared standard normals.
    Returns (beta (t,B), delta (t,B), alpha (t,B)).
    """
    t, B = w.shape
    S = patterns.shape[0]
    D = patterns[:, :, None] * jnp.eye(t)[None, :, :]           # (S, t, t)
    RinvLhs = jnp.einsum("sij,jk,skl->sil", D, Rinv, D)         # D Rinv D
    RinvRhs = jnp.einsum("ij,sjk->sik", Rinv, D)                # Rinv D

    Ginv_b = Ginv[None] if Ginv.ndim == 3 else Ginv[None, None]
    lhs = RinvLhs[:, None] * xpx_j[None, :, None, None] + Ginv_b  # (S,B,t,t)
    inv_lhs = jnp.linalg.inv(lhs)
    rhs = jnp.einsum("sji,jB->sBi", RinvRhs, w)                 # (S, B, t)
    g_hat = jnp.einsum("sBij,sBj->sBi", inv_lhs, rhs)
    sign, logdet = jnp.linalg.slogdet(lhs)
    lp = log_pi.T if log_pi.ndim == 2 else log_pi[:, None]       # (S, B)
    log_delta = -0.5 * (logdet - jnp.einsum("sBi,sBi->sB", rhs, g_hat)) + lp

    which = jnp.argmax(log_delta + gum, axis=0)                  # (B,)
    chol = jnp.linalg.cholesky(0.5 * (inv_lhs + jnp.swapaxes(inv_lhs, -1, -2)))
    beta_all = g_hat + jnp.einsum("sBij,jB->sBi", chol, z)       # (S, B, t)
    beta = jnp.take_along_axis(beta_all, which[None, :, None], axis=0)[0]  # (B, t)
    delta = patterns[which]                                      # (B, t)
    alpha = beta * delta
    return beta.T, delta.T.astype(w.dtype), alpha.T


@partial(jax.jit, static_argnames=("nreps", "sync_every"))
def mt_abc_blocks_II(md: MarkerBlocks, alpha, beta, delta, ycorr, rinv, vare,
                     ginv, pi, key, nreps: int = 1, sync_every=None):
    """Blocked multi-trait sampler II (joint 2^t-state update). ginv: (t, t)
    shared or (p_pad, t, t) per-locus (MT BayesB)."""
    from jwas_tpu.ops.markers import _sync_rounds

    b, _, nblocks = md.grams.shape
    t = alpha.shape[0]
    dtype = ycorr.dtype
    Rinv = jnp.linalg.inv(vare)
    patterns = all_patterns(t).astype(dtype)
    log_pi = jnp.log(jnp.clip(pi.astype(dtype), 1e-12, 1.0))
    per_marker_pi = log_pi.ndim == 2
    if per_marker_pi:   # (p_pad, S) -> j-major (b, nblocks, S)
        log_pi = log_pi.reshape(nblocks, b, -1).transpose(1, 0, 2)
    xpx_b = md.xpx.reshape(nblocks, b).T
    valid_b = md.valid.reshape(nblocks, b).T
    ginv_b = _ginv_jmajor(ginv, nblocks, b)

    def step(carry, inp):
        alpha_j, beta_j, delta_j, rhs_j = carry
        j, g, z = inp
        a_old = alpha_j[j]
        w = rhs_j[j] + xpx_b[j][None, :] * a_old
        ginv_j = ginv if ginv_b is None else ginv_b[j]
        lp_j = log_pi[j] if per_marker_pi else log_pi
        b_new, d_new, a_new = _mt_abc_marker_update_II(
            w, xpx_b[j], Rinv, ginv_j, lp_j, patterns, g, z
        )
        a_new = a_new * valid_b[j][None, :]
        d_new = d_new * valid_b[j][None, :]
        rhs_j = rhs_j + (a_old - a_new)[None, :, :] * md.grams[j][:, None, :]
        return (
            alpha_j.at[j].set(a_new), beta_j.at[j].set(b_new),
            delta_j.at[j].set(d_new), rhs_j,
        ), None

    def round_fn(stt, kr, reps):
        alpha_j, beta_j, delta_j, ycorr = stt
        w_r = ycorr if rinv is None else ycorr * rinv[None, :]
        rhs0 = _mt_to_j(jnp.einsum("np,tn->tp", md.X, w_r,
                                   precision=full_precision(dtype)),
                        nblocks, b)
        kg, kz = jax.random.split(kr)
        gums = jax.random.gumbel(kg, (reps * b, 2**t, nblocks), dtype=dtype)
        zs = jax.random.normal(kz, (reps * b, t, nblocks), dtype=dtype)
        idx = jnp.tile(jnp.arange(b), reps)
        alpha_start = alpha_j
        (alpha_j, beta_j, delta_j, _), _ = jax.lax.scan(
            step, (alpha_j, beta_j, delta_j, rhs0), (idx, gums, zs)
        )
        d_alpha = _mt_from_j(alpha_start - alpha_j)
        ycorr = ycorr + jnp.einsum("np,tp->tn", md.X, d_alpha,
                                   precision=full_precision(dtype))
        return (alpha_j, beta_j, delta_j, ycorr)

    alpha_j, beta_j, delta_j, ycorr = _sync_rounds(
        nreps, sync_every, key, round_fn,
        (_mt_to_j(alpha, nblocks, b), _mt_to_j(beta, nblocks, b),
         _mt_to_j(delta, nblocks, b), ycorr),
    )
    return _mt_from_j(alpha_j), _mt_from_j(beta_j), _mt_from_j(delta_j), ycorr


@jax.jit
def mt_abc_exact_II(X, xpx, alpha, beta, delta, ycorr, rinv, vare, ginv, pi, key):
    """Sequential multi-trait sampler II (MTBayesABC.jl:129-210). ginv:
    (t, t) shared or (p, t, t) per-locus (MT BayesB)."""
    n, p = X.shape
    t = alpha.shape[0]
    dtype = ycorr.dtype
    Rinv = jnp.linalg.inv(vare)
    patterns = all_patterns(t).astype(dtype)
    log_pi = jnp.log(jnp.clip(pi.astype(dtype), 1e-12, 1.0))
    per_marker_pi = log_pi.ndim == 2
    per_locus = ginv.ndim == 3
    kg, kz = jax.random.split(key)
    gums = jax.random.gumbel(kg, (p, 2**t, 1), dtype=dtype)
    zs = jax.random.normal(kz, (p, t, 1), dtype=dtype)

    def step(carry, inp):
        alpha, beta, delta, ycorr = carry
        j, g, z = inp
        x = jax.lax.dynamic_slice(X, (0, j), (n, 1))[:, 0]
        xw = x if rinv is None else x * rinv
        a_old = alpha[:, j][:, None]
        w = (ycorr @ xw)[:, None] + xpx[j] * a_old
        ginv_j = ginv[j][None] if per_locus else ginv
        lp_j = log_pi[j][None, :] if per_marker_pi else log_pi
        b_new, d_new, a_new = _mt_abc_marker_update_II(
            w, xpx[j][None], Rinv, ginv_j, lp_j, patterns, g, z
        )
        ycorr = ycorr + (a_old - a_new) * x[None, :]
        return (
            alpha.at[:, j].set(a_new[:, 0]), beta.at[:, j].set(b_new[:, 0]),
            delta.at[:, j].set(d_new[:, 0]), ycorr,
        ), None

    (alpha, beta, delta, ycorr), _ = jax.lax.scan(
        step, (alpha, beta, delta, ycorr), (jnp.arange(p), gums, zs)
    )
    return alpha, beta, delta, ycorr


# ---------------------------------------------------------------------------
# MT BayesL / RR-BLUP: within-marker sequential trait Gibbs.
# ---------------------------------------------------------------------------


def _mt_c0l_marker_update(w, alpha_old, xpx_j, Rinv, Ginv_j, zs):
    """MTBayesL marker update (MTBayesC0L.jl:31-50), batched over B.

    w: (t, B); Ginv_j: (t, t) or (t, t, B) (BayesL gamma-scaled).
    """
    t = w.shape[0]
    Rhs = jnp.einsum("ij,jB->iB", Rinv, w)
    if Ginv_j.ndim == 3:
        Lhs = xpx_j[None, None, :] * Rinv[:, :, None] + Ginv_j     # (t, t, B)
    else:
        Lhs = xpx_j[None, None, :] * Rinv[:, :, None] + Ginv_j[:, :, None]
    new_alpha = alpha_old
    for k in range(t):
        lhs_kk = Lhs[k, k]
        rhs = Rhs[k] - jnp.einsum("mB,mB->B", Lhs[k], new_alpha)
        mu = rhs / lhs_kk + new_alpha[k]
        a_k = mu + zs[k] * jnp.sqrt(1.0 / lhs_kk)
        new_alpha = new_alpha.at[k].set(a_k)
    return new_alpha


@partial(jax.jit, static_argnames=("nreps", "sync_every"))
def mt_c0l_blocks(md: MarkerBlocks, alpha, ycorr, rinv, vare, ginv,
                  gamma_arr, key, nreps: int = 1, sync_every=None):
    """Blocked MT BayesL / RR-BLUP. gamma_arr: (p_pad,) (ones = RR-BLUP)."""
    from jwas_tpu.ops.markers import _sync_rounds

    b, _, nblocks = md.grams.shape
    t = alpha.shape[0]
    dtype = ycorr.dtype
    Rinv = jnp.linalg.inv(vare)
    xpx_b = md.xpx.reshape(nblocks, b).T
    valid_b = md.valid.reshape(nblocks, b).T
    gamma_b = gamma_arr.reshape(nblocks, b).T

    def step(carry, inp):
        alpha_j, rhs_j = carry
        j, z = inp
        a_old = alpha_j[j]
        w = rhs_j[j] + xpx_b[j][None, :] * a_old
        ginv_j = ginv[:, :, None] / gamma_b[j][None, None, :]
        a_new = _mt_c0l_marker_update(w, a_old, xpx_b[j], Rinv, ginv_j, z)
        a_new = a_new * valid_b[j][None, :]
        rhs_j = rhs_j + (a_old - a_new)[None, :, :] * md.grams[j][:, None, :]
        return (alpha_j.at[j].set(a_new), rhs_j), None

    def round_fn(stt, kr, reps):
        alpha_j, ycorr = stt
        w_r = ycorr if rinv is None else ycorr * rinv[None, :]
        rhs0 = _mt_to_j(jnp.einsum("np,tn->tp", md.X, w_r,
                                   precision=full_precision(dtype)),
                        nblocks, b)
        zs = jax.random.normal(kr, (reps * b, t, nblocks), dtype=dtype)
        idx = jnp.tile(jnp.arange(b), reps)
        alpha_start = alpha_j
        (alpha_j, _), _ = jax.lax.scan(step, (alpha_j, rhs0), (idx, zs), unroll=2)
        ycorr = ycorr + jnp.einsum("np,tp->tn", md.X, _mt_from_j(alpha_start - alpha_j),
                                   precision=full_precision(dtype))
        return (alpha_j, ycorr)

    alpha_j, ycorr = _sync_rounds(
        nreps, sync_every, key, round_fn, (_mt_to_j(alpha, nblocks, b), ycorr)
    )
    return _mt_from_j(alpha_j), ycorr


@jax.jit
def mt_c0l_exact(X, xpx, alpha, ycorr, rinv, vare, ginv, gamma_arr, key):
    """Sequential MT BayesL / RR-BLUP (MTBayesC0L.jl:11-51)."""
    n, p = X.shape
    t = alpha.shape[0]
    dtype = ycorr.dtype
    Rinv = jnp.linalg.inv(vare)
    zs = jax.random.normal(key, (p, t, 1), dtype=dtype)

    def step(carry, inp):
        alpha, ycorr = carry
        j, z = inp
        x = jax.lax.dynamic_slice(X, (0, j), (n, 1))[:, 0]
        xw = x if rinv is None else x * rinv
        a_old = alpha[:, j][:, None]
        w = (ycorr @ xw)[:, None] + xpx[j] * a_old
        ginv_j = ginv[:, :, None] / gamma_arr[j]
        a_new = _mt_c0l_marker_update(w, a_old, xpx[j][None], Rinv, ginv_j, z)
        ycorr = ycorr + (a_old - a_new) * x[None, :]
        return (alpha.at[:, j].set(a_new[:, 0]), ycorr), None

    (alpha, ycorr), _ = jax.lax.scan(step, (alpha, ycorr), (jnp.arange(p), zs))
    return alpha, ycorr


# ---------------------------------------------------------------------------
# MT-GBLUP: joint MvNormal per pseudo-marker, fully batched.
# ---------------------------------------------------------------------------


@jax.jit
def mt_gblup(L, D, alpha, ycorr, rinv, vare, varg, key):
    """Multi-trait GBLUP on the eigen-basis (GBLUP.jl:52-72).

    L: (n, m) eigenvectors; D: (m,); alpha: (t, m); ycorr: (t, n);
    vare/varg: (t, t). All pseudo-markers update jointly (batched inverse +
    Cholesky over m markers) — exact because L is orthogonal.
    """
    t, m = alpha.shape
    dtype = ycorr.dtype
    rv = jnp.ones(ycorr.shape[1], dtype) if rinv is None else rinv
    iR0 = jnp.linalg.inv(vare)
    iGM = jnp.linalg.inv(varg)

    ycorr = ycorr + jnp.einsum("nm,tm->tn", L, alpha)
    # rhs rows: (L' diag(rinv) Ycorr') iR0  -> (m, t)
    RHS = jnp.einsum("nm,tn,n->mt", L, ycorr, rv) @ iR0
    # lhs_i = iR0 * rinv_i + iGM / D_i  (GBLUP.jl:58)
    lhs = iR0[None, :, :] * rv[:m, None, None] + iGM[None, :, :] / D[:, None, None]
    sigma = jnp.linalg.inv(lhs)
    sigma = 0.5 * (sigma + jnp.swapaxes(sigma, -1, -2))
    mu = jnp.einsum("mij,mj->mi", sigma, RHS)
    z = jax.random.normal(key, (m, t), dtype=dtype)
    chol = jnp.linalg.cholesky(sigma)
    alpha_new = (mu + jnp.einsum("mij,mj->mi", chol, z)).T
    ycorr = ycorr - jnp.einsum("nm,tm->tn", L, alpha_new)
    return alpha_new, ycorr
