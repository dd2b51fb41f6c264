"""Multi-trait MCMC engine.

From-scratch JAX re-design of the reference multi-trait training loop
(reference: src/1.JWAS/src/MCMC/MCMC_BayesianAlphabet.jl multi-trait paths,
residual.jl, variance_components.jl:82-147):

- per-observation missing-pattern residual precision Ri built **in the jitted
  step** from the current R (mkRi, residual.jl:15-45) — patterns are static
  (from the data's missingness), the (2^t-ish, t, t) pattern inverses are a
  batched solve;
- BLP imputation of missing residuals each iteration
  (sampleMissingResiduals, residual.jl:51-73), with static per-pattern row
  sets so everything stays inside jit;
- location LHS = W' Ri W rebuilt per iteration, general (non-lambda) Gibbs;
- marker effects via the multi-trait samplers (ops/multitrait.py), the
  mega-trait path (G.constraint=true) as a vmap of the single-trait sweeps
  over traits (the reference's Threads.@threads over traits, P3 in SURVEY);
- inverse-Wishart residual/marker covariance draws; Dirichlet over the 2^t
  joint inclusion patterns.

Deviation from the reference, documented: with R.constraint=true the
reference builds Ri = Diagonal(repeat(invweights)) ignoring the per-trait
residual variances (build_MME.jl:349); we use the proper diagonal precision
diag(1/R_tt) x invweights so the general Gibbs variance 1/lhs is calibrated.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd

from jwas_tpu.engine.setup import (Workspace, prepare_workspace,
                                   resolve_sync_every as _resolve_sync)
from jwas_tpu.engine.state import EngineCfg, MTChainState, REGroupCfg
from jwas_tpu.ops import markers as mk
from jwas_tpu.ops import multitrait as mt
from jwas_tpu.ops.dists import sample_chi2, sample_inv_wishart
from jwas_tpu.ops.location import gibbs_pass_general
from jwas_tpu.ops.variance import sample_pi_abc


class MTData(NamedTuple):
    W3: jnp.ndarray            # (t, n, K) per-trait design rows
    rinv: jnp.ndarray          # (n,)
    y: jnp.ndarray             # (t, n)
    X: jnp.ndarray             # (n, p_pad) or L for GBLUP
    xpx: jnp.ndarray           # (p_pad,) or D
    grams: jnp.ndarray
    valid: jnp.ndarray
    Vinv: Tuple[jnp.ndarray, ...]
    vc_scale: Tuple[jnp.ndarray, ...]
    out_geno: jnp.ndarray      # (n_out, p)
    out_W: jnp.ndarray         # (t, n_out, K)
    patterns: jnp.ndarray      # (P, t) 0/1 observed masks (unique, static set)
    pattern_idx: jnp.ndarray   # (n,) int32
    scale_R: jnp.ndarray       # (t, t)
    marker_scale: jnp.ndarray  # (t, t)
    sem_YY: jnp.ndarray = None         # (t, t) raw-phenotype Gram y y' (SEM)
    anno_A: jnp.ndarray = None         # (p_pad, k) annotation design (2-trait
                                       # annotated BayesC, annotation_updates.jl:275-326)
    category_obs: jnp.ndarray = None   # (t, n) int32 (0 = missing)
    cens_lower: jnp.ndarray = None     # (t, n)
    cens_upper: jnp.ndarray = None     # (t, n)


@dataclass(frozen=True)
class MTEngineCfg(EngineCfg):
    pattern_rows: Tuple[Tuple[int, ...], ...] = ()   # static row sets per pattern
    pattern_masks: Tuple[Tuple[bool, ...], ...] = ()
    r_constraint: bool = False     # diagonal residual covariance (R.constraint)
    latent_traits: Tuple[int, ...] = ()   # traits with liabilities
    binary_traits: Tuple[int, ...] = ()   # residual variance pinned at 1
    sem_edges: Tuple[Tuple[int, int], ...] = ()  # causal edges (i <- j), static


def _pattern_Ri(patterns, R, rinv):
    """Per-pattern residual precisions (getRi, residual.jl:2-11), batched.

    Ri_p = M_p inv(M_p R M_p + (I - M_p)) M_p  — zero rows/cols for missing.
    Returns (P, t, t).
    """
    t = R.shape[0]
    M = patterns[:, :, None] * patterns[:, None, :]           # (P, t, t)
    A = M * R[None] + (jnp.eye(t)[None] - patterns[:, :, None] * jnp.eye(t)[None])
    Ainv = jnp.linalg.inv(A)
    del rinv
    return Ainv * M


def make_mt_step(cfg: MTEngineCfg):
    t = cfg.n_traits

    def step(state: MTChainState, data: MTData) -> MTChainState:
        keys = jax.random.split(state.key, 11 + len(cfg.re_groups))
        (key, k_loc, k_mark, k_pi, k_var, k_gam, k_res, k_imp, k_meg, k_sc,
         k_sem) = keys[:11]
        k_vc = keys[11:]
        dtype = state.ycorr.dtype
        rinv = data.rinv if cfg.has_weights else None
        n = data.y.shape[1]

        R = state.R
        ycorr = state.ycorr

        # ------- 0. latent liabilities + thresholds (cat_cens.jl:127-210) ----
        liab = state.liab
        thresholds = state.thresholds
        if cfg.latent_traits:
            from jwas_tpu.ops.threshold import (
                BIG,
                bounds_from_thresholds,
                sample_liabilities,
                sample_thresholds_t,
            )

            lower = jnp.full((t, n), -BIG, dtype)
            upper = jnp.full((t, n), BIG, dtype)
            for ti in cfg.latent_traits:
                tt = cfg.trait_types[ti]
                if tt == "censored":
                    lower = lower.at[ti].set(data.cens_lower[ti])
                    upper = upper.at[ti].set(data.cens_upper[ti])
                else:
                    lb, ub = bounds_from_thresholds(thresholds[ti], data.category_obs[ti])
                    lower = lower.at[ti].set(lb)
                    upper = upper.at[ti].set(ub)
            n_gibbs = 5 if len(cfg.latent_traits) > 1 else 1
            liab_lat, ycorr = sample_liabilities(
                k_sc, liab, ycorr, R, lower, upper, cfg.latent_traits, n_gibbs
            )
            liab = liab_lat
            kth = jax.random.split(k_meg, t)
            for ti in cfg.latent_traits:
                if cfg.trait_types[ti] == "categorical" and cfg.cat_counts[ti] > 2:
                    start = 2 if t == 1 else 3
                    thresholds = thresholds.at[ti].set(
                        sample_thresholds_t(
                            kth[ti], thresholds[ti], liab[ti],
                            data.category_obs[ti], cfg.cat_counts[ti], start,
                        )
                    )

        # ------- residual precision from the current R (mkRi) -------
        Ri_pat = _pattern_Ri(data.patterns, R, rinv)           # (P, t, t)
        Ri_n = Ri_pat[data.pattern_idx]                        # (n, t, t)
        if cfg.has_weights:
            Ri_n = Ri_n * data.rinv[:, None, None]

        # ------- impute missing residuals (sampleMissingResiduals) -------
        if cfg.missing_phenotypes:
            kk = jax.random.split(k_imp, max(1, len(cfg.pattern_rows)))
            for pidx, (rows, mask) in enumerate(zip(cfg.pattern_rows, cfg.pattern_masks)):
                obs = [i for i, m in enumerate(mask) if m]
                mis = [i for i, m in enumerate(mask) if not m]
                if not mis or not rows:
                    continue
                rows_a = jnp.asarray(rows)
                obs_a = list(obs)
                Roo = R[jnp.ix_(jnp.asarray(obs), jnp.asarray(obs))]
                Rmo = R[jnp.ix_(jnp.asarray(mis), jnp.asarray(obs))]
                Rmm = R[jnp.ix_(jnp.asarray(mis), jnp.asarray(mis))]
                Ri_oo = jnp.linalg.inv(Roo)
                C = Rmm - Rmo @ Ri_oo @ Rmo.T
                Lc = jnp.linalg.cholesky(0.5 * (C + C.T))
                res_obs = ycorr[jnp.asarray(obs_a)][:, rows_a]         # (|o|, nr)
                z = jax.random.normal(kk[pidx], (len(mis), len(rows)), dtype)
                imput = (Rmo @ Ri_oo) @ res_obs + Lc @ z               # (|m|, nr)
                ycorr = ycorr.at[jnp.ix_(jnp.asarray(mis), rows_a)].set(imput)

        # ------- 1. location parameters -------
        vc = state.vc
        sol = state.sol
        ycorr_plus = ycorr + jnp.einsum("tnk,k->tn", data.W3, sol)
        LHS = jnp.einsum("ank,nab,bnl->kl", data.W3, Ri_n, data.W3,
                         precision=mk.full_precision(data.W3.dtype))
        for g, grp in enumerate(cfg.re_groups):
            Gi = jnp.linalg.inv(vc[g])
            q = grp.n_levels
            for i, si in enumerate(grp.starts):
                for j, sj in enumerate(grp.starts):
                    if grp.has_vinv:
                        LHS = jax.lax.dynamic_update_slice(
                            LHS,
                            jax.lax.dynamic_slice(LHS, (si, sj), (q, q))
                            + data.Vinv[g] * Gi[i, j],
                            (si, sj),
                        )
                    else:
                        idx = si + jnp.arange(q)
                        LHS = LHS.at[idx, sj + jnp.arange(q)].add(Gi[i, j])
        rhs = jnp.einsum("ank,nab,bn->k", data.W3, Ri_n, ycorr_plus)
        sol = gibbs_pass_general(LHS, sol, rhs, k_loc)
        ycorr = ycorr_plus - jnp.einsum("tnk,k->tn", data.W3, sol)

        # ------- 2. marker effects -------
        alpha, beta, delta, gamma_l, pi, varg = (
            state.alpha, state.beta, state.delta, state.gamma_l, state.pi, state.varg,
        )
        md = mk.MarkerBlocks(data.X, data.xpx, data.grams, data.valid)
        if cfg.method in ("BayesC", "BayesB"):
            if cfg.constraint:
                # mega-trait: vmap the single-trait spike-slab sweep over traits
                if varg.ndim == 3:
                    # per-locus BayesB variances -> (t, p_pad) per-trait vectors
                    var_eff_t = jnp.diagonal(varg, axis1=1, axis2=2).T
                else:
                    var_eff_t = jnp.diagonal(varg)
                pi_t = jnp.where(
                    data.valid[None, :] > 0,
                    jnp.clip(pi, 1e-10, 1.0)[:, None],
                    1.0,
                )
                kt = jax.random.split(k_mark, t)
                if cfg.use_blocks and cfg.group_blocks:
                    # group-sequential per trait (flat stale set = all of p
                    # diverges at p >> n; stability_sweep_r05.md)
                    def f(a, b_, d, yc, ve, vg, pv, k2):
                        per_m = vg.ndim == 1

                        def cg(md_g, sts, yc2, g, kg):
                            a2, b2, d2, pv_g = sts[:4]
                            vg_g = sts[4] if per_m else vg
                            a2, b2, d2, yc2 = mk.sweep_blocks_abc(
                                md_g, a2, b2, d2, yc2, rinv, ve, vg_g, pv_g,
                                kg, nreps=cfg.nreps,
                                sync_every=cfg.sync_every,
                            )
                            return ((a2, b2, d2, pv_g)
                                    + ((vg_g,) if per_m else ())), yc2

                        sts = (a, b_, d, pv) + ((vg,) if per_m else ())
                        out, yc = mk.grouped_dense_sweep(
                            cg, md, sts, yc, k2, cfg.group_blocks
                        )
                        return out[0], out[1], out[2], yc
                elif cfg.use_blocks:
                    f = lambda a, b_, d, yc, ve, vg, pv, k2: mk.sweep_blocks_abc(
                        md, a, b_, d, yc, rinv, ve, vg, pv, k2,
                        nreps=cfg.nreps, sync_every=cfg.sync_every
                    )
                else:
                    f = lambda a, b_, d, yc, ve, vg, pv, k2: mk.sweep_exact_abc(
                        data.X, data.xpx, a, b_, d, yc, rinv, ve, vg, pv, k2
                    )
                alpha, beta, delta_i, ycorr = jax.vmap(f)(
                    alpha, beta, delta.astype(jnp.int32), ycorr,
                    jnp.diagonal(R), var_eff_t, pi_t, kt,
                )
                delta = delta_i.astype(dtype)
            else:
                ginv = jnp.linalg.inv(varg)
                sweep = (
                    mt.mt_abc_blocks_I if cfg.mt_sampler == "I" else mt.mt_abc_blocks_II
                ) if cfg.use_blocks else (
                    mt.mt_abc_exact_I if cfg.mt_sampler == "I" else mt.mt_abc_exact_II
                )
                if cfg.use_blocks and cfg.group_blocks:
                    per_marker_pi = pi.ndim == 2
                    per_locus_g = ginv.ndim == 3

                    def cg_mt(md_g, sts, yc, g, kg):
                        a, be, d = sts[:3]
                        i = 3
                        if per_marker_pi:
                            pi_g = sts[i].T
                            i += 1
                        else:
                            pi_g = pi
                        if per_locus_g:
                            ginv_g = jnp.moveaxis(sts[i], -1, 0)
                            i += 1
                        else:
                            ginv_g = ginv
                        a, be, d, yc = sweep(
                            md_g, a, be, d, yc, rinv, R, ginv_g, pi_g, kg,
                            nreps=cfg.nreps, sync_every=cfg.sync_every,
                        )
                        out = (a, be, d)
                        if per_marker_pi:
                            out = out + (pi_g.T,)
                        if per_locus_g:
                            out = out + (jnp.moveaxis(ginv_g, 0, -1),)
                        return out, yc

                    sts = (alpha, beta, delta)
                    if per_marker_pi:
                        sts = sts + (pi.T,)
                    if per_locus_g:
                        sts = sts + (jnp.moveaxis(ginv, 0, -1),)
                    out, ycorr = mk.grouped_dense_sweep(
                        cg_mt, md, sts, ycorr, k_mark, cfg.group_blocks
                    )
                    alpha, beta, delta = out[0], out[1], out[2]
                elif cfg.use_blocks:
                    alpha, beta, delta, ycorr = sweep(
                        md, alpha, beta, delta, ycorr, rinv, R, ginv, pi, k_mark,
                        nreps=cfg.nreps, sync_every=cfg.sync_every,
                    )
                else:
                    alpha, beta, delta, ycorr = sweep(
                        data.X, data.xpx, alpha, beta, delta, ycorr, rinv, R,
                        ginv, pi, k_mark,
                    )
        elif cfg.method in ("RR-BLUP", "BayesL"):
            if cfg.constraint:
                kt = jax.random.split(k_mark, t)
                if cfg.use_blocks and cfg.group_blocks:
                    def f(a, yc, ve, vg, k2):
                        def cg(md_g, sts, yc2, g, kg):
                            a2, gam_g = sts
                            a2, yc2 = mk.sweep_blocks_c0l(
                                md_g, a2, yc2, rinv, ve, vg, gam_g, kg,
                                nreps=cfg.nreps, sync_every=cfg.sync_every,
                            )
                            return (a2, gam_g), yc2

                        out, yc = mk.grouped_dense_sweep(
                            cg, md, (a, gamma_l), yc, k2, cfg.group_blocks
                        )
                        return out[0], yc
                elif cfg.use_blocks:
                    f = lambda a, yc, ve, vg, k2: mk.sweep_blocks_c0l(
                        md, a, yc, rinv, ve, vg, gamma_l, k2,
                        nreps=cfg.nreps, sync_every=cfg.sync_every
                    )
                else:
                    f = lambda a, yc, ve, vg, k2: mk.sweep_exact_c0l(
                        data.X, data.xpx, a, yc, rinv, ve, vg, gamma_l, k2
                    )
                alpha, ycorr = jax.vmap(f)(
                    alpha, ycorr, jnp.diagonal(R), jnp.diagonal(varg), kt
                )
            else:
                ginv = jnp.linalg.inv(varg)
                if cfg.use_blocks and cfg.group_blocks:
                    def cg_c0l(md_g, sts, yc, g, kg):
                        a, gam_g = sts
                        a, yc = mt.mt_c0l_blocks(
                            md_g, a, yc, rinv, R, ginv, gam_g, kg,
                            nreps=cfg.nreps, sync_every=cfg.sync_every,
                        )
                        return (a, gam_g), yc

                    out, ycorr = mk.grouped_dense_sweep(
                        cg_c0l, md, (alpha, gamma_l), ycorr, k_mark,
                        cfg.group_blocks,
                    )
                    alpha = out[0]
                elif cfg.use_blocks:
                    alpha, ycorr = mt.mt_c0l_blocks(
                        md, alpha, ycorr, rinv, R, ginv, gamma_l, k_mark,
                        nreps=cfg.nreps, sync_every=cfg.sync_every,
                    )
                else:
                    alpha, ycorr = mt.mt_c0l_exact(
                        data.X, data.xpx, alpha, ycorr, rinv, R, ginv, gamma_l, k_mark
                    )
        elif cfg.method == "GBLUP":
            if cfg.constraint:
                kt = jax.random.split(k_mark, t)
                f = lambda a, yc, ve, vg, k2: mk.sweep_gblup(
                    data.X, data.xpx, a, yc, rinv, ve, vg, k2
                )
                alpha, ycorr = jax.vmap(f)(
                    alpha, ycorr, jnp.diagonal(R), jnp.diagonal(varg), kt
                )
            else:
                alpha, ycorr = mt.mt_gblup(
                    data.X, data.xpx, alpha, ycorr, rinv, R, varg, k_mark
                )

        # ------- 2b. pi -------
        ann_coeffs, ann_var = state.ann_coeffs, state.ann_var
        if cfg.anno_steps == 3 and t == 2:
            # 2-trait annotated BayesC: 4 joint states via a 3-step tree
            # probit (annotation_updates.jl:275-326); pi becomes per-marker
            from jwas_tpu.ops.annotations import anno_bayesc_mt_update

            ann_coeffs, ann_var, pi = anno_bayesc_mt_update(
                k_pi, data.anno_A, delta, ann_coeffs, ann_var, data.valid
            )
            pi = pi.astype(dtype)
        elif cfg.estimate_pi:
            if cfg.constraint:
                kp = jax.random.split(k_pi, t)
                pi = jax.vmap(
                    lambda d, k2: sample_pi_abc(k2, d.astype(jnp.int32), cfg.n_markers, data.valid)
                )(delta, kp).astype(dtype)
            else:
                idx = mt.pattern_index(delta)                  # (p_pad,)
                w = (data.valid > 0).astype(jnp.float32)
                counts = jnp.zeros((2**t,), jnp.float32).at[idx].add(w)
                pi = jax.random.dirichlet(k_pi, counts + 1.0).astype(dtype)

        # ------- 2c. marker-effect covariance -------
        if cfg.estimate_marker_variance and cfg.method == "BayesB":
            # per-locus (t, t) covariances (variance_components.jl:180-187:
            # G_j ~ sample_variance(beta_j, 1, df, scale, false, constraint));
            # beta (not alpha) is the data, exactly like ST BayesB
            p_pad = beta.shape[1]
            if cfg.constraint:
                chi = sample_chi2(
                    k_var, jnp.full((t, p_pad), 1.0 + cfg.df_marker)
                )
                diag_j = (
                    beta**2
                    + cfg.df_marker * jnp.diagonal(data.marker_scale)[:, None]
                ) / chi                                     # (t, p_pad)
                varg = (
                    jnp.eye(t, dtype=dtype)[None, :, :]
                    * diag_j.T[:, :, None]
                ).astype(dtype)                              # (p_pad, t, t)
            else:
                SSE_j = jnp.einsum("tp,sp->pts", beta, beta)  # (p_pad, t, t)
                keys_p = jax.random.split(k_var, p_pad)
                varg = jax.vmap(
                    lambda k2, S: sample_inv_wishart(
                        k2, cfg.df_marker + 1.0, data.marker_scale + S
                    )
                )(keys_p, SSE_j).astype(dtype)
        elif cfg.estimate_marker_variance and cfg.method != "none":
            data_mat = beta if cfg.method == "BayesC" else alpha   # (t, p_pad)
            if cfg.method == "BayesL":
                data_w = data_mat / jnp.sqrt(gamma_l)[None, :]
            elif cfg.method == "GBLUP":
                data_w = data_mat / jnp.sqrt(data.xpx)[None, :]
            else:
                data_w = data_mat
            SSE = data_w @ data_w.T
            if cfg.constraint:
                chi = sample_chi2(k_var, jnp.full((t,), cfg.n_markers + cfg.df_marker))
                diag = (jnp.diagonal(SSE) + cfg.df_marker * jnp.diagonal(data.marker_scale)) / chi
                varg = jnp.diag(diag).astype(dtype)
            else:
                varg = sample_inv_wishart(
                    k_var, cfg.df_marker + cfg.n_markers, data.marker_scale + SSE
                ).astype(dtype)
            if cfg.method == "BayesL":
                from jwas_tpu.ops.variance import sample_bayesl_gamma

                Gi = jnp.linalg.inv(varg)
                Q = jnp.einsum("tp,sp,ts->p", alpha, alpha, Gi)
                kc, ku = jax.random.split(k_gam)
                candidate = 1.0 / (jax.random.gamma(kc, jnp.full(gamma_l.shape, (t + 1) / 2.0)) * 8.0)
                u = jax.random.uniform(ku, gamma_l.shape, dtype=dtype)
                accept = jnp.exp(Q / 4.0 * (2.0 / gamma_l - candidate))
                gamma_l = jnp.where(u < accept, 2.0 / candidate, gamma_l)
                gamma_l = jnp.where(data.valid > 0, gamma_l, 1.0)

        # ------- 3.1 random-effect covariances -------
        vc_new = list(vc)
        for g, grp in enumerate(cfg.re_groups):
            q = grp.n_levels
            sols = jnp.stack([jax.lax.dynamic_slice(sol, (s,), (q,)) for s in grp.starts])
            S = sols @ (data.Vinv[g] @ sols.T) if grp.has_vinv else sols @ sols.T
            S = 0.5 * (S + S.T)
            vc_new[g] = sample_inv_wishart(k_vc[g], grp.df + q, data.vc_scale[g] + S).astype(dtype)
        vc = tuple(vc_new)

        # ------- 3.2 residual covariance -------
        if cfg.estimate_residual_variance:
            yw = ycorr * data.rinv[None, :] if cfg.has_weights else ycorr
            SSE = yw @ ycorr.T
            if cfg.r_constraint:
                chi = sample_chi2(k_res, jnp.full((t,), cfg.n_obs + cfg.df_residual))
                diag = (jnp.diagonal(SSE) + cfg.df_residual * jnp.diagonal(data.scale_R)) / chi
                R = jnp.diag(diag).astype(dtype)
            elif cfg.binary_traits:
                from jwas_tpu.ops.threshold import (
                    sample_conditional_inv_wishart_korsgaard,
                )

                prec = jnp.linalg.inv(data.scale_R + SSE)
                prec = 0.5 * (prec + prec.T)
                R = sample_conditional_inv_wishart_korsgaard(
                    k_res, cfg.df_residual + cfg.n_obs, prec, cfg.binary_traits, t
                ).astype(dtype)
            else:
                R = sample_inv_wishart(
                    k_res, cfg.df_residual + cfg.n_obs, data.scale_R + SSE
                ).astype(dtype)

        # ------- 4. SEM structural coefficients (get_Λ, SEM.jl:125-165) -------
        # ycorr is really Λycorr; raw residual ycorr_raw = Λycorr - Λy + y is
        # used for the λ draw; first = Y'R⁻¹Y + I (prior λ ~ N(0, 1)).
        Lambda = state.Lambda
        if cfg.sem_edges:
            edges = cfg.sem_edges
            m = len(edges)
            rows_e = jnp.asarray([e[0] for e in edges])
            cols_e = jnp.asarray([e[1] for e in edges])
            C_old = jnp.zeros((t, t), dtype).at[rows_e, cols_e].set(Lambda)
            lam_y_old = data.y - C_old @ data.y
            ycorr_raw = ycorr - lam_y_old + data.y
            Rd = jnp.diagonal(R)
            first = jnp.eye(m, dtype=dtype)
            for a, (i, j) in enumerate(edges):
                for b_, (i2, j2) in enumerate(edges):
                    if i == i2:
                        first = first.at[a, b_].add(data.sem_YY[j, j2] / Rd[i])
            second = jnp.stack(
                [data.y[j] @ ycorr_raw[i] / Rd[i] for (i, j) in edges]
            )
            Finv = jnp.linalg.inv(first)
            mean_l = Finv @ second
            Lc = jnp.linalg.cholesky(0.5 * (Finv + Finv.T))
            Lambda = mean_l + Lc @ jax.random.normal(k_sem, (m,), dtype=dtype)
            C_new = jnp.zeros((t, t), dtype).at[rows_e, cols_e].set(Lambda)
            lam_y = data.y - C_new @ data.y
            ycorr = ycorr_raw - data.y + lam_y

        return MTChainState(
            key=key, sol=sol, alpha=alpha, beta=beta, delta=delta,
            gamma_l=gamma_l, ycorr=ycorr, R=R, varg=varg, pi=pi, vc=vc,
            liab=liab, thresholds=thresholds, Lambda=Lambda,
            ann_coeffs=ann_coeffs, ann_var=ann_var,
        )

    return step


class MTAccum(NamedTuple):
    n: jnp.ndarray
    sol_m: jnp.ndarray
    sol_m2: jnp.ndarray
    alpha_m: jnp.ndarray
    alpha_m2: jnp.ndarray
    delta_m: jnp.ndarray
    R_m: jnp.ndarray
    R_m2: jnp.ndarray
    varg_m: jnp.ndarray
    varg_m2: jnp.ndarray
    pi_m: jnp.ndarray
    pi_m2: jnp.ndarray
    ebv_m: jnp.ndarray
    ebv_m2: jnp.ndarray
    vc_m: Tuple[jnp.ndarray, ...]
    vc_m2: Tuple[jnp.ndarray, ...]
    lam_m: jnp.ndarray
    lam_m2: jnp.ndarray
    # defaults are None (not jnp.zeros) so importing the module does not
    # initialize the XLA backend (jax.distributed must run first on pods)
    ann_m: Optional[jnp.ndarray] = None
    ann_m2: Optional[jnp.ndarray] = None


class MTSampleOut(NamedTuple):
    R: jnp.ndarray
    varg: jnp.ndarray
    pi: jnp.ndarray
    ebv: jnp.ndarray            # (t, n_out)
    genvar: jnp.ndarray         # (t, t)
    h2: jnp.ndarray             # (t,)
    lam: jnp.ndarray            # (n_edges,) SEM structural coefficients


def _welford(m, x, n):
    return m + (x - m) / n


def make_mt_run_window(cfg: MTEngineCfg):
    step = make_mt_step(cfg)

    @partial(jax.jit, static_argnames=("n_iters", "accumulate"))
    def run_window(state, data: MTData, accum: MTAccum, n_iters: int,
                   accumulate: bool = True):
        def body(s, _):
            return step(s, data), None

        state, _ = jax.lax.scan(body, state, None, length=n_iters)

        ebv = jnp.einsum("tok,k->to", data.out_W, state.sol)
        if data.out_geno.shape[0] > 0:
            ebv = ebv + jnp.einsum(
                "op,tp->to", data.out_geno, state.alpha[:, : data.out_geno.shape[1]]
            )
        if ebv.shape[1] > 1:
            ebvc = ebv - ebv.mean(axis=1, keepdims=True)
            genvar = (ebvc @ ebvc.T) / (ebv.shape[1] - 1)
        else:
            genvar = jnp.zeros((cfg.n_traits, cfg.n_traits), ebv.dtype)
        h2 = jnp.diagonal(genvar) / (jnp.diagonal(genvar) + jnp.diagonal(state.R))
        # per-locus BayesB covariances: ship the across-loci mean to the host
        varg_out = (
            state.varg[: cfg.n_markers].mean(axis=0)
            if state.varg.ndim == 3 else state.varg
        )
        # per-marker annotated joint priors: ship the across-marker mean
        pi_out = (
            state.pi[: cfg.n_markers].mean(axis=0)
            if state.pi.ndim == 2 else state.pi
        )
        out = MTSampleOut(R=state.R, varg=varg_out, pi=pi_out, ebv=ebv,
                          genvar=genvar, h2=h2, lam=state.Lambda)
        if accumulate:
            n = accum.n + 1.0
            accum = MTAccum(
                n=n,
                sol_m=_welford(accum.sol_m, state.sol, n),
                sol_m2=_welford(accum.sol_m2, state.sol**2, n),
                alpha_m=_welford(accum.alpha_m, state.alpha, n),
                alpha_m2=_welford(accum.alpha_m2, state.alpha**2, n),
                delta_m=_welford(accum.delta_m, state.delta, n),
                R_m=_welford(accum.R_m, state.R, n),
                R_m2=_welford(accum.R_m2, state.R**2, n),
                varg_m=_welford(accum.varg_m, state.varg, n),
                varg_m2=_welford(accum.varg_m2, state.varg**2, n),
                pi_m=_welford(accum.pi_m, state.pi, n),
                pi_m2=_welford(accum.pi_m2, state.pi**2, n),
                ebv_m=_welford(accum.ebv_m, ebv, n),
                ebv_m2=_welford(accum.ebv_m2, ebv**2, n),
                vc_m=tuple(_welford(m, v, n) for m, v in zip(accum.vc_m, state.vc)),
                vc_m2=tuple(_welford(m, v**2, n) for m, v in zip(accum.vc_m2, state.vc)),
                lam_m=_welford(accum.lam_m, state.Lambda, n),
                lam_m2=_welford(accum.lam_m2, state.Lambda**2, n),
                ann_m=(_welford(accum.ann_m, state.ann_coeffs, n)
                       if cfg.anno_steps > 0 else accum.ann_m),
                ann_m2=(_welford(accum.ann_m2, state.ann_coeffs**2, n)
                        if cfg.anno_steps > 0 else accum.ann_m2),
            )
        return state, accum, out

    return run_window


def pi_dict_to_vector(pi, t: int) -> np.ndarray:
    """Joint-pattern Pi dict -> canonical (2^t,) vector (bit k = trait k)."""
    vec = np.zeros(2**t)
    if isinstance(pi, dict):
        for pat, prob in pi.items():
            pat = tuple(float(x) for x in pat)
            idx = sum(int(pat[k]) * (2**k) for k in range(t))
            vec[idx] = float(prob)
    else:
        vec[-1] = 1.0
    return vec


def build_mt_data_and_state(ws: Workspace, opts, dtype):
    model = ws.model
    t = ws.n_traits
    n = ws.n_obs
    K = ws.W.shape[1]
    W3 = jnp.asarray(ws.W.reshape(t, n, K), dtype)
    y = jnp.asarray(ws.y.reshape(t, n), dtype)
    y_mask = ws.y_mask.reshape(t, n)
    rinv = jnp.asarray(ws.rinv if ws.rinv is not None else np.ones(n), dtype)

    # unique missing patterns (static)
    mask_nt = y_mask.T                                    # (n, t) bool
    uniq, pat_idx = np.unique(mask_nt, axis=0, return_inverse=True)
    patterns = jnp.asarray(uniq.astype(np.float64), dtype)
    pattern_rows = tuple(
        tuple(int(r) for r in np.where(pat_idx == k)[0]) for k in range(len(uniq))
    )
    pattern_masks = tuple(tuple(bool(b) for b in row) for row in uniq)

    method = ws.geno.method if ws.geno is not None else "none"
    use_blocks = bool(opts.fast_blocks) and method not in ("GBLUP", "none")
    group_blocks_dense = 0
    if method == "GBLUP":
        X = jnp.asarray(ws.gblup_L, dtype)
        xpx = jnp.asarray(ws.gblup_D, dtype)
        grams = jnp.zeros((0, 0, 0), dtype)
        valid = jnp.ones((X.shape[1],), dtype)
        p = p_pad = X.shape[1]
        nreps = 1
    elif method != "none":
        p = ws.geno.n_markers
        if use_blocks:
            bs = mk.default_block_size(n) if opts.fast_blocks is True else int(opts.fast_blocks)
            bs = max(8, ((bs + 7) // 8) * 8)
            md = mk.build_marker_blocks(
                jnp.asarray(ws.geno.genotypes, dtype),
                rinv if ws.rinv is not None else None, block_size=bs,
            )
            X, xpx, grams, valid = md
            p_pad = X.shape[1]
            # dense group-sequential schedule at p >> n (stability cap;
            # same rule as the single-trait engine)
            group_blocks_dense = mk.stable_group_blocks(n, bs, grams.shape[2])
            nreps = opts.nreps if opts.nreps is not None else bs
            # exact chain-length accounting: never run more effective
            # sweeps than the user asked for (JWAS.jl:313 floors; we
            # clamp nreps so short chains are exact instead of inflated)
            nreps = max(1, min(nreps, opts.chain_length))
        else:
            X = jnp.asarray(ws.geno.genotypes, dtype)
            xw = X if ws.rinv is None else X * rinv[:, None]
            xpx = jnp.sum(xw * X, axis=0)
            grams = jnp.zeros((0, 0, 0), dtype)
            valid = jnp.ones((p,), dtype)
            p_pad = p
            nreps = 1
    else:
        X = jnp.zeros((n, 0), dtype)
        xpx = jnp.zeros((0,), dtype)
        grams = jnp.zeros((0, 0, 0), dtype)
        valid = jnp.zeros((0,), dtype)
        p = p_pad = 0
        nreps = 1

    re_cfgs, Vinvs, vc_scales, vc0 = [], [], [], []
    for grp in ws.re_groups:
        re_cfgs.append(REGroupCfg(
            starts=grp.starts, n_levels=grp.n_levels, df=grp.df,
            has_vinv=grp.Vinv is not None, random_type=grp.random_type,
        ))
        Vinvs.append(jnp.asarray(grp.Vinv, dtype) if grp.Vinv is not None else jnp.zeros((0, 0), dtype))
        vc_scales.append(jnp.asarray(grp.scale, dtype))
        vc0.append(jnp.asarray(grp.G0, dtype))

    n_out = len(ws.output_ids)
    out_W_np = np.zeros((t, n_out, K))
    for term_name in ws.prediction_terms:
        term = model.term_dict[term_name]
        out_W_np[term.i_model, :, term.start_pos:term.start_pos + term.n_levels] += (
            ws.output_X[term_name]
        )
    out_geno = (
        jnp.asarray(ws.output_genotypes, dtype)
        if ws.output_genotypes is not None
        else jnp.zeros((0, max(p, 1)), dtype)
    )

    g = ws.geno
    constraint = bool(g.G.constraint) if g is not None else False
    df_marker = float(ws.df_marker)
    marker_var0 = np.atleast_2d(np.asarray(ws.marker_var0, dtype=np.float64)) if g is not None else np.zeros((t, t))
    marker_scale0 = np.atleast_2d(np.asarray(ws.marker_scale0, dtype=np.float64)) if g is not None else np.zeros((t, t))
    if g is not None and marker_var0.shape != (t, t):
        marker_var0 = np.eye(t) * float(marker_var0.reshape(-1)[0])
        marker_scale0 = np.eye(t) * float(marker_scale0.reshape(-1)[0])
    if constraint and g is not None:
        # G_constraint!: df -= t, scale = Diag(scale/(df-1)) * (df-2)/df
        df_new = df_marker - t
        marker_scale0 = np.diag(np.diag(marker_scale0 / (df_new - 1.0))) * (df_new - 2.0) / df_new
        df_marker = df_new

    df_R = float(ws.df_R)
    scale_R0 = np.atleast_2d(np.asarray(ws.scale_R, dtype=np.float64))
    R_constraint = bool(model.R.constraint)
    if R_constraint:
        df_R_new = df_R - t
        scale_R0 = np.diag(np.diag(scale_R0 / (df_R_new - 1.0))) * (df_R_new - 2.0) / df_R_new
        df_R = df_R_new

    mt_sampler = "I"
    if g is not None and getattr(g, "multi_trait_sampler", "I") in ("I", "II"):
        mt_sampler = getattr(g, "multi_trait_sampler", "I")

    # --- latent (categorical/binary/censored) trait setup (reference
    # categorical_censored_traits_setup!, categorical_and_censored_trait.jl:29-95)
    from jwas_tpu.ops.threshold import BIG

    trait_types = tuple(model.traits_type)
    latent_traits = tuple(
        i for i, tt in enumerate(trait_types)
        if tt in ("categorical", "categorical(binary)", "censored")
    )
    binary_traits = tuple(
        i for i, tt in enumerate(trait_types) if tt == "categorical(binary)"
    )
    cat_counts = [0] * t
    category_np = np.zeros((t, n), np.int32)
    cl_np = np.full((t, n), -BIG)
    cu_np = np.full((t, n), BIG)
    y_np = ws.y.reshape(t, n)
    R0 = np.atleast_2d(np.asarray(ws.vare0, dtype=np.float64))
    thresholds0 = liab0 = None
    if latent_traits:
        from scipy.stats import truncnorm

        rng0 = np.random.default_rng((opts.seed if opts.seed is not None else 0) + 7)
        th_rows = {}
        for ti in latent_traits:
            tt2 = trait_types[ti]
            if tt2 in ("categorical", "categorical(binary)"):
                cats = np.where(y_mask[ti], np.nan_to_num(y_np[ti]), 0.0).astype(np.int64)
                category_np[ti] = cats
                ncat = int(cats.max())
                cat_counts[ti] = ncat
                if tt2 == "categorical":
                    # [-Inf, 0, 1, range(1, mu+10s)..., Inf]; mu=0 at zero start
                    stop = 10.0 * float(R0[ti, ti])
                    inner = np.linspace(1.0, max(stop, 2.0), ncat - 1)[:-1]
                    th = np.concatenate([[-BIG, 0.0], inner, [BIG]])
                else:
                    th = np.array([-BIG, 0.0, BIG])
                th_rows[ti] = th
                cl_np[ti] = np.where(cats > 0, th[np.maximum(cats - 1, 0)], -BIG)
                cu_np[ti] = np.where(cats > 0, th[np.minimum(cats, len(th) - 1)], BIG)
            else:  # censored: bounds columns synthesized in prepare_workspace
                name = model.lhs_vec[ti]
                lo = pd.to_numeric(ws.df[f"{name}_l"], errors="coerce").to_numpy()
                hi = pd.to_numeric(ws.df[f"{name}_u"], errors="coerce").to_numpy()
                cl_np[ti] = np.clip(np.nan_to_num(lo, nan=-np.inf), -BIG, BIG)
                cu_np[ti] = np.clip(np.nan_to_num(hi, nan=np.inf), -BIG, BIG)
        t_max = max(3, max((cat_counts[ti] + 1 for ti in latent_traits), default=3))
        th_np = np.full((t, t_max), BIG)
        for ti, th in th_rows.items():
            th_np[ti, : len(th)] = th
        thresholds0 = jnp.asarray(th_np, dtype)
        # liability init ~ TruncNormal(0, sqrt(R_tt)) within the bounds (:82-88)
        liab_np = y_np.astype(np.float64).copy()
        liab_np[~y_mask.reshape(t, n)] = 0.0
        for ti in latent_traits:
            s0 = np.sqrt(float(R0[ti, ti]))
            a = np.clip(cl_np[ti] / s0, -30, 30)
            b = np.clip(cu_np[ti] / s0, -30, 30)
            liab_np[ti] = np.where(
                cl_np[ti] < cu_np[ti],
                truncnorm.rvs(a, np.maximum(b, a + 1e-6), scale=s0,
                              random_state=rng0, size=n),
                cl_np[ti],
            )
        liab0 = jnp.asarray(liab_np, dtype)
    if len(binary_traits) == t and bool(model.R.estimate_variance):
        raise ValueError(
            "all traits binary: residual covariance cannot be estimated; "
            "set R estimate_variance=false"
        )

    # --- SEM causal structure (fully recursive model; SEM_setup, SEM.jl:53-62)
    sem_edges: Tuple[Tuple[int, int], ...] = ()
    causal = getattr(opts, "causal_structure", None)
    if causal is None:
        causal = model.causal_structure
    if causal is not None and causal is not False:
        causal = np.asarray(causal, dtype=np.float64)
        if causal.shape != (t, t):
            raise ValueError(f"causal_structure must be {t}x{t}")
        if np.any(np.triu(causal) != 0):
            raise ValueError("the causal structure needs to be a lower triangular matrix")
        if not np.all(np.isin(causal, (0.0, 1.0))):
            raise ValueError("causal_structure entries must be 0 or 1")
        if not all(all(m_ for m_ in row) for row in pattern_masks):
            raise ValueError("missing phenotypes are not allowed in SEM")
        # column j affects row i (JWAS.jl:144-145); edge order is row-major to
        # match the reference's Y column order (trait blocks, then targets).
        sem_edges = tuple(
            (i, j) for i in range(t) for j in range(t) if causal[i, j] == 1.0
        )
        model.causal_structure = causal

    # --- 2-trait annotated BayesC setup (annotation_setup.jl:51-133):
    # tree-probit coefficient intercepts from the startup joint Pi dict ---
    anno_A_np = None
    ann_coeffs0 = ann_var0 = None
    anno_steps = 0
    if (g is not None and g.annotations is not None and method == "BayesC"
            and t == 2 and not constraint):
        from scipy.stats import norm as _norm

        anno_steps = 3
        ann_np = np.asarray(g.annotations, dtype=np.float64)
        anno_A_np = np.zeros((p_pad, 1 + ann_np.shape[1]))
        anno_A_np[:p, 0] = 1.0
        anno_A_np[:p, 1:] = ann_np
        v = pi_dict_to_vector(g.pi, t)        # canonical: 00, 10, 01, 11
        if v[1] + v[3] <= 0 or v[2] + v[3] <= 0 or v[3] <= 0:
            raise ValueError(
                "Annotated multi-trait BayesC requires positive startup "
                "prior mass in states {10,11}, {01,11} and 11"
            )
        eps = 1e-6
        p1 = float(np.clip(1.0 - v[0], eps, 1 - eps))
        p2 = float(np.clip(v[3] / p1, eps, 1 - eps))
        p3 = float(np.clip(v[1] / max(p1 * (1.0 - p2), eps), eps, 1 - eps))
        c0 = np.zeros((anno_A_np.shape[1], 3))
        c0[0, :] = _norm.ppf([p1, p2, p3])
        ann_coeffs0 = c0
        ann_var0 = np.ones(3)

    cfg = MTEngineCfg(
        method=method, n_obs=n, n_markers=p, n_loc=K,
        estimate_pi=bool(g.estimate_pi) if g is not None else False,
        estimate_marker_variance=bool(g.G.estimate_variance) if g is not None else False,
        estimate_scale=False,
        estimate_residual_variance=bool(model.R.estimate_variance),
        use_blocks=use_blocks, nreps=nreps,
        sync_every=_resolve_sync(opts, nreps), re_groups=tuple(re_cfgs),
        df_residual=df_R, df_marker=df_marker,
        has_weights=ws.rinv is not None, n_traits=t,
        constraint=constraint,
        missing_phenotypes=bool(opts.missing_phenotypes) and len(pattern_masks) > 1,
        mt_sampler=mt_sampler,
        group_blocks=group_blocks_dense,
        trait_types=trait_types,
        cat_counts=tuple(cat_counts),
        pattern_rows=pattern_rows, pattern_masks=pattern_masks,
        anno_steps=anno_steps,
        r_constraint=R_constraint,
        latent_traits=latent_traits, binary_traits=binary_traits,
        sem_edges=sem_edges,
    )

    data = MTData(
        W3=W3, rinv=rinv, y=y, X=X, xpx=xpx, grams=grams, valid=valid,
        Vinv=tuple(Vinvs), vc_scale=tuple(vc_scales),
        out_geno=out_geno, out_W=jnp.asarray(out_W_np, dtype),
        patterns=patterns, pattern_idx=jnp.asarray(pat_idx, jnp.int32),
        scale_R=jnp.asarray(scale_R0, dtype),
        marker_scale=jnp.asarray(marker_scale0, dtype),
        sem_YY=(y @ y.T) if sem_edges else jnp.zeros((t, t), dtype),
        anno_A=jnp.asarray(anno_A_np, dtype) if anno_A_np is not None else None,
        category_obs=jnp.asarray(category_np),
        cens_lower=jnp.asarray(cl_np, dtype),
        cens_upper=jnp.asarray(cu_np, dtype),
    )

    seed = opts.seed if opts.seed is not None else 0
    key = jax.random.PRNGKey(seed)
    if opts.starting_value is not None and opts.starting_value is not False:
        sv = np.asarray(opts.starting_value, dtype=np.float64).reshape(-1)
        if len(sv) != K:
            raise ValueError(
                f"length of starting values for non-marker location "
                f"parameters is wrong (expected {K}, got {len(sv)}); the "
                f"order is model.term_names()"
            )
        sol = jnp.asarray(sv, dtype)
    else:
        sol = jnp.zeros((K,), dtype)
    alpha = jnp.zeros((t, p_pad), dtype)
    beta = alpha
    delta = jnp.broadcast_to(valid[None, :], (t, p_pad)).astype(dtype)
    if method == "BayesL":
        key, kg = jax.random.split(key)
        gamma_l = jnp.where(
            valid[None, :] > 0,
            jax.random.gamma(kg, (t + 1) / 2.0, (1, p_pad)).astype(dtype) * 8.0,
            1.0,
        )[0]
        marker_var0 = marker_var0 / (4.0 * (t + 1))
        marker_scale_adj = marker_scale0 / (4.0 * (t + 1))
        data = data._replace(marker_scale=jnp.asarray(marker_scale_adj, dtype))
    else:
        gamma_l = jnp.ones((p_pad,), dtype)

    y_eff = y if liab0 is None else jnp.where(
        jnp.asarray(np.isin(np.arange(t), latent_traits))[:, None], liab0, y
    )
    ycorr = y_eff - jnp.einsum("tnk,k->tn", W3, sol)
    # zero the missing entries so they start as pure imputation targets
    # (latent traits carry a liability everywhere, so they stay)
    keep = np.asarray(y_mask.reshape(t, n))
    for ti in latent_traits:
        keep[ti] = True
    ycorr = jnp.where(jnp.asarray(keep), ycorr, 0.0)

    if constraint:
        pi0 = jnp.zeros((t,), dtype)
    elif anno_steps == 3:
        v = pi_dict_to_vector(g.pi, t)
        pi_np = np.tile(v[None, :], (p_pad, 1))
        pi_np[p:] = [1.0, 0.0, 0.0, 0.0]
        pi0 = jnp.asarray(pi_np, dtype)
    elif g is not None and isinstance(g.pi, dict):
        pi0 = jnp.asarray(pi_dict_to_vector(g.pi, t), dtype)
    else:
        pi0 = jnp.zeros((2**t,), dtype).at[-1].set(1.0)

    if method == "BayesB":
        # per-locus covariances (MTBayesABC.jl:37-52 locus_effect_variances)
        varg0 = np.broadcast_to(
            np.asarray(marker_var0, dtype=np.float64), (p_pad, t, t)
        ).copy()
    else:
        varg0 = marker_var0

    state = MTChainState(
        key=key, sol=sol, alpha=alpha, beta=beta, delta=delta, gamma_l=gamma_l,
        ycorr=ycorr,
        R=jnp.asarray(np.atleast_2d(ws.vare0), dtype),
        varg=jnp.asarray(varg0, dtype),
        pi=pi0, vc=tuple(vc0),
        liab=liab0 if liab0 is not None else jnp.zeros((0,), dtype),
        thresholds=thresholds0 if thresholds0 is not None else jnp.zeros((0,), dtype),
        Lambda=jnp.zeros((len(sem_edges),), dtype),
        ann_coeffs=(jnp.asarray(ann_coeffs0, dtype)
                    if ann_coeffs0 is not None else None),
        ann_var=jnp.asarray(ann_var0, dtype) if ann_var0 is not None else None,
    )
    return cfg, data, state


def _init_mt_accum(cfg, data: MTData, state: MTChainState) -> MTAccum:
    z = jnp.zeros
    dt = state.ycorr.dtype
    t = cfg.n_traits
    return MTAccum(
        n=z((), dt),
        sol_m=z(state.sol.shape, dt), sol_m2=z(state.sol.shape, dt),
        alpha_m=z(state.alpha.shape, dt), alpha_m2=z(state.alpha.shape, dt),
        delta_m=z(state.alpha.shape, dt),
        R_m=z((t, t), dt), R_m2=z((t, t), dt),
        varg_m=z(state.varg.shape, dt), varg_m2=z(state.varg.shape, dt),
        pi_m=z(state.pi.shape, dt), pi_m2=z(state.pi.shape, dt),
        ebv_m=z((t, data.out_W.shape[1]), dt), ebv_m2=z((t, data.out_W.shape[1]), dt),
        vc_m=tuple(z(v.shape, dt) for v in state.vc),
        vc_m2=tuple(z(v.shape, dt) for v in state.vc),
        lam_m=z(state.Lambda.shape, dt), lam_m2=z(state.Lambda.shape, dt),
        ann_m=z(state.ann_coeffs.shape if state.ann_coeffs is not None else (0,), dt),
        ann_m2=z(state.ann_coeffs.shape if state.ann_coeffs is not None else (0,), dt),
    )


def _apply_update_priors_mt(cfg, data: MTData, accum: MTAccum):
    """Empirical-Bayes prior refresh from running posterior means, MT form
    (MCMC_BayesianAlphabet.jl:381-395): marker scale = meanVara*(df-t-1),
    polygenic scale = G0Mean*(df-k-1), residual scale = meanVare*(df-2)/df.
    BayesB (per-marker variances) keeps its marker prior fixed."""
    t = cfg.n_traits
    fields = {}
    if cfg.method not in ("BayesB", "none") and accum.varg_m.ndim == 2:
        fields["marker_scale"] = accum.varg_m * (cfg.df_marker - t - 1.0)
    vc_scale = list(data.vc_scale)
    changed = False
    for g, grp in enumerate(cfg.re_groups):
        if grp.random_type == "A":
            k = len(grp.starts)
            vc_scale[g] = accum.vc_m[g] * (grp.df - k - 1.0)
            changed = True
    if changed:
        fields["vc_scale"] = tuple(vc_scale)
    fields["scale_R"] = accum.R_m * (cfg.df_residual - 2.0) / cfg.df_residual
    return data._replace(**fields)


def _run_mt_multichain(ws, model, cfg, data, state, opts):
    """Parallel MT chains, vmapped over a leading chain axis (the MT
    counterpart of engine.mcmc._run_multichain; the reference has no
    built-in multi-chain support, convergence_diagnosis.jl:31-57).

    Per-chain Welford moments are pooled (equal-length chains, exact);
    chain-0 draws feed the sample-file stream; PSRF is computed per trait
    for h², genetic variance, and residual variance. When opts.mesh has a
    'chain'/'chains' axis, chains shard across it."""
    K = int(opts.n_chains)
    seed = opts.seed if opts.seed is not None else 0
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(seed, seed + K))

    def stack(x):
        return jnp.broadcast_to(x, (K,) + x.shape)

    states = jax.tree.map(stack, state)._replace(key=keys)
    accum0 = _init_mt_accum(cfg, data, state)
    accums = jax.tree.map(stack, accum0)

    nreps = cfg.nreps
    n_outer = max(1, opts.chain_length // nreps)
    burnin_outer = opts.burnin // nreps
    osf = opts.output_samples_frequency
    if osf <= 0:
        osf = max(1, opts.chain_length // 1000)
    thin_outer = max(1, osf // nreps)
    n_saved = max(1, (n_outer - burnin_outer) // thin_outer)

    samples = {"R": [], "varg": [], "pi": [], "genvar": [], "h2": [],
               "lam": [], "alpha": []}
    chain_track = {"h2": [], "genvar": [], "R": [], "varg": []}
    upf = int(opts.update_priors_frequency or 0)
    prior_epoch = 0
    w0 = 0

    # checkpoint/resume on the stacked multichain pytree (same machinery as
    # the single-chain drivers); load host-side BEFORE mesh sharding
    from jwas_tpu.utils import checkpoint as ckpt

    ck_folder = opts.checkpoint_folder or os.path.join(
        opts.output_folder or "results", "checkpoint"
    )
    ck_every_w = 0
    if opts.checkpoint_frequency and int(opts.checkpoint_frequency) > 0:
        ck_every_w = max(1, int(opts.checkpoint_frequency) // (thin_outer * nreps))
    resumed = False
    if opts.resume:
        path = ckpt.latest_checkpoint(ck_folder)
        if path is not None:
            template = (states, accums, data.vc_scale, data.marker_scale,
                        data.scale_R)
            ((states, accums, vc_scale, marker_scale, scale_R), smp,
             meta) = ckpt.load_checkpoint(path, template)
            data = data._replace(vc_scale=vc_scale, marker_scale=marker_scale,
                                 scale_R=scale_R)
            samples = {k: smp.get(k, []) for k in samples}
            chain_track = {k: smp.get(f"c_{k}", []) for k in chain_track}
            prior_epoch = int(meta["prior_epoch"])
            w0 = int(meta["w_next"])
            resumed = True

    mesh = opts.mesh
    if mesh is not None:
        axes = tuple(getattr(mesh, "axis_names", ()))
        chain_ax = next((a for a in ("chain", "chains") if a in axes), None)
        if chain_ax is not None and K % int(mesh.shape[chain_ax]) == 0:
            from jax.sharding import NamedSharding, PartitionSpec as P

            def put_chain(x):
                if x is None or not hasattr(x, "ndim") or x.ndim == 0:
                    return x
                spec = P(chain_ax, *([None] * (x.ndim - 1)))
                return jax.device_put(x, NamedSharding(mesh, spec))

            states = jax.tree.map(put_chain, states)
            accums = jax.tree.map(put_chain, accums)

    rw = make_mt_run_window(cfg)
    mc = jax.vmap(rw, in_axes=(0, None, 0, None, None))

    from jwas_tpu.engine.progress import ProgressPrinter
    from jwas_tpu.engine.samples_io import MTSampleStream, multichain_streams

    stream = MTSampleStream(ws, cfg, opts, append=resumed)
    chain_streams = multichain_streams(MTSampleStream, ws, cfg, opts, K,
                                       append=resumed)
    progress = ProgressPrinter(opts.printout_frequency, opts.chain_length,
                               n_traits=cfg.n_traits)

    if burnin_outer > 0 and not resumed:
        states, accums, _ = mc(states, data, accums, burnin_outer, False)

    for w in range(w0, n_saved):
        states, accums, out = mc(states, data, accums, thin_outer, True)
        iters_done = (burnin_outer + (w + 1) * thin_outer) * nreps
        if upf > 0 and iters_done // upf > prior_epoch:
            # shared MTData priors refresh from the POOLED accum means —
            # chains stay exchangeable (see mcmc._apply_update_priors_mc)
            prior_epoch = iters_done // upf
            data = _apply_update_priors_mt(
                cfg, data, jax.tree.map(lambda x: jnp.mean(x, axis=0), accums)
            )
        # ONE batched device->host transfer per saved window
        out_h, states_h = jax.device_get((out, states))
        out0 = jax.tree.map(lambda x: x[0], out_h)
        # per-chain draws enter the sample list individually so posterior SDs
        # are taken over the flattened (sample, chain) axes — appending the
        # chain MEAN here would shrink reported SDs by ~sqrt(n_chains) vs the
        # single-chain (and reference) semantics; estimates are unchanged
        # because windows are equal-length across chains
        for k_, v in (("R", out_h.R), ("varg", out_h.varg), ("pi", out_h.pi),
                      ("genvar", out_h.genvar), ("h2", out_h.h2)):
            samples[k_].extend(np.asarray(v))
        if cfg.sem_edges:
            samples["lam"].append(np.asarray(out0.lam))
            samples["alpha"].append(
                np.asarray(states_h.alpha[0])[:, : cfg.n_markers]
            )
        chain_track["h2"].append(np.asarray(out_h.h2))        # (K, t)
        chain_track["genvar"].append(np.asarray(out_h.genvar))  # (K, t, t)
        chain_track["R"].append(np.asarray(out_h.R))
        varg_h = np.asarray(out_h.varg)
        if varg_h.ndim == 4:            # per-locus BayesB: track the mean block
            varg_h = varg_h.mean(axis=1)
        chain_track["varg"].append(varg_h)                    # (K, t, t)
        state0 = jax.tree.map(lambda x: x[0], states_h)
        stream.write_sample(state0, out0)
        for k, cs in enumerate(chain_streams):
            if k == 0:
                cs.write_sample(state0, out0)
            else:
                cs.write_sample(jax.tree.map(lambda x: x[k], states_h),
                                jax.tree.map(lambda x: x[k], out_h))
        progress.update(iters_done,
                        vare=out0.R, varg=out0.varg, pi=out0.pi)
        if ck_every_w and (w + 1) % ck_every_w == 0:
            ck_samples = dict(samples)
            ck_samples.update({f"c_{k}": v for k, v in chain_track.items()})
            ckpt.save_checkpoint(
                ck_folder, iters_done,
                (states, accums, data.vc_scale, data.marker_scale,
                 data.scale_R),
                ck_samples,
                {"w_next": w + 1, "prior_epoch": prior_epoch},
                keep=opts.checkpoint_keep,
            )
    stream.close()
    for cs in chain_streams:
        cs.close()

    pooled = jax.tree.map(lambda x: x.mean(axis=0), accums)
    from jwas_tpu.engine.output_mt import build_mt_results

    results = build_mt_results(ws, cfg, pooled, samples, opts)
    if stream.enabled and ws.geno is not None and stream.write_markers:
        results["_marker_sample_files"] = {
            trait: stream.writer.path(f"marker_effects_{ws.geno.name}_{trait}")
            for trait in model.lhs_vec
        }
    if chain_streams:
        results["_chain_sample_folders"] = [
            cs.writer.folder for cs in chain_streams
        ]
    if n_saved > 1:
        from jwas_tpu.analysis.diagnostics import PSRF as _psrf

        rows = []
        t = cfg.n_traits

        def add(name, col):
            if np.allclose(col.std(axis=0), 0.0):
                return
            try:
                rows.append((name, float(_psrf(*[col[:, c] for c in range(K)]))))
            except Exception:
                pass

        for name, arr, diag in (("h2", np.stack(chain_track["h2"]), False),
                                ("genvar", np.stack(chain_track["genvar"]), True),
                                ("R", np.stack(chain_track["R"]), True),
                                ("varg", np.stack(chain_track["varg"]), True)):
            for ti in range(t):
                add(f"{name}[{ti}]", arr[:, :, ti, ti] if diag else arr[:, :, ti])
        # per-trait-pair genetic correlations from the tracked genvar draws
        gv = np.stack(chain_track["genvar"])         # (n_saved, K, t, t)
        for ti in range(t):
            for tj in range(ti + 1, t):
                denom = np.sqrt(np.abs(gv[:, :, ti, ti] * gv[:, :, tj, tj]))
                add(f"gencor[{ti},{tj}]",
                    gv[:, :, ti, tj] / np.where(denom == 0, 1.0, denom))
        results["PSRF"] = pd.DataFrame(rows, columns=["parameter", "PSRF"])
    return results


def run_mcmc_mt(model, df: pd.DataFrame, opts, dtype):
    ws = prepare_workspace(model, df, opts)
    cfg, data, state = build_mt_data_and_state(ws, opts, dtype)

    if int(opts.n_chains or 1) > 1:
        return _run_mt_multichain(ws, model, cfg, data, state, opts)

    nreps = cfg.nreps
    n_outer = max(1, opts.chain_length // nreps)
    burnin_outer = opts.burnin // nreps
    osf = opts.output_samples_frequency
    if osf <= 0:
        osf = max(1, opts.chain_length // 1000)
    thin_outer = max(1, osf // nreps)
    n_saved = max(1, (n_outer - burnin_outer) // thin_outer)

    run_window = make_mt_run_window(cfg)
    accum = _init_mt_accum(cfg, data, state)

    samples = {"R": [], "varg": [], "pi": [], "genvar": [], "h2": [],
               "lam": [], "alpha": []}
    upf = int(opts.update_priors_frequency or 0)
    prior_epoch = 0
    w0 = 0

    from jwas_tpu.utils import checkpoint as ckpt

    ck_folder = opts.checkpoint_folder or os.path.join(
        opts.output_folder or "results", "checkpoint"
    )
    ck_every_w = 0
    if opts.checkpoint_frequency and int(opts.checkpoint_frequency) > 0:
        ck_every_w = max(1, int(opts.checkpoint_frequency) // (thin_outer * nreps))
    resumed = False
    if opts.resume:
        path = ckpt.latest_checkpoint(ck_folder)
        if path is not None:
            template = (state, accum, data.vc_scale, data.scale_R,
                        data.marker_scale)
            (state, accum, vc_scale, scale_R, marker_scale), smp, meta = (
                ckpt.load_checkpoint(path, template)
            )
            data = data._replace(vc_scale=vc_scale, scale_R=scale_R,
                                 marker_scale=marker_scale)
            samples = {k: smp.get(k, []) for k in samples}
            prior_epoch = int(meta["prior_epoch"])
            w0 = int(meta["w_next"])
            resumed = True

    # per-parameter MCMC sample files (output.jl:320-526)
    from jwas_tpu.engine.progress import ProgressPrinter
    from jwas_tpu.engine.samples_io import MTSampleStream

    stream = MTSampleStream(ws, cfg, opts, append=resumed)
    progress = ProgressPrinter(opts.printout_frequency, opts.chain_length,
                               n_traits=cfg.n_traits)

    if burnin_outer > 0 and not resumed:
        state, accum, _ = run_window(state, data, accum, burnin_outer, accumulate=False)

    for w in range(w0, n_saved):
        state, accum, out = run_window(state, data, accum, thin_outer, accumulate=True)
        iters_done = (burnin_outer + (w + 1) * thin_outer) * nreps
        if upf > 0 and iters_done // upf > prior_epoch:
            prior_epoch = iters_done // upf
            data = _apply_update_priors_mt(cfg, data, accum)
        for k_, v in (("R", out.R), ("varg", out.varg), ("pi", out.pi),
                      ("genvar", out.genvar), ("h2", out.h2)):
            samples[k_].append(np.asarray(v))
        if cfg.sem_edges:
            samples["lam"].append(np.asarray(out.lam))
            samples["alpha"].append(np.asarray(state.alpha)[:, : cfg.n_markers])
        stream.write_sample(state, out)
        progress.update(iters_done, vare=out.R, varg=out.varg, pi=out.pi)
        if ck_every_w and (w + 1) % ck_every_w == 0:
            ckpt.save_checkpoint(
                ck_folder,
                (burnin_outer + (w + 1) * thin_outer) * nreps,
                (state, accum, data.vc_scale, data.scale_R, data.marker_scale),
                samples,
                {"w_next": w + 1, "prior_epoch": prior_epoch},
                keep=opts.checkpoint_keep,
            )

    stream.close()
    from jwas_tpu.engine.output_mt import build_mt_results

    results = build_mt_results(ws, cfg, accum, samples, opts)
    if stream.enabled and ws.geno is not None and stream.write_markers:
        results["_marker_sample_files"] = {
            trait: stream.writer.path(f"marker_effects_{ws.geno.name}_{trait}")
            for trait in model.lhs_vec
        }
    return results
