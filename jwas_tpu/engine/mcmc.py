"""The MCMC driver: jitted Gibbs step + chain loop + posterior outputs.

Device-side re-design of the reference training loop (reference:
src/1.JWAS/src/MCMC/MCMC_BayesianAlphabet.jl). One compiled `step` advances
the whole chain state one (outer) iteration:

  1. location parameters    — single-site Gibbs over the dense MME
  2. marker effects         — blocked/vectorized Bayesian-alphabet sweep
  2b. pi                    — Beta/Dirichlet draw
  2c. marker-effect variance
  3. random-effect covariances (inverse-Wishart) and residual variance

A `lax.scan` over the thinning window keeps the whole sampling loop on
device; only thinned summaries cross back to the host. Posterior means and
variances are accumulated on device with the same running-mean updates as the
reference (output.jl:556-604).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import partial
from typing import NamedTuple, Optional, Tuple  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd

from jwas_tpu.engine.setup import (MCMCOptions, Workspace, prepare_workspace,
                                   resolve_sync_every as _resolve_sync)
from jwas_tpu.engine.state import ChainState, EngineCfg, REGroupCfg
from jwas_tpu.models.model import Model
from jwas_tpu.ops import markers as mk
from jwas_tpu.utils.backend import (
    device_memory_bytes,
    enable_compile_cache,
    resolve_use_pallas,
)
from jwas_tpu.ops.dists import sample_inv_wishart
from jwas_tpu.ops.location import gibbs_pass_lambda
from jwas_tpu.ops.variance import (
    sample_bayesl_gamma,
    sample_marker_variance_bayesb,
    sample_marker_variance_bayesr,
    sample_marker_variance_common,
    sample_pi_abc,
    sample_pi_bayesr,
    sample_residual_variance_st,
    sample_scale_st,
)


class STData(NamedTuple):
    """Static device data for a single-trait chain."""

    W: jnp.ndarray            # (n, K)
    WtRinvW: jnp.ndarray      # (K, K) base LHS
    rinv: jnp.ndarray         # (n,) inverse weights (ones if unweighted)
    y: jnp.ndarray            # (n,)
    X: jnp.ndarray            # (n, p_pad) markers (or L for GBLUP)
    xpx: jnp.ndarray          # (p_pad,) (or D for GBLUP)
    grams: jnp.ndarray        # (nblocks, b, b) or (0,)
    valid: jnp.ndarray        # (p_pad,)
    Vinv: Tuple[jnp.ndarray, ...]      # per RE group (q,q); (0,0) for identity
    vc_scale: Tuple[jnp.ndarray, ...]  # per RE group (k,k)
    out_geno: jnp.ndarray     # (n_out, p) or (0, 0)
    out_W: jnp.ndarray        # (n_out, K) prediction-equation incidence (or zeros)
    category_obs: Optional[jnp.ndarray] = None  # (n,) int32, 0 = missing
    cens_lower: Optional[jnp.ndarray] = None    # (n,) censored lower bounds
    cens_upper: Optional[jnp.ndarray] = None    # (n,)
    anno_A: Optional[jnp.ndarray] = None        # (p_pad, k) annotation design
    packed: Optional[jnp.ndarray] = None        # (p_pad, bpm) uint8 2-bit store
    packed_means: Optional[jnp.ndarray] = None  # (p_pad,)
    row_perm: Optional[jnp.ndarray] = None      # (n,) store-row per observation
    scale_r: Optional[jnp.ndarray] = None       # scalar residual-variance prior scale
                                                # (device-resident so update_priors can
                                                # change it without recompiling)
    packed_dev: Optional[jnp.ndarray] = None    # hybrid out-of-core: device-resident
                                                # copy of the leading store groups
                                                # (grouped.hybridize)
    sl: Optional[object] = None                 # sparse_mme.SparseLoc: matrix-free
                                                # location design (sparse_loc mode;
                                                # W/WtRinvW/out_W are then empty)
    out_w_rows: Optional[jnp.ndarray] = None    # sparse prediction incidence COO
    out_w_cols: Optional[jnp.ndarray] = None
    out_w_vals: Optional[jnp.ndarray] = None


def assemble_lhs_lambda(re_groups, WtRinvW, Vinv, vc, vare):
    """LHS = W'RinvW + sum_groups Vinv x (Gi[i,j] * vare) (addVinv,
    random_effects.jl:218-238, lambda version rebuilt from scratch)."""
    LHS = WtRinvW
    for g, grp in enumerate(re_groups):
        Gi = jnp.linalg.inv(vc[g])
        q = grp.n_levels
        for i, si in enumerate(grp.starts):
            for j, sj in enumerate(grp.starts):
                lam = Gi[i, j] * vare
                if grp.has_vinv:
                    LHS = jax.lax.dynamic_update_slice(
                        LHS,
                        jax.lax.dynamic_slice(LHS, (si, sj), (q, q)) + Vinv[g] * lam,
                        (si, sj),
                    )
                else:
                    idx = si + jnp.arange(q)
                    jdx = sj + jnp.arange(q)
                    LHS = LHS.at[idx, jdx].add(lam)
    return LHS


def _assemble_lhs(cfg: EngineCfg, data: STData, vc, vare):
    return assemble_lhs_lambda(cfg.re_groups, data.WtRinvW, data.Vinv, vc, vare)


def make_st_step(cfg: EngineCfg):
    """Build the jitted one-iteration Gibbs step for a single-trait chain."""

    trait_type = cfg.trait_types[0] if cfg.trait_types else "continuous"
    is_latent = trait_type in ("categorical", "categorical(binary)", "censored")
    n_cat = cfg.cat_counts[0] if cfg.cat_counts else 0

    def step(state: ChainState, data: STData) -> ChainState:
        (key, k_loc, k_mark, k_pi, k_var, k_gam, k_scale, k_res, k_liab, k_thr,
         k_ann, *k_vc) = jax.random.split(state.key, 11 + len(cfg.re_groups))
        dtype = state.ycorr.dtype
        rinv = data.rinv if cfg.has_weights else None

        # 0. latent liabilities for categorical/binary/censored traits
        # (sample_liabilities! + categorical_trait_sample_threshold!,
        # categorical_and_censored_trait.jl:127-210)
        ycorr0 = state.ycorr
        liab = state.liab
        thresholds = state.thresholds
        if is_latent:
            from jwas_tpu.ops.threshold import (
                BIG,
                bounds_from_thresholds,
                sample_thresholds_t,
            )

            if trait_type == "censored":
                lb, ub = data.cens_lower, data.cens_upper
            else:
                lb, ub = bounds_from_thresholds(thresholds, data.category_obs)
            cmean = liab - ycorr0
            eps_lb = lb - cmean
            eps_ub = ub - cmean
            fixed = eps_lb >= eps_ub
            std = jnp.sqrt(state.vare)
            a = jnp.clip(jnp.where(fixed, -1.0, eps_lb) / std, -BIG, BIG)
            b_ = jnp.clip(jnp.where(fixed, 1.0, eps_ub) / std, -BIG, BIG)
            z = jax.random.truncated_normal(k_liab, a, b_, shape=cmean.shape, dtype=dtype)
            eps = jnp.where(fixed, ycorr0, std * z)
            liab = cmean + eps
            ycorr0 = eps
            if trait_type == "categorical" and n_cat > 2:
                thresholds = sample_thresholds_t(
                    k_thr, thresholds, liab, data.category_obs, n_cat, start_index=2
                )

        # 1. location parameters (MCMC_BayesianAlphabet.jl:196-220)
        if cfg.sparse_loc:
            # matrix-free sparse MME: exact joint PO-CG draw instead of the
            # dense single-site pass (ops/sparse_mme.py; the reference's
            # sparse-LHS Gibbs, solver.jl:105-162, re-designed for an accelerator)
            from jwas_tpu.ops import sparse_mme as sm

            sl = data.sl
            ycorr = ycorr0 + sm.w_matvec(sl, state.sol, cfg.n_obs)
            w = ycorr if rinv is None else rinv * ycorr
            rhs = sm.w_rhs(sl, w, cfg.n_loc)
            gis = [jnp.linalg.inv(state.vc[g])
                   for g in range(len(cfg.re_groups))]
            chols = [jnp.linalg.cholesky(gi) for gi in gis]
            sol = sm.sample_location_po(
                k_loc, sl, cfg.re_groups, rhs, gis, state.vare, rinv,
                cfg.n_obs, chols, x0=state.sol, tol=cfg.cg_tol,
                maxiter=cfg.cg_maxiter,
            )
            ycorr = ycorr - sm.w_matvec(sl, sol, cfg.n_obs)
        else:
            LHS = _assemble_lhs(cfg, data, state.vc, state.vare)
            ycorr = ycorr0 + mk.fdot(data.W, state.sol)
            w = ycorr if rinv is None else rinv * ycorr
            rhs = mk.fdot(data.W.T, w)
            sol = gibbs_pass_lambda(LHS, state.sol, rhs, state.vare, k_loc)
            ycorr = ycorr - mk.fdot(data.W, sol)

        # 2. marker effects (method dispatch, MCMC_BayesianAlphabet.jl:224-338)
        alpha, beta, delta, gamma_l, pi, varg = (
            state.alpha, state.beta, state.delta, state.gamma_l, state.pi, state.varg,
        )
        if cfg.method in ("BayesC", "BayesB") and cfg.is_packed and cfg.grouped:
            # group-sequential sweep over the 2-bit store, device-resident or
            # streamed from pinned host (ops/grouped.py;
            # streaming_genotypes.jl:978-1027)
            from jwas_tpu.ops.grouped import (
                GroupedPackedMarkers,
                sweep_blocks_abc_grouped,
            )

            gm = GroupedPackedMarkers(
                data.packed, data.packed_means, data.row_perm,
                data.xpx, data.grams, data.valid, data.packed_dev,
            )
            alpha, beta, delta, ycorr = sweep_blocks_abc_grouped(
                gm, alpha, beta, delta, ycorr, rinv, state.vare, varg, pi,
                k_mark, nreps=cfg.nreps, sync_every=cfg.sync_every,
                host_store=cfg.host_offload, use_pallas=cfg.use_pallas,
                has_missing=cfg.has_missing_codes, prefetch=cfg.prefetch,
            )
        elif cfg.method in ("BayesC", "BayesB") and cfg.is_packed:
            # flat 2-bit sweep: marker-sharded meshes only
            from jwas_tpu.ops.packed import PackedMarkers, sweep_blocks_abc_packed

            pm = PackedMarkers(
                data.packed, data.packed_means, data.row_perm,
                data.xpx, data.grams, data.valid,
            )
            alpha, beta, delta, ycorr = sweep_blocks_abc_packed(
                pm, alpha, beta, delta, ycorr, rinv, state.vare, varg, pi,
                k_mark, nreps=cfg.nreps, sync_every=cfg.sync_every,
            )
        elif (cfg.method in ("BayesC", "BayesB") and cfg.use_blocks
              and cfg.group_blocks):
            # dense group-sequential schedule: the flat sweep's stale set is
            # all of p, which diverges at p >> n (stability_sweep_r05.md);
            # groups are visited sequentially exactly like the packed path
            per_m = cfg.method == "BayesB"
            md_d = mk.MarkerBlocks(data.X, data.xpx, data.grams, data.valid)

            def cg_abc(md_g, sts, yc, g, kg):
                a, be, d, pi_g = sts[:4]
                ve_g = sts[4] if per_m else varg
                a, be, d, yc = mk.sweep_blocks_abc(
                    md_g, a, be, d, yc, rinv, state.vare, ve_g, pi_g,
                    kg, nreps=cfg.nreps, sync_every=cfg.sync_every,
                    use_pallas=cfg.use_pallas,
                )
                return (a, be, d, pi_g) + ((ve_g,) if per_m else ()), yc

            sts = (alpha, beta, delta, pi) + ((varg,) if per_m else ())
            out, ycorr = mk.grouped_dense_sweep(
                cg_abc, md_d, sts, ycorr, k_mark, cfg.group_blocks
            )
            alpha, beta, delta = out[0], out[1], out[2]
        elif cfg.method in ("BayesC", "BayesB"):
            # varg is scalar for BayesC, per-marker (p_pad,) for BayesB; the
            # sweeps broadcast either shape
            var_eff = varg
            if cfg.use_blocks:
                alpha, beta, delta, ycorr = mk.sweep_blocks_abc(
                    mk.MarkerBlocks(data.X, data.xpx, data.grams, data.valid),
                    alpha, beta, delta, ycorr, rinv, state.vare, var_eff, pi,
                    k_mark, nreps=cfg.nreps, sync_every=cfg.sync_every,
                    use_pallas=cfg.use_pallas,
                )
            else:
                alpha, beta, delta, ycorr = mk.sweep_exact_abc(
                    data.X, data.xpx, alpha, beta, delta, ycorr, rinv,
                    state.vare, var_eff, pi, k_mark,
                )
        elif cfg.method in ("RR-BLUP", "BayesL"):
            if cfg.use_blocks and cfg.group_blocks:
                md_d = mk.MarkerBlocks(data.X, data.xpx, data.grams,
                                       data.valid)

                def cg_c0l(md_g, sts, yc, g, kg):
                    a, gam_g = sts
                    a, yc = mk.sweep_blocks_c0l(
                        md_g, a, yc, rinv, state.vare, varg, gam_g, kg,
                        nreps=cfg.nreps, sync_every=cfg.sync_every,
                    )
                    return (a, gam_g), yc

                (alpha, _), ycorr = mk.grouped_dense_sweep(
                    cg_c0l, md_d, (alpha, gamma_l), ycorr, k_mark,
                    cfg.group_blocks,
                )
            elif cfg.use_blocks:
                alpha, ycorr = mk.sweep_blocks_c0l(
                    mk.MarkerBlocks(data.X, data.xpx, data.grams, data.valid),
                    alpha, ycorr, rinv, state.vare, varg, gamma_l, k_mark,
                    nreps=cfg.nreps, sync_every=cfg.sync_every,
                )
            else:
                alpha, ycorr = mk.sweep_exact_c0l(
                    data.X, data.xpx, alpha, ycorr, rinv, state.vare, varg,
                    gamma_l, k_mark,
                )
        elif cfg.method == "BayesR":
            if pi.ndim == 2:
                pi_mat = pi          # annotated: per-marker class priors
            else:
                pi_mat = jnp.where(
                    data.valid[:, None] > 0,
                    jnp.broadcast_to(pi[None, :], (data.valid.shape[0], 4)),
                    jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype)[None, :],
                )
            if cfg.is_packed and cfg.grouped:
                from jwas_tpu.ops.grouped import (
                    GroupedPackedMarkers,
                    sweep_blocks_bayesr_grouped,
                )

                gm = GroupedPackedMarkers(
                    data.packed, data.packed_means, data.row_perm,
                    data.xpx, data.grams, data.valid, data.packed_dev,
                )
                alpha, delta, ycorr = sweep_blocks_bayesr_grouped(
                    gm, alpha, delta, ycorr, rinv, state.vare, varg, pi_mat,
                    k_mark, nreps=cfg.nreps, sync_every=cfg.sync_every,
                    host_store=cfg.host_offload, use_pallas=cfg.use_pallas,
                    has_missing=cfg.has_missing_codes, prefetch=cfg.prefetch,
                )
            elif cfg.is_packed:
                from jwas_tpu.ops.packed import (
                    PackedMarkers,
                    sweep_blocks_bayesr_packed,
                )

                pm = PackedMarkers(
                    data.packed, data.packed_means, data.row_perm,
                    data.xpx, data.grams, data.valid,
                )
                alpha, delta, ycorr = sweep_blocks_bayesr_packed(
                    pm, alpha, delta, ycorr, rinv, state.vare, varg, pi_mat,
                    k_mark, nreps=cfg.nreps, sync_every=cfg.sync_every,
                )
            elif cfg.use_blocks and cfg.group_blocks:
                md_d = mk.MarkerBlocks(data.X, data.xpx, data.grams,
                                       data.valid)

                def cg_r(md_g, sts, yc, g, kg):
                    a, d, piT_g = sts
                    a, d, yc = mk.sweep_blocks_bayesr(
                        md_g, a, d, yc, rinv, state.vare, varg, piT_g.T,
                        kg, nreps=cfg.nreps, sync_every=cfg.sync_every,
                        use_pallas=cfg.use_pallas,
                    )
                    return (a, d, piT_g), yc

                (alpha, delta, _), ycorr = mk.grouped_dense_sweep(
                    cg_r, md_d, (alpha, delta, pi_mat.T), ycorr, k_mark,
                    cfg.group_blocks,
                )
            elif cfg.use_blocks:
                alpha, delta, ycorr = mk.sweep_blocks_bayesr(
                    mk.MarkerBlocks(data.X, data.xpx, data.grams, data.valid),
                    alpha, delta, ycorr, rinv, state.vare, varg, pi_mat, k_mark,
                    nreps=cfg.nreps, sync_every=cfg.sync_every,
                    use_pallas=cfg.use_pallas,
                )
            else:
                alpha, delta, ycorr = mk.sweep_exact_bayesr(
                    data.X, data.xpx, alpha, delta, ycorr, rinv, state.vare,
                    varg, pi_mat, k_mark,
                )
        elif cfg.method == "GBLUP":
            alpha, ycorr = mk.sweep_gblup(
                data.X, data.xpx, alpha, ycorr, rinv, state.vare, varg, k_mark
            )
        elif cfg.method != "none":
            raise ValueError(f"unknown method {cfg.method}")

        # 2b. pi: annotation probits replace the Beta/Dirichlet draw when
        # annotations are attached (MCMC_BayesianAlphabet.jl:294-317)
        ann_coeffs, ann_var = state.ann_coeffs, state.ann_var
        if cfg.anno_steps == 1:
            from jwas_tpu.ops.annotations import anno_bayesc_update

            ann_coeffs, ann_var, pi = anno_bayesc_update(
                k_ann, data.anno_A, delta, ann_coeffs, ann_var, data.valid
            )
            pi = pi.astype(dtype)
        elif cfg.anno_steps == 3:
            from jwas_tpu.ops.annotations import anno_bayesr_update

            ann_coeffs, ann_var, pi = anno_bayesr_update(
                k_ann, data.anno_A, delta, ann_coeffs, ann_var, data.valid
            )
            pi = pi.astype(dtype)
        elif cfg.estimate_pi:
            if cfg.method == "BayesR":
                pi = sample_pi_bayesr(k_pi, delta, data.valid).astype(dtype)
            else:
                pi_scalar = sample_pi_abc(k_pi, delta, cfg.n_markers, data.valid)
                pi = jnp.where(data.valid > 0, pi_scalar.astype(dtype), 1.0)

        # 2c. marker-effect variance (variance_components.jl:151-189)
        if cfg.estimate_marker_variance and cfg.method != "none":
            if cfg.method == "BayesC":
                nloci = jnp.sum(jnp.where(data.valid > 0, delta, 0))
                varg = sample_marker_variance_common(
                    k_var, alpha, nloci, cfg.df_marker, state.scale_g
                )
            elif cfg.method == "RR-BLUP":
                varg = sample_marker_variance_common(
                    k_var, alpha, cfg.n_markers, cfg.df_marker, state.scale_g
                )
            elif cfg.method == "BayesL":
                varg = sample_marker_variance_common(
                    k_var, alpha, cfg.n_markers, cfg.df_marker, state.scale_g,
                    invweights=1.0 / gamma_l,
                )
                gamma_l = sample_bayesl_gamma(k_gam, gamma_l, alpha, varg, data.valid)
            elif cfg.method == "GBLUP":
                varg = sample_marker_variance_common(
                    k_var, alpha, cfg.n_markers, cfg.df_marker, state.scale_g,
                    invweights=1.0 / data.xpx,
                )
            elif cfg.method == "BayesB":
                varg = sample_marker_variance_bayesb(k_var, beta, cfg.df_marker, state.scale_g)
            elif cfg.method == "BayesR":
                varg = sample_marker_variance_bayesr(
                    k_var, alpha, delta, cfg.df_marker, state.scale_g
                )
            varg = varg.astype(dtype)

        # 2d. prior scale for the marker-effect variance
        scale_g = state.scale_g
        if cfg.estimate_scale and cfg.method != "none":
            if cfg.method == "BayesB":
                v = jnp.where(data.valid > 0, varg, 1.0)
                a = cfg.n_markers * cfg.df_marker / 2.0 + 1.0
                b = jnp.sum(jnp.where(data.valid > 0, cfg.df_marker / (2.0 * v), 0.0)) + 1.0
                scale_g = (jax.random.gamma(k_scale, a) / b).astype(dtype)
            else:
                scale_g = sample_scale_st(k_scale, varg, cfg.df_marker).astype(dtype)

        # 3.1 random-effect covariance components (sampleVCs)
        vc = list(state.vc)
        for g, grp in enumerate(cfg.re_groups):
            q = grp.n_levels
            sols = jnp.stack([jax.lax.dynamic_slice(sol, (s,), (q,)) for s in grp.starts])
            if grp.has_vinv and cfg.sparse_loc:
                from jwas_tpu.ops.sparse_mme import _vinv_matvec

                slg = data.sl.groups[g]
                Vs = jnp.stack([_vinv_matvec(slg, sols[i], False)
                                for i in range(len(grp.starts))])
                S = sols @ Vs.T
            elif grp.has_vinv:
                S = sols @ (data.Vinv[g] @ sols.T)
            else:
                S = sols @ sols.T
            S = 0.5 * (S + S.T)
            vc[g] = sample_inv_wishart(
                k_vc[g], grp.df + q, data.vc_scale[g] + S
            ).astype(dtype)
        vc = tuple(vc)

        # 3.2 residual variance
        vare = state.vare
        if cfg.estimate_residual_variance:
            scale_r = (
                data.scale_r if data.scale_r is not None
                else jnp.asarray(cfg_scale_R(cfg), dtype)
            )
            vare = sample_residual_variance_st(
                k_res, ycorr, cfg.n_obs, cfg.df_residual, scale_r,
                invweights=rinv,
            ).astype(dtype)

        return ChainState(
            key=key, sol=sol, alpha=alpha, beta=beta, delta=delta,
            gamma_l=gamma_l, ycorr=ycorr, vare=vare, varg=varg, pi=pi,
            scale_g=scale_g, vc=vc, liab=liab, thresholds=thresholds,
            ann_coeffs=ann_coeffs, ann_var=ann_var,
        )

    return step


# The residual-variance prior scale is a static float carried on the config.
@dataclass(frozen=True)
class STEngineCfg(EngineCfg):
    scale_R: float = 0.0


def cfg_scale_R(cfg):
    return cfg.scale_R


class SampleOut(NamedTuple):
    """Per saved sample, small device->host summaries."""

    vare: jnp.ndarray
    varg_mean: jnp.ndarray     # scalar summary (mean over markers for BayesB)
    pi_summary: jnp.ndarray    # (4,) for BayesR else scalar in [0]
    ebv: jnp.ndarray           # (n_out,)
    genvar: jnp.ndarray
    h2: jnp.ndarray


class Accum(NamedTuple):
    n: jnp.ndarray
    sol_m: jnp.ndarray
    sol_m2: jnp.ndarray
    alpha_m: jnp.ndarray
    alpha_m2: jnp.ndarray
    delta_m: jnp.ndarray
    vare_m: jnp.ndarray
    vare_m2: jnp.ndarray
    varg_m: jnp.ndarray
    varg_m2: jnp.ndarray
    pi_m: jnp.ndarray
    pi_m2: jnp.ndarray
    scale_m: jnp.ndarray
    scale_m2: jnp.ndarray
    ebv_m: jnp.ndarray
    ebv_m2: jnp.ndarray
    vc_m: Tuple[jnp.ndarray, ...]
    vc_m2: Tuple[jnp.ndarray, ...]
    # defaults are None (not jnp.zeros) so importing the module does not
    # initialize the XLA backend (jax.distributed must run first on pods)
    ann_m: Optional[jnp.ndarray] = None
    ann_m2: Optional[jnp.ndarray] = None


def _welford(m, x, n):
    return m + (x - m) / n


def make_run_window(cfg):
    step = make_st_step(cfg)

    @partial(jax.jit, static_argnames=("n_iters", "accumulate"))
    def run_window(state: ChainState, data: STData, accum: Accum,
                   n_iters: int, accumulate: bool = True):
        def body(s, _):
            return step(s, data), None

        state, _ = jax.lax.scan(body, state, None, length=n_iters)

        # EBV for output individuals: prediction terms + markers
        # (getEBV, output.jl:281-306)
        if cfg.sparse_loc and data.out_w_rows is not None:
            ebv = jnp.zeros((data.out_W.shape[0],), state.sol.dtype)
            ebv = ebv.at[data.out_w_rows].add(
                data.out_w_vals * state.sol[data.out_w_cols]
            )
        else:
            ebv = data.out_W @ state.sol
        if cfg.method != "none" and data.out_geno.shape[0] > 0:
            ebv = ebv + mk.fdot(data.out_geno,
                                state.alpha[: data.out_geno.shape[1]])
        genvar = jnp.var(ebv) if ebv.shape[0] > 1 else jnp.zeros((), ebv.dtype)
        h2 = genvar / (genvar + state.vare)

        if cfg.method == "BayesB":
            varg_mean = jnp.sum(jnp.where(data.valid > 0, state.varg, 0.0)) / cfg.n_markers
        else:
            varg_mean = jnp.asarray(state.varg)
        if cfg.method == "BayesR" and state.pi.ndim == 2:
            # annotated: summarize per-marker class priors by their mean
            pi_summary = jnp.sum(
                jnp.where((data.valid > 0)[:, None], state.pi, 0.0), axis=0
            ) / cfg.n_markers
        elif cfg.method == "BayesR":
            pi_summary = state.pi
        elif cfg.anno_steps == 1:
            pi_summary = jnp.zeros((4,), state.ycorr.dtype).at[0].set(
                jnp.sum(jnp.where(data.valid > 0, state.pi, 0.0)) / cfg.n_markers
            )
        elif state.pi.shape[0] > 0:
            pi_summary = jnp.zeros((4,), state.ycorr.dtype).at[0].set(state.pi[0])
        else:
            pi_summary = jnp.zeros((4,), state.ycorr.dtype)

        out = SampleOut(
            vare=state.vare, varg_mean=varg_mean, pi_summary=pi_summary,
            ebv=ebv, genvar=genvar, h2=h2,
        )

        if accumulate:
            n = accum.n + 1.0
            accum = Accum(
                n=n,
                sol_m=_welford(accum.sol_m, state.sol, n),
                sol_m2=_welford(accum.sol_m2, state.sol**2, n),
                alpha_m=_welford(accum.alpha_m, state.alpha, n),
                alpha_m2=_welford(accum.alpha_m2, state.alpha**2, n),
                delta_m=_welford(
                    accum.delta_m,
                    (state.delta > 0).astype(state.alpha.dtype)
                    if cfg.method == "BayesR"
                    else state.delta.astype(state.alpha.dtype),
                    n,
                ),
                vare_m=_welford(accum.vare_m, state.vare, n),
                vare_m2=_welford(accum.vare_m2, state.vare**2, n),
                varg_m=_welford(accum.varg_m, varg_mean, n),
                varg_m2=_welford(accum.varg_m2, varg_mean**2, n),
                pi_m=_welford(accum.pi_m, pi_summary, n),
                pi_m2=_welford(accum.pi_m2, pi_summary**2, n),
                scale_m=_welford(accum.scale_m, state.scale_g, n),
                scale_m2=_welford(accum.scale_m2, state.scale_g**2, n),
                ebv_m=_welford(accum.ebv_m, ebv, n),
                ebv_m2=_welford(accum.ebv_m2, ebv**2, n),
                vc_m=tuple(_welford(m, v, n) for m, v in zip(accum.vc_m, state.vc)),
                vc_m2=tuple(_welford(m, v**2, n) for m, v in zip(accum.vc_m2, state.vc)),
                ann_m=(
                    _welford(accum.ann_m, state.ann_coeffs, n)
                    if cfg.anno_steps > 0 else accum.ann_m
                ),
                ann_m2=(
                    _welford(accum.ann_m2, state.ann_coeffs**2, n)
                    if cfg.anno_steps > 0 else accum.ann_m2
                ),
            )
        return state, accum, out

    return run_window


def _init_accum(cfg, data: STData, state: ChainState) -> Accum:
    z = jnp.zeros
    dt = state.ycorr.dtype
    return Accum(
        n=jnp.zeros((), dt),
        sol_m=z(state.sol.shape, dt), sol_m2=z(state.sol.shape, dt),
        alpha_m=z(state.alpha.shape, dt), alpha_m2=z(state.alpha.shape, dt),
        delta_m=z(state.alpha.shape, dt),
        vare_m=z((), dt), vare_m2=z((), dt),
        varg_m=z((), dt), varg_m2=z((), dt),
        pi_m=z((4,), dt), pi_m2=z((4,), dt),
        scale_m=z((), dt), scale_m2=z((), dt),
        ebv_m=z((data.out_W.shape[0],), dt), ebv_m2=z((data.out_W.shape[0],), dt),
        vc_m=tuple(z(v.shape, dt) for v in state.vc),
        vc_m2=tuple(z(v.shape, dt) for v in state.vc),
        ann_m=z(state.ann_coeffs.shape if state.ann_coeffs is not None else (0,), dt),
        ann_m2=z(state.ann_coeffs.shape if state.ann_coeffs is not None else (0,), dt),
    )


def _apply_update_priors(cfg, data: STData, state: ChainState, accum: Accum):
    """Empirical-Bayes prior refresh from running posterior means
    (MCMC_BayesianAlphabet.jl:381-395, "Update priors using posteriors").

    Applied at thinning-window boundaries (the reference applies it every
    `update_priors_frequency` inner iterations; with the blocked outer loop a
    window boundary is the natural granularity). BayesB keeps its marker-scale
    prior fixed, matching the reference's `methods != "BayesB"` guard.
    """
    if cfg.method not in ("BayesB", "none"):
        # scale = meanVara*(df-2)/df (ST form)
        state = state._replace(
            scale_g=accum.varg_m * (cfg.df_marker - 2.0) / cfg.df_marker
        )
    vc_scale = list(data.vc_scale)
    for g, grp in enumerate(cfg.re_groups):
        if grp.random_type == "A":
            k = len(grp.starts)
            vc_scale[g] = accum.vc_m[g] * (grp.df - k - 1.0)
    data = data._replace(
        vc_scale=tuple(vc_scale),
        scale_r=accum.vare_m * (cfg.df_residual - 2.0) / cfg.df_residual,
    )
    return data, state


def _resolve_use_pallas(flag, use_blocks: bool, method: str, mesh) -> bool:
    """Whether the blocked BayesB/C/R sweeps run the compiled inner-round
    kernel (ops/pallas_sweep.py). "auto" = where the backend has one
    (utils/backend.resolve_use_pallas, which also rejects True where none
    exists). The kernel runs on one device: on a mesh the XLA scan is used,
    which XLA partitions, and an explicit True raises."""
    on = resolve_use_pallas(flag)
    if not on or not use_blocks or method not in ("BayesC", "BayesB",
                                                  "BayesR"):
        return False
    if mesh is not None:
        if flag is True:
            raise ValueError(
                "use_pallas=True is single-device: the inner-round kernel is "
                "not sharded; use use_pallas='auto' (the XLA sweep) on a mesh"
            )
        return False
    return True


def _resolve_host_offload(flag, packed_bytes: int) -> bool:
    """Out-of-core decision: explicit True/False, or 'auto' = offload when
    the packed store exceeds 60% of the device memory budget (the runtime
    analogue of the reference's streaming mode select,
    streaming_genotypes.jl:480-497). Decided from the HOST-side byte count,
    before anything is staged on device. True where the backend cannot
    stage pinned-host memory inside a jitted sweep raises; 'auto' never
    offloads there."""
    from jwas_tpu.ops.grouped import host_memory_supported

    if flag is True:
        if not host_memory_supported():
            raise ValueError(
                f"host_offload_genotypes=True: the {jax.default_backend()!r} "
                f"backend cannot stream a pinned-host store into a jitted "
                f"sweep; use host_offload_genotypes='auto' or False"
            )
        return True
    if flag != "auto" or not host_memory_supported():
        return False
    return packed_bytes > 0.6 * device_memory_bytes()


def _build_st_data_and_state(ws: Workspace, opts: MCMCOptions, dtype):
    model = ws.model
    n = ws.n_obs
    W = jnp.asarray(ws.W, dtype)
    rinv_np = ws.rinv if ws.rinv is not None else np.ones(n)
    rinv = jnp.asarray(rinv_np, dtype)
    WtRinvW = jnp.matmul((W * rinv[:, None]).T, W,
                         precision=mk.full_precision(dtype))
    y = jnp.asarray(ws.y, dtype)

    method = ws.geno.method if ws.geno is not None else "none"
    use_blocks = bool(opts.fast_blocks) and method not in ("GBLUP", "none")

    packed_pm = None
    host_offload = False
    grouped = False
    group_blocks_dense = 0
    if method == "GBLUP":
        X = jnp.asarray(ws.gblup_L, dtype)
        xpx = jnp.asarray(ws.gblup_D, dtype)
        grams = jnp.zeros((0, 0, 0), dtype)
        valid = jnp.ones((X.shape[1],), dtype)
        p = X.shape[1]
        p_pad = p
        nreps = 1
    elif method != "none" and ws.geno.packed_store is not None:
        # 2-bit packed backend: decode-on-the-fly, fast_blocks mandatory
        from jwas_tpu.ops.packed import build_packed_markers

        store = ws.geno.packed_store
        p = store.n_markers
        if opts.fast_blocks is True or not opts.fast_blocks:
            bs = mk.default_block_size(n)
        else:
            bs = int(opts.fast_blocks)
        bs = max(8, ((bs + 7) // 8) * 8)
        mesh = opts.mesh
        marker_sharded = (
            mesh is not None
            and "marker" in tuple(getattr(mesh, "axis_names", ()))
            and int(mesh.shape["marker"]) > 1
        )
        if marker_sharded and opts.host_offload_genotypes is True:
            import warnings

            warnings.warn(
                "host_offload_genotypes=True is ignored on a marker-sharded "
                "mesh: each shard holds only its local packed slice on "
                "device. Drop the 'marker' mesh axis to stream from host."
            )
        # offload decided from host-side bytes BEFORE anything is staged on
        # device — a store larger than device memory must never exist as a
        # flat device array
        host_offload = not marker_sharded and _resolve_host_offload(
            opts.host_offload_genotypes, store.packed.nbytes
        )
        has_missing_codes = True
        if marker_sharded:
            packed_pm = build_packed_markers(
                store, ws.obs_ids, bs,
                rinv=ws.rinv if ws.rinv is not None else None, dtype=dtype,
                mesh=mesh,
            )
        else:
            # grouped schedule for BOTH device-resident and host-offloaded
            # stores: groups walk sequentially, so the parallel-stale marker
            # set per sync round is b*gb, capped by the stability bound
            # (grouped.STALE_FRACTION) — the flat sweep's stale set is ALL
            # of p, which is metastable (can diverge) at p >> n.
            from jwas_tpu.ops.grouped import (
                build_grouped_markers,
                pick_stable_blocks,
                store_has_missing,
            )

            # warn about the stability override only when the user asked for
            # a specific size; the internal default heuristic adjusts quietly
            user_sized = opts.fast_blocks is not True and bool(opts.fast_blocks)
            bs, gb = pick_stable_blocks(n, bs, p, warn=user_sized)
            packed_pm = build_grouped_markers(
                store, ws.obs_ids, bs,
                rinv=ws.rinv if ws.rinv is not None else None, dtype=dtype,
                group_blocks=gb, host=host_offload,
            )
            # prefer the manifest flag recorded at packing time; only stores
            # from pre-flag manifests pay the full LUT scan
            has_missing_codes = (
                store.has_missing if store.has_missing is not None
                else store_has_missing(store.packed)
            )
            grouped = True
            if host_offload:
                # hybrid out-of-core: spare device memory soaks up leading
                # groups
                from jwas_tpu.ops.grouped import hybridize

                packed_pm = hybridize(packed_pm)
        X = jnp.zeros((n, 0), dtype)
        xpx = packed_pm.xpx
        grams = packed_pm.grams
        valid = packed_pm.valid
        p_pad = packed_pm.xpx.shape[0]
        use_blocks = True
        # exact chain-length accounting: never run more effective
        # sweeps than the user asked for (JWAS.jl:313 floors; we
        # clamp nreps so short chains are exact instead of inflated)
        nreps = opts.nreps if opts.nreps is not None else bs
        nreps = max(1, min(nreps, opts.chain_length))
    elif method != "none":
        Xnp = ws.geno.genotypes
        p = ws.geno.n_markers
        if use_blocks:
            if opts.fast_blocks is True:
                bs = mk.default_block_size(n)
            else:
                bs = int(opts.fast_blocks)
                bs = max(8, ((bs + 7) // 8) * 8)
            md = mk.build_marker_blocks(jnp.asarray(Xnp, dtype), rinv if ws.rinv is not None else None, block_size=bs)
            X, xpx, grams, valid = md
            p_pad = X.shape[1]
            # group-sequential schedule when the flat stale set b*nblocks
            # would exceed the stability cap (dense analogue of the packed
            # grouped path; benchmarks/results/stability_sweep_r05.md).
            # Marker-sharded meshes keep the flat per-shard schedule.
            mesh_d = opts.mesh
            dense_marker_sharded = (
                mesh_d is not None
                and "marker" in tuple(getattr(mesh_d, "axis_names", ()))
                and int(mesh_d.shape["marker"]) > 1
            )
            group_blocks_dense = (
                0 if dense_marker_sharded
                else mk.stable_group_blocks(n, bs, grams.shape[2])
            )
            nreps = opts.nreps if opts.nreps is not None else bs
            # exact chain-length accounting: never run more effective
            # sweeps than the user asked for (JWAS.jl:313 floors; we
            # clamp nreps so short chains are exact instead of inflated)
            nreps = max(1, min(nreps, opts.chain_length))
        else:
            X = jnp.asarray(Xnp, dtype)
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

    sparse_mode = ws.W_sparse is not None
    re_cfgs = []
    Vinvs = []
    vc_scales = []
    vc0 = []
    for grp in ws.re_groups:
        factor_rows = 0
        if sparse_mode and grp.Vinv is not None:
            factor_rows = (
                grp.Vinv_factor.shape[0] if grp.Vinv_factor is not None
                else grp.n_levels
            )
        re_cfgs.append(
            REGroupCfg(
                starts=grp.starts,
                n_levels=grp.n_levels,
                df=grp.df,
                has_vinv=grp.Vinv is not None,
                random_type=grp.random_type,
                factor_rows=factor_rows,
            )
        )
        Vinvs.append(
            jnp.asarray(grp.Vinv, dtype)
            if grp.Vinv is not None and not sparse_mode
            else jnp.zeros((0, 0), dtype)
        )
        vc_scales.append(jnp.asarray(grp.scale, dtype))
        vc0.append(jnp.asarray(grp.G0, dtype))

    sl = None
    if sparse_mode:
        from jwas_tpu.ops.sparse_mme import build_sparse_loc

        sl = build_sparse_loc(ws.W_sparse, ws.rinv, ws.re_groups, re_cfgs,
                              dtype=dtype)

    # output structures
    n_out = len(ws.output_ids)
    K = ws.W_sparse.shape[1] if sparse_mode else W.shape[1]
    out_w_rows = out_w_cols = out_w_vals = None
    if sparse_mode:
        import scipy.sparse as _sp

        blocks = []
        for term_name in ws.prediction_terms:
            term = model.term_dict[term_name]
            Xt = _sp.coo_matrix(ws.output_X[term_name])
            blocks.append((Xt.row, Xt.col + term.start_pos, Xt.data))
        if blocks:
            rr = np.concatenate([b[0] for b in blocks])
            cc = np.concatenate([b[1] for b in blocks])
            vv = np.concatenate([b[2] for b in blocks])
        else:
            rr = cc = np.zeros((0,), np.int64)
            vv = np.zeros((0,))
        out_w_rows = jnp.asarray(rr.astype(np.int32))
        out_w_cols = jnp.asarray(cc.astype(np.int32))
        out_w_vals = jnp.asarray(vv, dtype)
    else:
        out_W = np.zeros((n_out, K))
        for term_name in ws.prediction_terms:
            term = model.term_dict[term_name]
            out_W[:, term.start_pos : term.start_pos + term.n_levels] += ws.output_X[term_name]
    out_geno = (
        jnp.asarray(ws.output_genotypes, dtype)
        if ws.output_genotypes is not None
        else jnp.zeros((0, max(p, 1)), dtype)
    )

    data_fields = dict(
        W=W, WtRinvW=WtRinvW, rinv=rinv, y=y, X=X, xpx=xpx, grams=grams,
        valid=valid, Vinv=tuple(Vinvs), vc_scale=tuple(vc_scales),
        out_geno=out_geno, out_W=(
            jnp.zeros((n_out, 0), dtype) if sparse_mode
            else jnp.asarray(out_W, dtype)
        ),
    )

    g = ws.geno
    estimate_pi = bool(g.estimate_pi) if g is not None else False
    trait_type = model.traits_type[0]
    is_latent = trait_type in ("categorical", "categorical(binary)", "censored")

    # latent-trait data: categories / censoring bounds (setup!, cat_cens.jl:29-95)
    category_obs = None
    cens_lower = cens_upper = None
    n_cat = 0
    thresholds0 = None
    liab0 = None
    if is_latent:
        from jwas_tpu.ops.threshold import BIG

        rng0 = np.random.default_rng(opts.seed if opts.seed is not None else 0)
        if trait_type in ("categorical", "categorical(binary)"):
            cats = np.asarray(np.nan_to_num(ws.y[:n]), dtype=np.int64)
            category_obs = jnp.asarray(cats, jnp.int32)
            n_cat = int(cats.max())
            if trait_type == "categorical":
                # [-BIG, 0, .. range(0,1) .., BIG] (cat_cens.jl:57-58)
                inner = np.linspace(0, 1, n_cat)[:-1]
                th = np.concatenate([[-BIG], inner, [BIG]])
            else:
                th = np.array([-BIG, 0.0, BIG])
            thresholds0 = jnp.asarray(th, dtype)
            lb = np.where(cats > 0, th[np.maximum(cats - 1, 0)], -BIG)
            ub = np.where(cats > 0, th[np.minimum(cats, len(th) - 1)], BIG)
        else:
            id_cols = ws.df
            lb = pd.to_numeric(id_cols[f"{model.lhs_vec[0]}_l"], errors="coerce").to_numpy()
            ub = pd.to_numeric(id_cols[f"{model.lhs_vec[0]}_u"], errors="coerce").to_numpy()
            lb = np.clip(np.nan_to_num(lb, nan=-np.inf), -BIG, BIG)
            ub = np.clip(np.nan_to_num(ub, nan=np.inf), -BIG, BIG)
            cens_lower = jnp.asarray(lb, dtype)
            cens_upper = jnp.asarray(ub, dtype)
        # initial liability ~ TruncNormal(0, sqrt(vare)) in the bounds
        s0 = np.sqrt(float(ws.vare0))
        from scipy.stats import truncnorm

        a = np.clip(lb / s0, -30, 30)
        b = np.clip(ub / s0, -30, 30)
        liab_np = np.where(
            lb < ub,
            truncnorm.rvs(a, np.maximum(b, a + 1e-6), scale=s0,
                          random_state=rng0, size=n),
            lb,
        )
        liab0 = jnp.asarray(liab_np, dtype)

    # --- annotation design + probit state (annotation_setup.jl:70-160) ---
    anno_A = None
    ann_coeffs0 = ann_var0 = None
    anno_steps = 0
    if g is not None and g.annotations is not None and method in ("BayesC", "BayesR"):
        from scipy.stats import norm as _norm

        ann_np = np.asarray(g.annotations, dtype=np.float64)
        A_np = np.zeros((p_pad, 1 + ann_np.shape[1]))
        A_np[:p, 0] = 1.0
        A_np[:p, 1:] = ann_np
        anno_A = jnp.asarray(A_np, dtype)
        if method == "BayesC":
            anno_steps = 1
            pi_start = np.full(p, float(g.pi)) if np.ndim(g.pi) == 0 else (
                np.asarray(g.pi, dtype=np.float64)
            )
            incl = float(np.clip(np.mean(1.0 - pi_start), 1e-12, 1 - 1e-12))
            c0 = np.zeros(A_np.shape[1])
            c0[0] = _norm.ppf(incl)
            ann_coeffs0 = jnp.asarray(c0, dtype)
            ann_var0 = jnp.asarray(1.0, dtype)
        else:
            anno_steps = 3
            ann_coeffs0 = jnp.zeros((A_np.shape[1], 3), dtype)
            ann_var0 = jnp.ones((3,), dtype)

    cfg = STEngineCfg(
        method=method,
        n_obs=n,
        n_markers=p,
        n_loc=K,
        estimate_pi=estimate_pi,
        estimate_marker_variance=bool(g.G.estimate_variance) if g is not None else False,
        estimate_scale=bool(g.G.estimate_scale) if g is not None else False,
        estimate_residual_variance=bool(model.R.estimate_variance)
        and trait_type not in ("categorical", "categorical(binary)"),
        use_blocks=use_blocks,
        nreps=nreps,
        sync_every=_resolve_sync(opts, nreps),
        re_groups=tuple(re_cfgs),
        df_residual=float(ws.df_R),
        df_marker=float(ws.df_marker),
        has_weights=ws.rinv is not None,
        trait_types=tuple(model.traits_type),
        cat_counts=(n_cat,),
        anno_steps=anno_steps,
        is_packed=packed_pm is not None,
        use_pallas=_resolve_use_pallas(
            opts.use_pallas, use_blocks, method, opts.mesh,
        ),
        host_offload=host_offload,
        grouped=grouped,
        has_missing_codes=has_missing_codes if grouped else True,
        group_blocks=group_blocks_dense,
        sparse_loc=sparse_mode,
        cg_maxiter=int(getattr(opts, "cg_maxiter", 200)),
        # f32 residuals plateau around 1e-6..1e-7: a tighter tol would
        # never fire and every draw would burn the full cg_maxiter
        cg_tol=1e-8 if opts.double_precision else 1e-6,
        # out-of-core runs overlap each group's PCIe stage with the previous
        # group's compute (one extra resident tile; ~25% wall-clock at the
        # north-star shape)
        prefetch=bool(grouped and host_offload),
        scale_R=float(ws.scale_R),
    )
    data = STData(
        **data_fields,
        category_obs=category_obs, cens_lower=cens_lower, cens_upper=cens_upper,
        anno_A=anno_A,
        packed=(
            None if packed_pm is None
            else packed_pm.store if grouped else packed_pm.packed
        ),
        packed_means=packed_pm.means if packed_pm is not None else None,
        row_perm=packed_pm.row_perm if packed_pm is not None else None,
        scale_r=jnp.asarray(float(ws.scale_R), dtype),
        packed_dev=packed_pm.dev_store if grouped else None,
        sl=sl, out_w_rows=out_w_rows, out_w_cols=out_w_cols,
        out_w_vals=out_w_vals,
    )

    # --- initial state ---
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
    alpha = jnp.zeros((p_pad,), dtype)
    if g is not None and g.starting_alpha is not None and method != "GBLUP":
        alpha = alpha.at[:p].set(jnp.asarray(g.starting_alpha, dtype))
    beta = alpha
    delta = (
        jnp.zeros((p_pad,), jnp.int32)
        if method == "BayesR"
        else jnp.where(valid > 0, 1, 0).astype(jnp.int32)
    )
    if method == "BayesL":
        key, kg = jax.random.split(key)
        gamma_l = jnp.where(
            valid > 0, jax.random.gamma(kg, 1.0, (p_pad,)).astype(dtype) * 8.0, 1.0
        )
        marker_var0 = float(ws.marker_var0) / 8.0
        marker_scale0 = float(ws.marker_scale0) / 8.0
    else:
        gamma_l = jnp.ones((p_pad,), dtype)
        marker_var0 = None if ws.marker_var0 is None else ws.marker_var0
        marker_scale0 = None if ws.marker_scale0 is None else ws.marker_scale0

    y_base = liab0 if liab0 is not None else y
    if sparse_mode:
        from jwas_tpu.ops.sparse_mme import w_matvec as _w_matvec

        ycorr = y_base - _w_matvec(sl, sol, n)
    else:
        ycorr = y_base - W @ sol
    if packed_pm is not None and grouped:
        from jwas_tpu.ops.grouped import grouped_matvec

        ycorr = ycorr - grouped_matvec(packed_pm, alpha, n_obs=n,
                                       host_store=host_offload,
                                       has_missing=has_missing_codes)
    elif packed_pm is not None:
        from jwas_tpu.ops.packed import packed_matvec

        ycorr = ycorr - packed_matvec(packed_pm, alpha, n_obs=n)
    elif method == "GBLUP":
        ycorr = ycorr - X @ alpha
    elif p > 0:
        ycorr = ycorr - X @ alpha

    if method == "BayesB":
        varg = jnp.where(valid > 0, jnp.asarray(float(marker_var0), dtype), 1.0)
    elif method == "BayesR":
        varg = jnp.asarray(float(marker_var0), dtype)
    elif method != "none":
        varg = jnp.asarray(np.asarray(marker_var0, dtype=np.float64).item(), dtype)
    else:
        varg = jnp.zeros((), dtype)

    if method == "BayesR" and anno_steps == 3:
        pi4 = np.asarray(ws.pi0, dtype=np.float64)
        pi_np = np.tile(pi4[None, :], (p_pad, 1))
        pi_np[p:] = [1.0, 0.0, 0.0, 0.0]
        pi = jnp.asarray(pi_np, dtype)
    elif method == "BayesR":
        pi = jnp.asarray(np.asarray(ws.pi0, dtype=np.float64), dtype)
    elif method in ("BayesC", "BayesB"):
        pi_np = ws.pi0
        if np.ndim(pi_np) == 0:
            pi_full = np.full(p_pad, float(pi_np))
        else:
            pi_full = np.ones(p_pad)
            pi_full[:p] = np.asarray(pi_np, dtype=np.float64)
        pi_full[p:] = 1.0
        pi = jnp.asarray(pi_full, dtype)
    else:
        pi = jnp.zeros((0,), dtype)

    scale_g = jnp.asarray(
        0.0 if marker_scale0 is None else float(np.mean(marker_scale0)), dtype
    )

    state = ChainState(
        key=key, sol=sol, alpha=alpha, beta=beta, delta=delta, gamma_l=gamma_l,
        ycorr=ycorr, vare=jnp.asarray(float(ws.vare0), dtype), varg=varg, pi=pi,
        scale_g=scale_g, vc=tuple(vc0), liab=liab0, thresholds=thresholds0,
        ann_coeffs=ann_coeffs0, ann_var=ann_var0,
    )
    return cfg, data, state


def _apply_update_priors_mc(cfg, data: STData, states, accums):
    """Multichain empirical-Bayes prior refresh (the n_chains>1 form of
    _apply_update_priors). Per-chain state priors (the marker-variance scale)
    refresh from each chain's own running means — states/accums carry a
    leading chain axis, so the same elementwise update applies. The shared
    STData prior scales (residual scale, VC scales) are refreshed from the
    POOLED (across-chain mean) running means: chains stay exchangeable and
    the pooled estimate is the lower-variance one. Documented divergence from
    running K independent single-chain refreshes."""
    if cfg.method not in ("BayesB", "none"):
        states = states._replace(
            scale_g=accums.varg_m * (cfg.df_marker - 2.0) / cfg.df_marker
        )
    vc_scale = list(data.vc_scale)
    for g, grp in enumerate(cfg.re_groups):
        if grp.random_type == "A":
            k = len(grp.starts)
            vc_scale[g] = jnp.mean(accums.vc_m[g], axis=0) * (grp.df - k - 1.0)
    data = data._replace(
        vc_scale=tuple(vc_scale),
        scale_r=jnp.mean(accums.vare_m)
        * (cfg.df_residual - 2.0) / cfg.df_residual,
    )
    return data, states


def _run_multichain(ws, cfg, data, state, opts):
    """Parallel MCMC chains, vmapped over a leading chain axis.

    The reference has no built-in multi-chain support (users run chains by
    hand and feed PSRF, convergence_diagnosis.jl:31-57); here chains are
    first-class: one jitted vmapped step advances every chain, chains shard
    across a 'chains' mesh axis when opts.mesh provides one, and the results
    dict gains a PSRF table computed from the per-chain samples.
    """
    K = int(opts.n_chains)
    seed = opts.seed if opts.seed is not None else 0
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(seed, seed + K))

    def stack(x):
        return jnp.broadcast_to(x, (K,) + x.shape)

    states = jax.tree.map(stack, state)._replace(key=keys)
    accum0 = _init_accum(cfg, data, state)
    accums = jax.tree.map(stack, accum0)

    nreps = cfg.nreps
    n_outer = max(1, opts.chain_length // nreps)
    burnin_outer = opts.burnin // nreps
    osf = opts.output_samples_frequency
    if osf <= 0:
        osf = max(1, opts.chain_length // 1000)
    thin_outer = max(1, osf // nreps)
    n_saved = max(1, (n_outer - burnin_outer) // thin_outer)

    chain_samples = {"vare": [], "h2": [], "genvar": [], "varg": []}
    chain_pi = []
    samples = {"vare": [], "varg": [], "pi": [], "genvar": [], "h2": []}
    upf = int(opts.update_priors_frequency or 0)
    prior_epoch = 0
    w0 = 0

    # checkpoint/resume: the stacked multichain (states, accums) is one
    # pytree, so the single-chain machinery applies verbatim; resume loads
    # host-side BEFORE mesh sharding so shardings re-apply identically
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
            template = (states, accums, data.vc_scale, data.scale_r)
            (states, accums, vc_scale, scale_r), smp, meta = ckpt.load_checkpoint(
                path, template
            )
            data = data._replace(vc_scale=vc_scale, scale_r=scale_r)
            samples = {k: smp.get(k, []) for k in samples}
            chain_samples = {k: smp.get(f"c_{k}", []) for k in chain_samples}
            chain_pi = smp.get("c_pi", [])
            prior_epoch = int(meta["prior_epoch"])
            w0 = int(meta["w_next"])
            resumed = True

    mesh = opts.mesh
    if mesh is not None:
        axes = tuple(getattr(mesh, "axis_names", ()))
        chain_ax = next((a for a in ("chain", "chains") if a in axes), None)
        marker_ax = "marker" if "marker" in axes else None
        if chain_ax is not None:
            from jwas_tpu.parallel.mesh import shard_st_multichain

            data, states, accums = shard_st_multichain(
                mesh, cfg, data, states, accums, chain_ax, marker_ax
            )

    rw = make_run_window(cfg)
    mc = jax.vmap(rw, in_axes=(0, None, 0, None, None))

    # chain-0 streams the top-level sample-file set (parity with the MT
    # multichain driver, mcmc_mt.py); output_chain_samples=True additionally
    # writes every chain's files under chain_<k>/ for PSRF_per_parameter
    from jwas_tpu.engine.progress import ProgressPrinter
    from jwas_tpu.engine.samples_io import STSampleStream, multichain_streams

    stream = STSampleStream(ws, cfg, opts, append=resumed)
    chain_streams = multichain_streams(STSampleStream, ws, cfg, opts, K,
                                       append=resumed)
    progress = ProgressPrinter(opts.printout_frequency, opts.chain_length)

    if burnin_outer > 0 and not resumed:
        states, accums, _ = mc(states, data, accums, burnin_outer, False)

    need_states = stream.enabled or chain_streams
    for w in range(w0, n_saved):
        states, accums, out = mc(states, data, accums, thin_outer, True)
        iters_done = (burnin_outer + (w + 1) * thin_outer) * nreps
        if upf > 0 and iters_done // upf > prior_epoch:
            prior_epoch = iters_done // upf
            data, states = _apply_update_priors_mc(cfg, data, states, accums)
        # ONE batched device->host transfer per saved window (out for the
        # scalar tracks; states only when sample files are being written)
        if need_states:
            out_h, states_h = jax.device_get((out, states))
        else:
            out_h = jax.device_get(out)
            states_h = None
        for k_, field_ in (("vare", "vare"), ("h2", "h2"),
                           ("genvar", "genvar"), ("varg", "varg_mean")):
            chain_samples[k_].append(np.asarray(getattr(out_h, field_)))  # (K,)
        chain_pi.append(np.asarray(out_h.pi_summary))                     # (K, 4)
        # per-chain draws enter the sample list individually so posterior SDs
        # pool over the flattened (sample, chain) axes — appending the chain
        # MEAN would shrink SDs ~sqrt(K) vs single-chain semantics
        samples["vare"].extend(np.asarray(out_h.vare))
        samples["varg"].extend(np.asarray(out_h.varg_mean))
        samples["pi"].extend(np.asarray(out_h.pi_summary))
        samples["genvar"].extend(np.asarray(out_h.genvar))
        samples["h2"].extend(np.asarray(out_h.h2))
        if need_states:
            chain_view = lambda k: jax.tree.map(  # noqa: E731
                lambda x: x[k], (states_h, out_h)
            )
            s0, o0 = chain_view(0)
            stream.write_sample(s0, o0)
            for k, cs in enumerate(chain_streams):
                sk, ok = (s0, o0) if k == 0 else chain_view(k)
                cs.write_sample(sk, ok)
        progress.update(iters_done,
                        vare=out_h.vare[0], varg=out_h.varg_mean[0],
                        pi=out_h.pi_summary[0])
        if ck_every_w and (w + 1) % ck_every_w == 0:
            ck_samples = dict(samples)
            ck_samples.update({f"c_{k}": v for k, v in chain_samples.items()})
            ck_samples["c_pi"] = chain_pi
            ckpt.save_checkpoint(
                ck_folder, iters_done,
                (states, accums, data.vc_scale, data.scale_r),
                ck_samples,
                {"w_next": w + 1, "prior_epoch": prior_epoch},
                keep=opts.checkpoint_keep,
            )
    stream.close()
    for cs in chain_streams:
        cs.close()

    # equal-length chains: pooling the per-chain Welford moments is exact
    pooled = jax.tree.map(lambda x: x.mean(axis=0), accums)

    from jwas_tpu.analysis.diagnostics import PSRF as _psrf
    from jwas_tpu.engine.output import build_results

    results = build_results(ws, cfg, pooled, samples, opts)
    if stream.enabled and ws.geno is not None and stream.write_markers:
        results["_marker_sample_file"] = stream.writer.path(
            f"marker_effects_{ws.geno.name}_{ws.model.lhs_vec[0]}"
        )
    if chain_streams:
        results["_chain_sample_folders"] = [
            cs.writer.folder for cs in chain_streams
        ]
    if n_saved > 1:
        rows = []
        for name, vals in chain_samples.items():
            arr = np.stack(vals)                     # (n_saved, K)
            try:
                rows.append((name, float(_psrf(*[arr[:, c] for c in range(K)]))))
            except Exception:
                continue
        pi_arr = np.stack(chain_pi)                  # (n_saved, K, 4)
        for comp in range(pi_arr.shape[2]):
            col = pi_arr[:, :, comp]
            if np.allclose(col.std(axis=0), 0.0):
                continue                             # constant component
            try:
                rows.append((f"pi[{comp}]",
                             float(_psrf(*[col[:, c] for c in range(K)]))))
            except Exception:
                continue
        results["PSRF"] = pd.DataFrame(rows, columns=["parameter", "PSRF"])
    return results


def runMCMC(model: Model, df: pd.DataFrame, **kwargs):
    """Run MCMC for the model (the reference's `runMCMC`, JWAS.jl:161-511).

    Returns a dict of pandas DataFrames with posterior summaries, matching the
    reference's results dictionary keys where applicable.
    """
    opts = MCMCOptions(**kwargs)
    if opts.double_precision:
        jax.config.update("jax_enable_x64", True)
    dtype = jnp.float64 if opts.double_precision else jnp.float32

    # admission control before any driver dispatch (errors_args,
    # input_data_validation.jl:9-141); prepare_workspace re-validates after
    # the method shims for drivers that bypass this entry point
    from jwas_tpu.engine.validation import validate_args

    validate_args(model, opts)

    # multi-host bring-up: a no-op unless the environment indicates a
    # multi-process launch (JAX_COORDINATOR_ADDRESS), so
    # single-host runs never pay it (parallel/distributed.py)
    from jwas_tpu.parallel.distributed import initialize_multihost

    initialize_multihost()
    enable_compile_cache()

    # capture the run configuration on the model (MCMCinfo, JWAS.jl:266-271)
    # and print the model + MCMC summary unless silenced
    model.mcmc_info = opts
    if opts.printout_model_info:
        from jwas_tpu.models.model import describe

        describe(model)

    if opts.RRM is not None:
        from jwas_tpu.engine.mcmc_rrm import run_mcmc_rrm

        return run_mcmc_rrm(model, df, opts, dtype)

    if model.n_models != 1:
        from jwas_tpu.engine.mcmc_mt import run_mcmc_mt

        return run_mcmc_mt(model, df, opts, dtype)

    ws = prepare_workspace(model, df, opts)
    cfg, data, state = _build_st_data_and_state(ws, opts, dtype)

    if opts.n_chains > 1:
        return _run_multichain(ws, cfg, data, state, opts)

    nreps = cfg.nreps
    chain_length = opts.chain_length
    n_outer = max(1, chain_length // nreps)
    burnin_outer = opts.burnin // nreps
    osf = opts.output_samples_frequency
    if osf <= 0:
        osf = max(1, chain_length // 1000)
    thin_outer = max(1, osf // nreps)
    n_saved = max(1, (n_outer - burnin_outer) // thin_outer)

    run_window = make_run_window(cfg)
    accum = _init_accum(cfg, data, state)

    samples = {"vare": [], "varg": [], "pi": [], "genvar": [], "h2": []}
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
            template = (state, accum, data.vc_scale, data.scale_r)
            (state, accum, vc_scale, scale_r), smp, meta = ckpt.load_checkpoint(
                path, template
            )
            data = data._replace(vc_scale=vc_scale, scale_r=scale_r)
            samples = {k: smp.get(k, []) for k in samples}
            prior_epoch = int(meta["prior_epoch"])
            w0 = int(meta["w_next"])
            resumed = True

    # per-parameter MCMC sample files (output.jl:320-526)
    from jwas_tpu.engine.progress import ProgressPrinter, maybe_profile
    from jwas_tpu.engine.samples_io import STSampleStream

    stream = STSampleStream(ws, cfg, opts, append=resumed)
    progress = ProgressPrinter(opts.printout_frequency, opts.chain_length)

    with maybe_profile(opts):
        if burnin_outer > 0 and not resumed:
            state, accum, _ = run_window(state, data, accum, burnin_outer,
                                         accumulate=False)

        for w in range(w0, n_saved):
            state, accum, out = run_window(state, data, accum, thin_outer,
                                           accumulate=True)
            iters_done = (burnin_outer + (w + 1) * thin_outer) * nreps
            if upf > 0 and iters_done // upf > prior_epoch:
                prior_epoch = iters_done // upf
                data, state = _apply_update_priors(cfg, data, state, accum)
            samples["vare"].append(np.asarray(out.vare))
            samples["varg"].append(np.asarray(out.varg_mean))
            samples["pi"].append(np.asarray(out.pi_summary))
            samples["genvar"].append(np.asarray(out.genvar))
            samples["h2"].append(np.asarray(out.h2))
            stream.write_sample(state, out)
            progress.update(iters_done, vare=out.vare, varg=out.varg_mean,
                            pi=out.pi_summary)
            if ck_every_w and (w + 1) % ck_every_w == 0:
                ckpt.save_checkpoint(
                    ck_folder,
                    (burnin_outer + (w + 1) * thin_outer) * nreps,
                    (state, accum, data.vc_scale, data.scale_r),
                    samples,
                    {"w_next": w + 1, "prior_epoch": prior_epoch},
                    keep=opts.checkpoint_keep,
                )
    stream.close()

    from jwas_tpu.engine.output import build_results

    results = build_results(ws, cfg, accum, samples, opts)
    if stream.enabled and ws.geno is not None and stream.write_markers:
        results["_marker_sample_file"] = stream.writer.path(
            f"marker_effects_{ws.geno.name}_{model.lhs_vec[0]}"
        )
    return results
