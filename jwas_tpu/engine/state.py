"""Chain state and static configuration pytrees for the MCMC engine.

The reference keeps a mutable `MME` struct whose arrays are updated in place
(types.jl:264-346, with the `wArray`/`ycorr` aliasing noted in SURVEY.md §5).
Here the entire chain state is an explicit immutable pytree: one jitted
`step(state) -> state` advances the chain, `lax.scan` runs thinning windows,
and checkpointing the chain is just saving the pytree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import jax.numpy as jnp


class ChainState(NamedTuple):
    """Full single-trait chain state. Dummies (shape-(0,)) where unused."""

    key: jnp.ndarray
    sol: jnp.ndarray          # (K,) location parameters
    alpha: jnp.ndarray        # (p_pad,) marker effects (pseudo-effects for GBLUP)
    beta: jnp.ndarray         # (p_pad,) underlying effects (BayesB/C spike-slab)
    delta: jnp.ndarray        # (p_pad,) int32 inclusion indicator / BayesR class
    gamma_l: jnp.ndarray      # (p_pad,) BayesL local shrinkage (ones otherwise)
    ycorr: jnp.ndarray        # (n,) phenotype corrected for all effects
    vare: jnp.ndarray         # scalar residual variance
    varg: jnp.ndarray         # marker-effect variance: scalar, or (p_pad,) BayesB,
                              # or BayesR shared sigma^2
    pi: jnp.ndarray           # (p_pad,) P(excluded) for ABC; (4,) for BayesR; (0,)
    scale_g: jnp.ndarray      # scalar prior scale of marker variance
    vc: Tuple[jnp.ndarray, ...]  # per random-effect group: (k, k) covariance G0
    liab: Optional[jnp.ndarray] = None        # (n,) latent liability
    thresholds: Optional[jnp.ndarray] = None  # (n_cat+1,) category thresholds
    ann_coeffs: Optional[jnp.ndarray] = None  # (k,) or (k, 3) probit coefficients
    ann_var: Optional[jnp.ndarray] = None     # scalar or (3,) slope variance


class MTChainState(NamedTuple):
    """Multi-trait chain state (t traits)."""

    key: jnp.ndarray
    sol: jnp.ndarray          # (K,) stacked location parameters (all traits)
    alpha: jnp.ndarray        # (t, p_pad) marker effects
    beta: jnp.ndarray         # (t, p_pad)
    delta: jnp.ndarray        # (t, p_pad) int32
    gamma_l: jnp.ndarray      # (p_pad,) BayesL shared local shrinkage
    ycorr: jnp.ndarray        # (t, n) residuals per trait
    R: jnp.ndarray            # (t, t) residual covariance
    varg: jnp.ndarray         # (t, t) marker-effect covariance (or (p_pad,t,t) BayesB)
    pi: jnp.ndarray           # (2**t,) joint inclusion-pattern probabilities
    vc: Tuple[jnp.ndarray, ...]
    liab: jnp.ndarray         # (t, n) latent liabilities (categorical/censored); (0,)
    thresholds: jnp.ndarray   # (t, max_cat+1) thresholds; (0,)
    Lambda: jnp.ndarray       # (t, t) SEM structural coefficients; (0,)
    ann_coeffs: Optional[jnp.ndarray] = None  # (k, 3) tree-probit coefficients
    ann_var: Optional[jnp.ndarray] = None     # (3,) probit slope variances


@dataclass(frozen=True)
class REGroupCfg:
    """Static description of one random-effect group for LHS assembly."""

    starts: Tuple[int, ...]    # start column of each term in the MME
    n_levels: int              # q, identical for all terms in the group
    df: float
    has_vinv: bool             # False => identity structure
    random_type: str           # "A" | "V" | "I"
    factor_rows: int = 0       # rows m of the sparse factor F (Vinv = F'F)
                               # — static shape for the PO sampler's z draws
                               # (ops/sparse_mme.py); 0 when dense/identity


@dataclass(frozen=True)
class EngineCfg:
    """Static (compile-time) configuration of the jitted step."""

    method: str                # "BayesC","BayesB","RR-BLUP","BayesL","BayesR","GBLUP"
    n_obs: int                 # real observations (for variance df)
    n_markers: int             # real markers (pre-padding)
    n_loc: int                 # K location parameters
    estimate_pi: bool
    estimate_marker_variance: bool
    estimate_scale: bool
    estimate_residual_variance: bool
    use_blocks: bool
    nreps: int                 # inner repetitions per outer iteration (block mode)
    re_groups: Tuple[REGroupCfg, ...]
    df_residual: float
    df_marker: float
    has_weights: bool
    sync_every: int = 8        # inner reps between exact residual syncs in the
                               # blocked sweeps (= nreps reproduces the
                               # reference's independent_blocks approximate mode)
    n_traits: int = 1
    constraint: bool = False   # diagonal covariance constraint (multi-trait)
    missing_phenotypes: bool = False
    mt_sampler: str = "I"      # multi-trait BayesC Gibbs sampler variant
    trait_types: Tuple[str, ...] = ()   # "continuous"|"categorical"|"categorical(binary)"|"censored"
    has_sem: bool = False
    cat_counts: Tuple[int, ...] = ()    # categories per trait (0 = not categorical)
    anno_steps: int = 0   # probit submodels: 1 (AnnoBayesC), 3 (AnnoBayesR)
    is_packed: bool = False   # genotypes are a 2-bit packed device store
    use_pallas: bool = False  # run blocked inner rounds in the Pallas kernel
    host_offload: bool = False  # packed store lives in pinned host memory;
                                # sync GEMVs stream chunks (out-of-core)
    grouped: bool = False      # packed store uses the grouped (ngroups, G,
                               # bpm) layout with the group-sequential
                               # streaming sweep (ops/grouped.py)
    has_missing_codes: bool = True  # 2-bit store contains code 3 (missing);
                                    # False skips the mask matmuls in the
                                    # plane-decomposed GEMVs
    prefetch: bool = False    # grouped sweeps: software-pipeline the host-
                              # to-device stage of group g+1 under group g's
                              # compute
                              # (costs one extra resident group tile)
    group_blocks: int = 0     # dense blocked sweeps: blocks per group for the
                              # group-sequential schedule (0 = flat). Set when
                              # the flat stale set b*nblocks would exceed
                              # STALE_FRACTION*n (ops/markers.py:
                              # grouped_dense_sweep / stable_group_blocks)
    sparse_loc: bool = False  # matrix-free sparse location-MME: joint
                              # perturbation-optimization CG draw instead of
                              # the dense single-site pass (ops/sparse_mme.py;
                              # the reference's sparse-LHS Gibbs analogue,
                              # solver.jl:105-162)
    cg_maxiter: int = 200     # CG iteration cap for the sparse location draw
    cg_tol: float = 1e-8      # CG convergence tolerance
