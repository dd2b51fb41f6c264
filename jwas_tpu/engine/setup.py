"""Host-side assembly: (model, phenotypes, options) -> device-ready workspace.

Equivalent of the validation/setup stages of the reference driver (reference:
src/1.JWAS/src/JWAS.jl:161-511 and input_data_validation.jl): ID
reconciliation between phenotypes/genotypes/pedigree, default priors from the
phenotypic variance (h^2 = 0.5 split), marker-variance derivation from the
genetic variance (genetic2marker, tools4genotypes.jl:426-478), incidence
matrices, and output/prediction setup.

Everything here is numpy/pandas on the host; the MCMC engine stages the
resulting arrays onto the device once.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd
import scipy.sparse as sp

from jwas_tpu.io.genotypes import BAYESR_GAMMA, Genotypes
from jwas_tpu.models.design import (
    build_design,
    incidence_for_ids,
    stack_phenotypes,
)
from jwas_tpu.models.model import Model


@dataclass
class MCMCOptions:
    """Keyword options of `runMCMC` (reference JWAS.jl:161-202)."""

    chain_length: int = 100
    burnin: int = 0
    output_samples_frequency: int = 0   # 0 -> auto (chain_length/1000, min 1)
    seed: Optional[int] = None
    double_precision: bool = False
    fast_blocks: object = False         # False | True | int block size
    nreps: Optional[int] = None         # inner sweeps per outer iter (default block size)
    outputEBV: bool = True
    output_heritability: bool = True
    output_folder: str = "results"
    output_marker_samples: bool = False
    heterogeneous_residuals: bool = False
    missing_phenotypes: bool = True
    constraint: bool = False
    single_step_analysis: bool = False
    fitting_J_vector: bool = True       # SSBR centering covariate (SSBR.jl:24)
    pedigree: object = None
    causal_structure: object = None
    RRM: object = None                  # (ntimes, ncoeff) Phi for random regression
    update_priors_frequency: int = 0
    printout_model_info: bool = True
    printout_frequency: int = 0         # console progress every K iterations
                                        # (MCMC_BayesianAlphabet.jl:417-420);
                                        # 0 = silent
    profile: bool = False               # capture a jax.profiler trace of the
                                        # sampling loop under
                                        # <output_folder>/profile
    starting_value: object = None
    mesh: object = None                 # jax.sharding.Mesh for multi-device runs
    memory_guard: str = "warn"          # "error" | "warn" | "off" (C24)
    host_offload_genotypes: object = "auto"  # keep the 2-bit packed store in
                                        # pinned HOST memory and stream chunks
                                        # (out of core); "auto" offloads when
                                        # the store exceeds 60% of the device
                                        # memory budget and the backend can
                                        # stage pinned-host memory; True
                                        # where it cannot raises
    memory_guard_ratio: float = 0.9
    n_chains: int = 1                   # parallel chains (vmapped; P6 analogue)
    output_chain_samples: bool = False  # with n_chains>1: also write the full
                                        # per-parameter sample-file set for
                                        # EVERY chain under chain_<k>/
                                        # (feeds PSRF_per_parameter)
    use_pallas: object = "auto"         # compiled inner-round kernel for the
                                        # blocked sweeps (ops/pallas_sweep.py):
                                        # "auto" = where the backend has one
                                        # (GPU, one device); True where none
                                        # exists raises
    sync_every: Optional[int] = None    # inner reps between residual syncs in
                                        # the blocked sweeps (default min(8, nreps))
    independent_blocks: bool = False    # reference's fully-amortized approximate
                                        # block mode (sync only once per outer
                                        # iteration; BayesABC.jl:190-255)
    checkpoint_frequency: int = 0       # write a resumable checkpoint every K
                                        # iterations (0 = off); rounded to
                                        # thinning-window boundaries
    checkpoint_folder: Optional[str] = None  # default <output_folder>/checkpoint
    checkpoint_keep: int = 3            # checkpoints retained on disk
    resume: bool = False                # continue from the latest checkpoint
    prediction_equation: object = False # user-defined EBV terms, e.g. "ID" or
                                        # "y:ID + y:litter" (prediction_setup,
                                        # output.jl:29-59); False = pedigree
                                        # terms + genotypes (default)
    sparse_location: object = None      # matrix-free sparse location-MME
                                        # (ops/sparse_mme.py): None = auto
                                        # (single-trait and K > 20_000),
                                        # True/False to force. Replaces the
                                        # dense (K, K) LHS + single-site pass
                                        # with a joint PO-CG draw — required
                                        # for SSBR at >=1e5 pedigree animals
    cg_maxiter: int = 200               # CG iteration cap for sparse draws


def resolve_sync_every(opts: "MCMCOptions", nreps: int) -> int:
    """Final sync-round length for the blocked sweeps: the reference's
    independent_blocks mode amortizes over all nreps; default bounds
    cross-block staleness at 8 inner reps (ops/markers.py module docs)."""
    if opts.independent_blocks:
        return nreps
    if opts.sync_every is not None:
        return max(1, min(int(opts.sync_every), nreps))
    return min(8, nreps)


@dataclass
class REGroupData:
    starts: Tuple[int, ...]
    n_levels: int
    Vinv: Optional[np.ndarray]          # dense (q, q), scipy sparse (sparse
                                        # location mode), or None (identity)
    G0: np.ndarray                      # (k, k) starting covariance
    df: float
    scale: np.ndarray                   # (k, k)
    term_array: List[str]
    random_type: str
    estimate_variance: bool = True
    Vinv_factor: object = None          # sparse F with Vinv = F'F (pedigree
                                        # hAi / its column slice for SSBR's
                                        # A_nn) — enables the exact PO draw


@dataclass
class Workspace:
    model: Model
    df: pd.DataFrame                    # training rows
    n_obs: int
    n_traits: int
    W: np.ndarray                       # (t*n, K) dense location design
    y: np.ndarray                       # (t*n,)
    y_mask: np.ndarray                  # (t*n,) bool, False where missing
    rinv: Optional[np.ndarray]          # (n,) inverse residual weights or None
    geno: Optional[Genotypes]           # aligned to training rows
    output_genotypes: Optional[np.ndarray]
    re_groups: List[REGroupData]
    vare0: np.ndarray                   # scalar or (t, t)
    scale_R: np.ndarray
    df_R: float
    marker_var0: Optional[np.ndarray]
    marker_scale0: Optional[np.ndarray]
    df_marker: float
    pi0: object
    output_ids: List[str]
    prediction_terms: List[str]
    output_X: Dict[str, np.ndarray]     # term -> dense (n_out, n_levels)
    gblup_L: Optional[np.ndarray] = None
    gblup_D: Optional[np.ndarray] = None
    obs_ids: List[str] = field(default_factory=list)
    W_sparse: object = None             # scipy CSR location design (sparse
                                        # location mode; W is then (n, 0))


def _default_priors(model: Model, df: pd.DataFrame) -> np.ndarray:
    """Phenotypic variance split with h^2 = 0.5
    (set_default_priors_for_variance_components, input_data_validation.jl:296-373).

    Returns the per-trait phenotypic variance diag matrix and fills in missing
    priors on the model in place.
    """
    t = model.n_models
    myvar = np.zeros(t)
    for i, lhs in enumerate(model.lhs_vec):
        col = pd.to_numeric(df[lhs], errors="coerce").to_numpy(dtype=np.float64)
        col = col[np.isfinite(col)]
        myvar[i] = np.var(col, ddof=1) if len(col) > 1 else 1.0
    phenovar = np.diag(myvar)
    h2 = 0.5

    genetic_count = len(model.M)
    nongenetic_count = 1
    for re in model.random_effects:
        if re.random_type == "A":
            genetic_count += 1
        elif re.term_array[0].split(":")[1] not in ("ϵ", "eps"):
            nongenetic_count += 1
    varg = phenovar * h2 / max(genetic_count, 1)
    vare = phenovar * h2 / nongenetic_count

    for g in model.M:
        if g.G.val is None and g.genetic_variance.val is None:
            g.genetic_variance.val = varg[0, 0] if t == 1 else varg

    if model.R.val is None:
        is_cat = model.traits_type in (["categorical"], ["categorical(binary)"])
        if t == 1:
            model.R.val = 1.0 if is_cat else float(vare[0, 0])
            model.R.scale = model.R.val * (model.R.df - 2.0) / model.R.df
            if is_cat:
                model.R.estimate_variance = False
        else:
            vmat = vare.copy()
            bin_idx = [i for i, tt in enumerate(model.traits_type) if tt == "categorical(binary)"]
            for i in bin_idx:
                vmat[i, :] = 0.0
                vmat[:, i] = 0.0
                vmat[i, i] = 1.0
            model.R.val = vmat
            model.R.scale = vmat * (model.R.df - t - 1.0)

    for re in model.random_effects:
        if re.G.val is None:
            k = len(re.term_array)
            base = varg if re.random_type == "A" else vare
            diag = []
            for term in re.term_array:
                trait = term.split(":")[0]
                ti = model.lhs_vec.index(trait)
                diag.append(base[ti, ti])
            G = np.diag(diag) if k > 1 else np.array([[diag[0]]])
            re.G.val = G
            re.G.scale = G * (re.G.df - k - 1.0)
    return varg


def _genetic2marker(g: Genotypes, n_traits: int) -> None:
    """Derive the marker-effect variance from the genetic variance
    (tools4genotypes.jl:353-478)."""
    if g.G.val is not None:
        return
    if g.method == "GBLUP":
        g.G.val = np.asarray(g.genetic_variance.val, dtype=np.float64)
        return
    gv = np.asarray(g.genetic_variance.val, dtype=np.float64)
    if g.method == "BayesR":
        pi = np.asarray(g.pi, dtype=np.float64)
        denom = g.sum2pq * float(np.sum(BAYESR_GAMMA * pi))
        if denom <= 0:
            raise ValueError("BayesR implied variance denominator must be positive")
        g.G.val = gv / denom
    elif n_traits == 1:
        pi = float(g.pi) if np.ndim(g.pi) == 0 else None
        if pi is None:
            # per-marker pi: 2pq-weighted inclusion (tools4genotypes.jl:461-477)
            include = 1.0 - np.clip(np.asarray(g.pi, dtype=np.float64), 0.0, 1.0)
            twopq = 2.0 * g.allele_freq * (1.0 - g.allele_freq)
            denom = float(np.sum(twopq * include))
        else:
            denom = (1.0 - pi) * g.sum2pq
        g.G.val = gv / denom
    else:
        # multi-trait: denominator from the joint inclusion-pattern Pi dict.
        pi = g.pi
        t = n_traits
        denom = np.zeros((t, t))
        if isinstance(pi, dict):
            for i in range(t):
                for j in range(i, t):
                    tot = sum(v for kpat, v in pi.items() if kpat[i] == 1.0 and kpat[j] == 1.0)
                    denom[i, j] = denom[j, i] = g.sum2pq * tot
        else:
            denom[:] = g.sum2pq
        g.G.val = gv / denom


def set_marker_hyperparameters(model: Model) -> None:
    """set_marker_hyperparameters_variances_and_pi (tools4genotypes.jl:353-424)."""
    t = model.n_models
    for g in model.M:
        if t > 1 and (np.ndim(g.pi) == 0 and g.pi == 0.0) and g.method not in ("RR-BLUP", "BayesL"):
            # default multi-trait Pi: all markers affect all traits
            pi = {}
            for n in range(2**t):
                pat = tuple(float(b) for b in np.binary_repr(n, t))
                pi[pat] = 0.0
            pi[tuple([1.0] * t)] = 1.0
            g.pi = pi
        _genetic2marker(g, t)
        gval = np.asarray(g.G.val, dtype=np.float64)
        if t == 1:
            g.G.scale = gval * (g.G.df - 1.0 - 1.0) / g.G.df
        else:
            g.G.scale = gval * (g.G.df - t - 1.0)
        if t == 1 and g.method in ("BayesA", "BayesB", "BayesC") and np.ndim(g.pi) == 0:
            g.pi = float(g.pi)


def normalize_method(g: Genotypes, model: Model) -> None:
    """Method shims of errors_args (input_data_validation.jl:20-44)."""
    if g.method in ("RR-BLUP", "BayesL", "GBLUP", "BayesA"):
        g.estimate_pi = False
        if g.method != "BayesA":
            g.pi = 0.0
    if g.method == "BayesA":
        g.method = "BayesB"
        g.pi = 0.0
    if g.method == "BayesR" and model.n_models != 1:
        raise ValueError("BayesR supports single-trait analysis only")


def _add_censored_trait_columns(model: Model, df: pd.DataFrame) -> None:
    """Synthesize the censored trait column from its bounds
    (add_censored_trait_column!, categorical_and_censored_trait.jl:263-296)."""
    rng = np.random.default_rng(0)
    for ti, tt in enumerate(model.traits_type):
        if tt != "censored":
            continue
        name = model.lhs_vec[ti]
        for suffix in ("_l", "_u"):
            if f"{name}{suffix}" not in df.columns:
                raise ValueError(
                    f"censored trait {name} requires columns {name}_l and "
                    f"{name}_u in the phenotype data frame"
                )
        lo = pd.to_numeric(df[f"{name}_l"], errors="coerce").to_numpy(dtype=np.float64)
        hi = pd.to_numeric(df[f"{name}_u"], errors="coerce").to_numpy(dtype=np.float64)
        both_missing = np.isnan(lo) & np.isnan(hi)
        lo = np.where(np.isnan(lo), -np.inf, lo)
        hi = np.where(np.isnan(hi), np.inf, hi)
        y = np.where(
            np.isinf(lo) & np.isinf(hi), np.nan,
            np.where(np.isinf(lo), hi,
                     np.where(np.isinf(hi), lo,
                              lo + rng.uniform(size=len(lo)) * (hi - lo))),
        )
        y = np.where(both_missing, np.nan, y)
        df[name] = y
        df[f"{name}_l"] = lo
        df[f"{name}_u"] = hi


def _detect_binary_traits(model: Model, df: pd.DataFrame) -> None:
    """Flag 2-category traits as binary and validate category coding
    (check_pedigree_genotypes_phenotypes, input_data_validation.jl:258-274)."""
    for ti, tt in enumerate(model.traits_type):
        if tt != "categorical":
            continue
        name = model.lhs_vec[ti]
        vals = pd.to_numeric(df[name], errors="coerce").dropna().astype(int)
        cats = sorted(set(int(v) for v in vals if v != 0))
        if cats != list(range(1, len(cats) + 1)):
            raise ValueError(
                f"categorical trait {name} must use categories 1..K; got {cats}"
            )
        if len(cats) == 2:
            model.traits_type[ti] = "categorical(binary)"


def prepare_workspace(model: Model, df: pd.DataFrame, opts: MCMCOptions) -> Workspace:
    """Full setup pipeline; mirrors runMCMC steps 1-9 (JWAS.jl:272-459)."""
    t = model.n_models
    df = df.copy()
    id_col = df.columns[0]
    df[id_col] = [str(x).strip() for x in df[id_col]]
    _add_censored_trait_columns(model, df)
    _detect_binary_traits(model, df)

    if opts.pedigree is not None and model.ped is None:
        model.ped = opts.pedigree

    for g in model.M:
        normalize_method(g, model)

    # --- admission control: the full method x feature compat matrix
    # (errors_args, input_data_validation.jl:9-141) ---
    from jwas_tpu.engine.validation import validate_args

    validate_args(model, opts)
    if opts.heterogeneous_residuals and "weights" not in df.columns:
        raise ValueError(
            "heterogeneous_residuals=True requires a 'weights' column in the "
            "phenotype data frame"
        )
    # --- ID reconciliation (input_data_validation.jl:198-294) ---
    if model.M and not opts.single_step_analysis:
        geno_ids = set(model.M[0].obs_ids)
        keep = df[id_col].isin(geno_ids)
        if not keep.all():
            print(f"{int((~keep).sum())} phenotyped individuals are not genotyped; removed.")
            df = df[keep]
    if model.ped is not None:
        ped_ids = set(model.ped.ids)
        keep = df[id_col].isin(ped_ids)
        if not keep.all():
            print(f"{int((~keep).sum())} phenotyped individuals are not in the pedigree; removed.")
            df = df[keep]

    # --- default output IDs (check_outputID, input_data_validation.jl:143-196) ---
    output_ids = model.output_ids
    if opts.outputEBV or opts.output_heritability:
        if output_ids is None:
            if model.M and opts.single_step_analysis and opts.output_heritability:
                # single-step h2: EBVs for every pedigree member (:170-174)
                output_ids = list(model.ped.ids)
            elif model.M:
                output_ids = list(model.M[0].obs_ids)
            elif model.ped is not None:
                output_ids = list(model.ped.ids)
            elif getattr(opts, "prediction_equation", False):
                # user-defined prediction equation without markers/pedigree:
                # default to the phenotyped individuals
                output_ids = list(dict.fromkeys(str(x) for x in df[id_col]))
            else:
                output_ids = []
        if model.M and not opts.single_step_analysis:
            geno_ids = set(model.M[0].obs_ids)
            output_ids = [s for s in output_ids if s in geno_ids]
        elif model.ped is not None:
            ped_ids = set(model.ped.ids)
            output_ids = [s for s in output_ids if s in ped_ids]
    else:
        output_ids = []

    # --- whole-data frame: append output individuals without phenotypes ---
    df_ids = set(df[id_col])
    extra = [s for s in output_ids if s not in df_ids]
    if extra:
        df_extra = pd.DataFrame({id_col: extra})
        df_whole = pd.concat([df, df_extra], ignore_index=True)
    else:
        df_whole = df.reset_index(drop=True)

    # training rows: at least one non-missing trait
    miss = np.ones((len(df_whole), t), dtype=bool)
    for i, lhs in enumerate(model.lhs_vec):
        col = pd.to_numeric(df_whole[lhs], errors="coerce").to_numpy(dtype=np.float64)
        miss[:, i] = ~np.isfinite(col)
    train_rows = np.where(~miss.all(axis=1))[0]

    # --- priors from data (before splitting off the training view) ---
    varg_default = _default_priors(model, df_whole.iloc[train_rows])
    del varg_default

    # --- single-step: impute genotypes, add J + imputation-residual terms ---
    if opts.single_step_analysis:
        from jwas_tpu.engine.single_step import ssbr_setup

        ssbr_setup(model, df_whole, opts)

    set_marker_hyperparameters(model)

    # --- design matrices over the whole frame; then restrict to train rows ---
    X_whole = build_design(model, df_whole)
    n_whole = len(df_whole)
    row_sel = np.concatenate([m * n_whole + train_rows for m in range(t)])
    K_loc = X_whole.shape[1]
    use_sparse_loc = bool(
        opts.sparse_location is True
        or (opts.sparse_location is None and t == 1 and K_loc > 20_000
            and opts.RRM is None and opts.causal_structure is None)
    )
    if opts.sparse_location is True and (
        t != 1 or opts.RRM is not None or opts.causal_structure is not None
    ):
        raise ValueError(
            "sparse_location=True supports single-trait (non-RRM, non-SEM) "
            "models only; multi-trait/RRM/SEM MMEs use the dense location "
            "path"
        )
    if use_sparse_loc:
        # matrix-free location path (ops/sparse_mme.py): never densify the
        # (n, K) design — at K ~ 5e5 (single-step with a large pedigree) the
        # dense W and (K, K) LHS are the scaling wall the reference avoids
        # with its SparseArrays MME (build_MME.jl:300-382)
        W_sparse = X_whole[row_sel, :].tocsr()
        W = np.zeros((len(row_sel), 0))
    else:
        W_sparse = None
        W = np.asarray(X_whole[row_sel, :].todense())

    df_train = df_whole.iloc[train_rows].reset_index(drop=True)
    obs_ids = [str(x) for x in df_train[id_col]]
    n_obs = len(df_train)
    y, y_mask = stack_phenotypes(model, df_train)

    # --- prediction equation & output incidence (prediction_setup/output.jl:29-59) ---
    prediction_terms = list(model.ped_term_vec)
    pe = getattr(opts, "prediction_equation", False)
    if pe:
        prediction_terms = []
        for tok in str(pe).split("+"):
            tok = tok.strip()
            if not tok:
                continue
            cands = [tok] if ":" in tok else [
                f"{lhs}:{tok}" for lhs in model.lhs_vec
            ]
            found = [c for c in cands if c in model.term_dict]
            if not found:
                raise ValueError(
                    f"term {tok!r} in the prediction equation is not found"
                )
            for c in found:
                if c not in prediction_terms:
                    prediction_terms.append(c)
    output_X: Dict[str, np.ndarray] = {}
    id_rows = {}
    for i, s in enumerate([str(x) for x in df_whole[id_col]]):
        id_rows.setdefault(s, i)
    for term_name in prediction_terms:
        term = model.term_dict[term_name]
        rows = [term.i_model * n_whole + id_rows[s] for s in output_ids]
        # sparse location mode keeps per-term prediction incidences sparse
        # (a dense (n_out, q) slab defeats the point at q ~ 1e5 levels)
        Xt = term.X[rows, :]
        output_X[term_name] = Xt.tocsr() if use_sparse_loc else np.asarray(
            Xt.todense()
        )
    # restrict each term's X to training rows for the MME
    for term in model.terms:
        term.X = term.X[row_sel, :]

    # --- residual weights ---
    rinv = None
    if opts.heterogeneous_residuals:
        w = pd.to_numeric(df_train["weights"], errors="raise").to_numpy(dtype=np.float64)
        rinv = 1.0 / w

    # --- genotypes aligned to training rows & output IDs ---
    geno = None
    out_geno = None
    gblup_L = gblup_D = None
    if model.M:
        g0 = model.M[0]
        if g0.method == "GBLUP":
            grm = np.asarray(g0.genotypes, dtype=np.float64)
            evals, evecs = np.linalg.eigh(grm)
            D = np.abs(evals)
            L = evecs
            Zt = incidence_for_ids(obs_ids, g0.obs_ids).toarray()
            Zo = incidence_for_ids(output_ids, g0.obs_ids).toarray() if output_ids else None
            gblup_L = Zt @ L
            gblup_D = D
            # output map: (Z_o G) L diag(1/D)  (GBLUP.jl:9-31)
            out_geno = (Zo @ grm @ L) / D[None, :] if Zo is not None else None
            geno = g0
        elif g0.packed_store is not None:
            # packed backend: the device engine decodes tiles on the fly; the
            # phenotype-row permutation is applied there, not here
            if t != 1:
                raise ValueError("storage='2bit' supports single-trait models only")
            if opts.single_step_analysis:
                raise ValueError("storage='2bit' does not support single-step analysis")
            missing_geno = [s for s in obs_ids if s not in set(g0.obs_ids)]
            if missing_geno:
                raise ValueError(
                    f"individual {missing_geno[0]} has no genotypes"
                )
            geno = g0
            if output_ids:
                store = g0.packed_store
                row_of = {s: i for i, s in enumerate(store.obs_ids)}
                rows = np.array([row_of[s] for s in output_ids], dtype=np.int64)
                out_geno = np.empty((len(output_ids), g0.n_markers), np.float32)
                chunk = 4096
                for c0 in range(0, g0.n_markers, chunk):
                    cols = np.arange(c0, min(c0 + chunk, g0.n_markers))
                    out_geno[:, cols] = store.decode(cols)[rows]
        else:
            geno = g0.aligned_to(obs_ids)
            geno.G = g0.G
            geno.genetic_variance = g0.genetic_variance
            geno.pi = g0.pi
            geno.method = g0.method
            geno.estimate_pi = g0.estimate_pi
            if output_ids:
                Zo = incidence_for_ids(output_ids, g0.obs_ids)
                out_geno = np.asarray(Zo @ g0.genotypes)

    # --- random-effect group data ---
    re_groups: List[REGroupData] = []
    for re in model.random_effects:
        terms = [model.term_dict[s] for s in re.term_array]
        q = terms[0].n_levels
        for trm in terms:
            if trm.n_levels != q:
                raise ValueError("terms in one random-effect group must share levels")
        Vinv = None
        if re.Vinv is not None:
            # sparse location mode keeps Vinv sparse (SSBR's A_nn epsilon
            # term is O(q) nnz at q ~ 1e5+; densifying is the old cap)
            Vinv = re.Vinv.tocsr() if use_sparse_loc else np.asarray(
                re.Vinv.todense()
            )
        G0 = np.asarray(re.G.val, dtype=np.float64)
        re_groups.append(
            REGroupData(
                starts=tuple(trm.start_pos for trm in terms),
                n_levels=q,
                Vinv=Vinv,
                G0=G0,
                df=float(re.G.df),
                scale=np.asarray(re.G.scale, dtype=np.float64),
                term_array=list(re.term_array),
                random_type=re.random_type,
                estimate_variance=re.G.estimate_variance,
                Vinv_factor=getattr(re, "Vinv_factor", None),
            )
        )

    if t == 1:
        vare0 = np.asarray(float(model.R.val))
        scale_R = np.asarray(float(model.R.scale))
    else:
        vare0 = np.asarray(model.R.val, dtype=np.float64)
        scale_R = np.asarray(model.R.scale, dtype=np.float64)

    marker_var0 = marker_scale0 = None
    df_marker = 4.0
    pi0 = None
    if geno is not None:
        marker_var0 = np.asarray(geno.G.val, dtype=np.float64)
        marker_scale0 = np.asarray(geno.G.scale, dtype=np.float64)
        df_marker = float(geno.G.df)
        pi0 = geno.pi

    # --- memory guard (C24; JWAS.jl:414-459, tools4genotypes.jl:99-235) ---
    if geno is not None and not geno.is_grm:
        from jwas_tpu.ops.markers import default_block_size
        from jwas_tpu.utils.memory import (
            check_marker_memory_guard,
            estimate_marker_memory,
        )

        if opts.fast_blocks is True:
            bs = default_block_size(n_obs)
        elif opts.fast_blocks:
            bs = int(opts.fast_blocks)
        else:
            bs = 0
        est = estimate_marker_memory(
            n_obs=n_obs,
            n_markers=geno.n_markers,
            n_traits=t,
            block_size=bs,
            n_out=len(output_ids),
            n_loc=K_loc,
            packed=geno.packed_store is not None,
        )
        check_marker_memory_guard(
            est, policy=opts.memory_guard, ratio=opts.memory_guard_ratio
        )

    return Workspace(
        model=model,
        df=df_train,
        n_obs=n_obs,
        n_traits=t,
        W=W,
        W_sparse=W_sparse,
        y=y,
        y_mask=y_mask,
        rinv=rinv,
        geno=geno,
        output_genotypes=out_geno,
        re_groups=re_groups,
        vare0=vare0,
        scale_R=scale_R,
        df_R=float(model.R.df),
        marker_var0=marker_var0,
        marker_scale0=marker_scale0,
        df_marker=df_marker,
        pi0=pi0,
        output_ids=list(output_ids),
        prediction_terms=prediction_terms,
        output_X=output_X,
        gblup_L=gblup_L,
        gblup_D=gblup_D,
        obs_ids=obs_ids,
    )
