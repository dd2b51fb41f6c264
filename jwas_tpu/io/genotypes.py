"""Genotype loading, quality control, and storage.

From-scratch equivalent of the reference genotype input layer (reference:
src/1.JWAS/src/markers/readgenotypes.jl):

- `get_genotypes` reads a CSV file / DataFrame / matrix into a
  :class:`Genotypes` object, applies naive QC (missing -> column-mean
  imputation, MAF + fixed-locus filtering), centers columns, and records
  allele frequencies and sum(2 p q).
- For GBLUP a genomic relationship matrix is built (or accepted directly).

Device-minded additions:
- `storage="int8"` keeps the raw (uncentered) genotype scores as int8 and the
  column means separately, so the marker matrix can live in device memory at
  1/4 the footprint and feed integer matmuls; centered products are recovered exactly
  via rank-1 mean corrections. This is the dense precursor of the reference's
  2-bit packed streaming store (streaming_genotypes.jl).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Union

import numpy as np
import pandas as pd

_DEFAULT_BAYESR_PI = np.array([0.95, 0.03, 0.015, 0.005])
BAYESR_GAMMA = np.array([0.0, 0.01, 0.1, 1.0])

_SUPPORTED_METHODS = (
    "RR-BLUP",
    "BayesA",
    "BayesB",
    "BayesC",
    "BayesL",
    "BayesR",
    "GBLUP",
)


@dataclass
class VarianceSpec:
    """Prior/posterior bookkeeping for a variance component.

    Mirrors the `Variance` struct (types.jl:56-64): value, degrees of freedom,
    scale, and estimation flags.
    """

    val: Optional[Union[float, np.ndarray]]
    df: float = 4.0
    scale: Optional[Union[float, np.ndarray]] = None
    estimate_variance: bool = True
    estimate_scale: bool = False
    constraint: bool = False


@dataclass
class Genotypes:
    """Genotype covariates for one marker set (reference types.jl:98-165)."""

    obs_ids: List[str]
    marker_ids: List[str]
    n_obs: int
    n_markers: int
    allele_freq: np.ndarray          # (p,) after QC
    sum2pq: float
    centered: bool
    genotypes: np.ndarray            # (n, p) centered float, or GRM if is_grm
    is_grm: bool = False

    method: str = "BayesC"
    pi: Union[float, np.ndarray] = 0.0
    estimate_pi: bool = True
    G: VarianceSpec = field(default_factory=lambda: VarianceSpec(val=None))
    genetic_variance: VarianceSpec = field(
        default_factory=lambda: VarianceSpec(val=None)
    )
    name: str = "geno"
    n_traits: int = 1
    trait_names: List[str] = field(default_factory=list)
    starting_alpha: Optional[np.ndarray] = None
    multi_trait_sampler: str = "I"   # "I" | "II" (MTBayesABC.jl:20-25)

    # int8 storage: genotypes holds centered floats unless raw_int8 is set, in
    # which case raw_int8 (n, p) + col_means reproduce X = raw - col_means.
    raw_int8: Optional[np.ndarray] = None
    col_means: Optional[np.ndarray] = None
    annotations: Optional[np.ndarray] = None  # (p, k) annotation design, no intercept

    # filled during model building / alignment
    output_genotypes: Optional[np.ndarray] = None
    # 2-bit packed backend (C12 analogue); genotypes stays None when set
    packed_store: Optional[object] = None

    def aligned_to(self, obs_ids: Sequence[str]) -> "Genotypes":
        """Return a view of this marker set reordered to `obs_ids` rows.

        Equivalent of `align_genotypes` (tools4genotypes.jl:288-323).
        """
        index = {s: i for i, s in enumerate(self.obs_ids)}
        try:
            rows = np.array([index[s] for s in obs_ids], dtype=np.int64)
        except KeyError as e:
            raise ValueError(f"individual {e} has no genotypes") from None
        out = Genotypes(
            obs_ids=list(obs_ids),
            marker_ids=self.marker_ids,
            n_obs=len(obs_ids),
            n_markers=self.n_markers,
            allele_freq=self.allele_freq,
            sum2pq=self.sum2pq,
            centered=self.centered,
            genotypes=self.genotypes[rows][:, rows]
            if self.is_grm
            else self.genotypes[rows],
            is_grm=self.is_grm,
            method=self.method,
            pi=self.pi,
            estimate_pi=self.estimate_pi,
            G=self.G,
            genetic_variance=self.genetic_variance,
            name=self.name,
            n_traits=self.n_traits,
            trait_names=self.trait_names,
            starting_alpha=self.starting_alpha,
            raw_int8=None if self.raw_int8 is None else self.raw_int8[rows],
            col_means=self.col_means,
            annotations=self.annotations,
            multi_trait_sampler=self.multi_trait_sampler,
        )
        return out


def _validate_annotations(annotations, marker_ids, n_markers, method):
    """Annotation schema validation (validate_annotations_input +
    validate_annotation_design, readgenotypes.jl:56-158).

    Accepts a numeric (p, k) array, or a file path / DataFrame whose first
    column is the marker id (rows are aligned to the genotype marker order;
    every genotype marker must be annotated). Rejects constant columns and
    collinear designs (an intercept is added automatically downstream).
    """
    if isinstance(annotations, str):
        annotations = pd.read_csv(annotations)
    if isinstance(annotations, pd.DataFrame):
        first = annotations.columns[0]
        if annotations[first].dtype == object or str(first).lower() in (
            "marker_id", "markerid", "id", "snp",
        ):
            idx = annotations.set_index(annotations[first].astype(str))
            missing = [m for m in marker_ids if m not in idx.index]
            if missing:
                raise ValueError(
                    f"annotations are missing marker(s) {missing[:5]}"
                    + ("..." if len(missing) > 5 else "")
                )
            annotations = idx.loc[list(marker_ids)].iloc[:, 1:]
        ann = annotations.to_numpy()
    else:
        ann = np.asarray(annotations)
    if method not in ("BayesC", "BayesR"):
        raise ValueError(
            'annotations are only supported with method="BayesC" or '
            'method="BayesR"'
        )
    ann = np.asarray(ann, dtype=np.float64)
    if ann.ndim != 2 or not np.isfinite(ann).all():
        raise ValueError("annotations must be a finite numeric matrix with "
                         "one row per marker")
    if ann.shape[0] != n_markers:
        raise ValueError(
            f"annotations rows ({ann.shape[0]}) must match the number of "
            f"raw markers ({n_markers})"
        )
    const_cols = [j for j in range(ann.shape[1])
                  if np.unique(ann[:, j]).size == 1]
    if const_cols:
        raise ValueError(
            f"annotations contain constant column(s) {const_cols}; remove "
            "them (an intercept is added automatically)"
        )
    design = np.hstack([np.ones((ann.shape[0], 1)), ann])
    if np.linalg.matrix_rank(design) != design.shape[1]:
        raise ValueError(
            "annotations are collinear after adding the intercept; remove "
            "duplicate or perfectly collinear annotation columns"
        )
    return ann


def _read_genotype_input(file, separator, header, dtype):
    """Parse file/DataFrame/array into (obs_ids, marker_ids, matrix)."""
    if isinstance(file, str):
        df = pd.read_csv(file, sep=separator, header=0 if header else None)
        obs_ids = [str(x).strip() for x in df.iloc[:, 0]]
        if header:
            marker_ids = [str(c) for c in df.columns[1:]]
        else:
            marker_ids = [str(i + 1) for i in range(df.shape[1] - 1)]
        mat = df.iloc[:, 1:].to_numpy(dtype=dtype)
    elif isinstance(file, pd.DataFrame):
        obs_ids = [str(x).strip() for x in file.iloc[:, 0]]
        if header:
            marker_ids = [str(c) for c in file.columns[1:]]
        else:
            marker_ids = [str(i + 1) for i in range(file.shape[1] - 1)]
        mat = file.iloc[:, 1:].to_numpy(dtype=dtype)
    elif isinstance(file, np.ndarray):
        mat = file.astype(dtype)
        obs_ids = [str(i + 1) for i in range(mat.shape[0])]
        marker_ids = [str(i + 1) for i in range(mat.shape[1])]
    else:
        raise TypeError(f"unsupported genotype input type {type(file)}")
    return obs_ids, marker_ids, mat


def get_genotypes(
    file,
    G=None,
    *,
    method: str = "BayesC",
    Pi=0.0,
    estimatePi: bool = True,
    G_is_marker_variance: bool = False,
    df: float = 4.0,
    estimate_variance: bool = True,
    estimate_scale: bool = False,
    constraint: bool = False,
    separator: str = ",",
    header: bool = True,
    double_precision: bool = False,
    quality_control: bool = True,
    MAF: float = 0.01,
    missing_value: float = 9.0,
    center: bool = True,
    starting_value=None,
    annotations=None,
    storage: str = "f32",
    name: str = "geno",
    multi_trait_sampler: str = "I",
) -> Genotypes:
    """Load genotypes and apply QC (reference readgenotypes.jl:213-448).

    storage: "f32" (dense centered float32), "f64", or "int8" (raw int8 scores
    + column means; imputed missing values are rounded to the nearest integer
    score so the raw matrix stays exactly representable).
    """
    if method not in _SUPPORTED_METHODS:
        raise ValueError(f"method {method!r} is not available; use one of {_SUPPORTED_METHODS}")
    if storage not in ("f32", "f64", "int8", "2bit"):
        raise ValueError("storage must be 'f32', 'f64', 'int8', or '2bit'")
    dtype = np.float64 if (double_precision or storage == "f64") else np.float32

    from jwas_tpu.io.packed import Packed2BitStore

    if isinstance(file, Packed2BitStore) or storage == "2bit":
        # packed backend: single-trait BayesC/B/R. The reference's streaming
        # constraints are BayesC-only (input_data_validation.jl:81-111); the
        # grouped sweeps here also run BayesB (per-marker variances) and the
        # 4-class BayesR mixture out-of-core (ops/grouped.py).
        if method not in ("BayesC", "BayesB", "BayesR"):
            raise ValueError("storage='2bit' supports BayesC/BayesB/BayesR only")
        if annotations is not None:
            raise ValueError("annotations are not supported with storage='2bit'")
        if method == "BayesR":
            Pi = (_DEFAULT_BAYESR_PI.copy()
                  if np.ndim(Pi) == 0 and Pi == 0.0
                  else np.asarray(Pi, dtype=np.float64))
            if Pi.shape != (4,):
                raise ValueError("BayesR Pi must be a length-4 vector")
            if not np.isclose(Pi.sum(), 1.0, atol=1e-8) or (Pi < 0).any():
                raise ValueError("BayesR Pi must be nonnegative and sum to 1")
        if isinstance(file, Packed2BitStore):
            store = file
        else:
            from jwas_tpu.io.packed import prepare_packed_genotypes

            store = prepare_packed_genotypes(
                file, separator=separator, header=header,
                missing_value=missing_value,
                MAF=MAF if quality_control else 0.0,
            )
        g = Genotypes(
            obs_ids=list(store.obs_ids),
            marker_ids=list(store.marker_ids),
            n_obs=store.n_obs,
            n_markers=store.n_markers,
            allele_freq=np.asarray(store.allele_freq, dtype=np.float64),
            sum2pq=store.sum2pq,
            centered=True,
            genotypes=None,
            method=method,
            pi=Pi,
            estimate_pi=estimatePi,
            G=VarianceSpec(
                val=G if G_is_marker_variance else None, df=df,
                estimate_variance=estimate_variance,
                estimate_scale=estimate_scale, constraint=constraint,
            ),
            genetic_variance=VarianceSpec(
                val=None if G_is_marker_variance else G, df=df,
                estimate_variance=estimate_variance,
                estimate_scale=estimate_scale, constraint=constraint,
            ),
            name=name,
            packed_store=store,
        )
        return g

    obs_ids, marker_ids, mat = _read_genotype_input(file, separator, header, dtype)
    n_obs, n_markers = mat.shape

    if annotations is not None:
        annotations = _validate_annotations(
            annotations, marker_ids, n_markers, method
        )
        if not estimatePi:
            import warnings

            warnings.warn(
                f"estimatePi=False is ignored when annotations are provided; "
                f"Annotated {method} requires estimatePi=True."
            )
            estimatePi = True

    is_grm = False
    if method == "GBLUP":
        if mat.shape[0] == mat.shape[1] and np.allclose(mat, mat.T, atol=1e-6):
            center = False
            quality_control = False
            is_grm = True
        if G_is_marker_variance:
            raise ValueError("GBLUP requires the genetic variance, not a marker variance")

    if quality_control:
        # Missing -> column mean imputation (readgenotypes.jl:371-381).
        miss = mat == dtype(missing_value)
        if miss.any():
            col_sums = np.where(miss, 0.0, mat).sum(axis=0)
            col_counts = (~miss).sum(axis=0)
            col_means = np.divide(
                col_sums,
                np.maximum(col_counts, 1),
                dtype=np.float64,
            )
            if storage == "int8":
                col_means = np.round(col_means)
            mat = np.where(miss, col_means[None, :].astype(dtype), mat)
        if ((mat < 0) | (mat > 2)).any():
            import warnings

            warnings.warn("genotype scores out of the range 0 to 2 are found.")

    col_means = mat.mean(axis=0, dtype=np.float64)
    p = col_means / 2.0  # allele frequency

    if quality_control:
        # MAF filter + fixed loci (readgenotypes.jl:387-399).
        sel = (p > MAF) & (p < 1 - MAF) & (mat.var(axis=0) != 0)
        mat = mat[:, sel]
        p = p[sel]
        col_means = col_means[sel]
        marker_ids = [m for m, keep in zip(marker_ids, sel) if keep]
        if annotations is not None:
            annotations = annotations[sel]
        n_removed = int((~sel).sum())
        if n_removed:
            print(
                f"{n_removed} loci which are fixed or have minor allele "
                f"frequency < {MAF} are removed."
            )

    n_obs, n_markers = mat.shape
    sum2pq = float(np.sum(2.0 * p * (1.0 - p)))

    raw_int8 = None
    if storage == "int8" and not is_grm and method != "GBLUP":
        raw = np.round(mat).astype(np.int8)
        if not np.allclose(raw, mat, atol=1e-6):
            raise ValueError(
                "storage='int8' requires integer genotype scores "
                "(use storage='f32' for fractional imputed values)"
            )
        raw_int8 = raw
        col_means = raw.mean(axis=0, dtype=np.float64)
        if center:
            mat = (raw - col_means[None, :]).astype(dtype)
    elif center and not is_grm:
        mat = (mat - col_means[None, :]).astype(dtype)

    if method == "GBLUP" and not is_grm:
        # GRM from genotype covariates (readgenotypes.jl:404-420).
        denom = np.sqrt(2.0 * p * (1.0 - p)).astype(dtype)
        Z = mat / denom[None, :]
        grm = (Z @ Z.T + np.eye(n_obs, dtype=dtype) * dtype(1e-5)) / dtype(n_markers)
        tries = 0
        while True:
            try:
                np.linalg.cholesky(grm.astype(np.float64))
                break
            except np.linalg.LinAlgError:
                grm = grm + np.eye(n_obs, dtype=dtype) * dtype(1e-5)
                tries += 1
                if tries > 10:
                    raise ValueError("could not make the relationship matrix positive definite")
        mat = grm
        is_grm = True

    pi = Pi
    if method == "BayesR":
        pi = _DEFAULT_BAYESR_PI.copy() if np.ndim(Pi) == 0 and Pi == 0.0 else np.asarray(Pi, dtype=np.float64)
        if pi.shape != (4,):
            raise ValueError("BayesR Pi must be a length-4 vector")
        if not np.isclose(pi.sum(), 1.0, atol=1e-8) or (pi < 0).any():
            raise ValueError("BayesR Pi must be nonnegative and sum to 1")

    g = Genotypes(
        obs_ids=obs_ids,
        marker_ids=marker_ids,
        n_obs=n_obs,
        n_markers=n_markers,
        allele_freq=np.asarray(p, dtype=np.float64),
        sum2pq=sum2pq,
        centered=center,
        genotypes=mat,
        is_grm=is_grm,
        method=method,
        pi=pi,
        estimate_pi=estimatePi,
        G=VarianceSpec(
            val=G if G_is_marker_variance else None,
            df=df,
            estimate_variance=estimate_variance,
            estimate_scale=estimate_scale,
            constraint=constraint,
        ),
        genetic_variance=VarianceSpec(
            val=None if G_is_marker_variance else G,
            df=df,
            estimate_variance=estimate_variance,
            estimate_scale=estimate_scale,
            constraint=constraint,
        ),
        name=name,
        raw_int8=raw_int8,
        col_means=np.asarray(col_means, dtype=np.float64),
        annotations=annotations,
        multi_trait_sampler=multi_trait_sampler,
    )
    if starting_value is not None:
        g.starting_alpha = np.asarray(starting_value, dtype=dtype)
    return g
