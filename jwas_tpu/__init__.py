"""jwas_tpu — a Bayesian whole-genome regression engine in JAX.

A from-scratch reimplementation of the capabilities of JWAS.jl (reference:
reworkhow/JWAS.jl) for accelerators: the per-marker Gibbs sweep of the
Bayesian Alphabet runs as a blocked, vectorized XLA/Pallas computation; the
n x p genotype matrix is sharded column-wise over a device mesh; chains run in
parallel across replicas.

Public API (mirrors the reference export list, `src/1.JWAS/src/JWAS.jl:61-70`):

- :func:`get_pedigree`, :func:`get_info`  — pedigree engine (A-inverse).
- :func:`get_genotypes`                   — genotype loading + QC.
- :func:`build_model`, :func:`set_covariate`, :func:`set_random`,
  :func:`describe`                        — model builder.
- :func:`runMCMC`                         — MCMC driver.
- :func:`solve`                           — non-MCMC MME solvers.
- :func:`GWAS`                            — window-based GWAS post-processing.
- :func:`dataset`                         — packaged example data.
"""

from jwas_tpu.io.pedigree import Pedigree, get_pedigree, get_info
from jwas_tpu.io.genotypes import Genotypes, get_genotypes
from jwas_tpu.models.model import (
    Model,
    build_model,
    set_covariate,
    set_random,
    describe,
    add_genotypes,
    getMCMCinfo,
    outputEBV,
    outputMCMCsamples,
)
from jwas_tpu.engine.mcmc import runMCMC
from jwas_tpu.engine.solve import solve
from jwas_tpu.analysis.gwas import GWAS
from jwas_tpu.io.datasets import dataset
from jwas_tpu.ops.rrm import generate_full_phi
from jwas_tpu.analysis.diagnostics import (PSRF, PSRF_per_parameter,
                                           traceplot, LOOCV, lsmeans, getEBV)
from jwas_tpu.io.packed import Packed2BitStore, prepare_packed_genotypes

# reference-compatible name (prepare_streaming_genotypes, JWAS.jl:61-70)
prepare_streaming_genotypes = prepare_packed_genotypes

__all__ = [
    "Pedigree",
    "get_pedigree",
    "get_info",
    "Genotypes",
    "get_genotypes",
    "Model",
    "build_model",
    "set_covariate",
    "set_random",
    "describe",
    "add_genotypes",
    "getMCMCinfo",
    "outputEBV",
    "outputMCMCsamples",
    "runMCMC",
    "solve",
    "GWAS",
    "dataset",
    "generate_full_phi",
    "PSRF",
    "PSRF_per_parameter",
    "traceplot",
    "LOOCV",
    "lsmeans",
    "getEBV",
    "Packed2BitStore",
    "prepare_packed_genotypes",
    "prepare_streaming_genotypes",
]

__version__ = "0.1.0"
