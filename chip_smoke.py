"""Smoke test of the Gibbs engine on one NVIDIA GPU.

Drives the path users call -- get_genotypes -> build_model -> runMCMC -- on
seeded simulated data at the widths of BASELINE.json's configurations, and
the checks only a GPU can answer:

  A       single-trait BayesC, pi estimated, dense f32, n=10,000 x p=50,000
  B       the same data in the 2-bit grouped store
  offload phase B with host_offload_genotypes=True (store in pinned host
          memory), against phase B's device-resident run
  C       BayesR (4 classes), dense f32, n=10,000 x p=100,000
  D       two-trait BayesC, dense f32, n=10,000 x p=50,000
  gram    phase A's Gram tiles and xpx against numpy float64
  kernel  the Pallas inner-round kernels against the XLA scan on the same
          draws, one sync round, with both timings

Usage:
  python chip_smoke.py                  one GPU, every phase above
  python chip_smoke.py --four-cards     four GPUs: the chain mesh and the
                                        chain x marker mesh, and what each is
                                        compared with; no other phase
  python chip_smoke.py --only A,kernel  a subset of the one-GPU phases

Refuses to run without a GPU. A failed phase makes the exit status
non-zero; on success the last line of standard output is one JSON object,
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

# Accuracy floors: corr(EBV, simulated true breeding value) from a CPU run of
# the same seed and size (benchmarks/smoke_floors.py; PERF.md), minus a
# margin of 0.05 for float rounding that moves the chain. A diverged chain
# falls far below them. The 4-chain run of four_a pools chains of phase A.
FLOORS = {"A": 0.56, "B": 0.54, "C": 0.86, "D": (0.50, 0.50), "four_a": 0.56,
          "four_b": 0.78}
# Posterior-mean h2 bands: the same CPU run's value +- 0.1. The simulated h2
# is 0.5, but eight outer iterations move the variance components only part
# of the way from their starting values, so the band is centred on what the
# CPU chain reached, not on the truth; a diverged chain leaves it.
H2_BANDS = {"A": (0.09, 0.29), "B": (0.11, 0.31), "C": (0.47, 0.67)}
CHAIN = dict(chain_length=1024, burnin=256, output_samples_frequency=128)
# (n animals, p SNPs, QTL, seed) per data set
SIZES = {"50k": (10_000, 50_000, 200, 11), "C": (10_000, 100_000, 300, 13),
         "D": (10_000, 50_000, 200, 17), "four_b": (10_000, 3_840, 100, 19)}


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

def simulate(n, p, n_qtl, seed, n_traits=1, h2=0.5, rg=0.6):
    """Seeded genotypes (0/1/2 dosages, allele frequencies U(0.05, 0.95))
    and phenotypes y = mu + X_c @ effects + e with heritability h2, made on
    the device in column chunks. Returns (X (n, p) float32 numpy,
    phenotype DataFrame, true breeding values (n, n_traits))."""
    import jax
    import jax.numpy as jnp
    import pandas as pd

    key = jax.random.PRNGKey(seed)
    kf, kx, kq, ke, kr = jax.random.split(key, 5)
    freqs = jax.random.uniform(kf, (p,), minval=0.05, maxval=0.95)

    @jax.jit
    def chunk(k, f):
        u = jax.random.uniform(k, (2, n, f.shape[0]))
        return ((u[0] < f) + (u[1] < f)).astype(jnp.float32)

    X = np.empty((n, p), np.float32)
    step = 8192
    for c0 in range(0, p, step):
        c1 = min(p, c0 + step)
        X[:, c0:c1] = np.asarray(chunk(jax.random.fold_in(kx, c0), freqs[c0:c1]))
    rng = np.random.default_rng(seed)
    qtl = rng.choice(p, size=n_qtl, replace=False)
    cov = np.full((n_traits, n_traits), rg)
    np.fill_diagonal(cov, 1.0)
    eff = rng.multivariate_normal(np.zeros(n_traits), cov, size=n_qtl)
    Xq = X[:, qtl].astype(np.float64)
    bv = (Xq - Xq.mean(axis=0)) @ eff                       # (n, t)
    var_e = bv.var(axis=0) * (1.0 - h2) / h2
    y = 10.0 + bv + rng.normal(size=bv.shape) * np.sqrt(var_e)
    pheno = pd.DataFrame({"ID": [str(i + 1) for i in range(n)]})
    names = ["y"] if n_traits == 1 else [f"y{k + 1}" for k in range(n_traits)]
    for k, nm in enumerate(names):
        pheno[nm] = y[:, k]
    return X, pheno, bv


# --------------------------------------------------------------------------
# measurement helpers
# --------------------------------------------------------------------------

class CompileClock:
    """Seconds spent compiling (JAX's own monitoring events) and the number
    of persistent-cache hits, read as differences around a phase."""

    def __init__(self):
        import jax

        self.compile_s = 0.0
        self.cache_hits = 0

        def on_duration(event, secs, **_):
            if event.startswith("/jax/core/compile/"):
                self.compile_s += secs

        def on_event(event, **_):
            if event == "/jax/compilation_cache/cache_hits":
                self.cache_hits += 1

        jax.monitoring.register_event_duration_secs_listener(on_duration)
        jax.monitoring.register_event_listener(on_event)

    def snapshot(self):
        return self.compile_s, self.cache_hits


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def memory_line(devices) -> str:
    parts = []
    for d in devices:
        st = d.memory_stats() or {}
        parts.append(f"dev{d.id}: bytes_limit={st.get('bytes_limit')} "
                     f"peak_bytes_in_use={st.get('peak_bytes_in_use')}")
    return "; ".join(parts)


def ebv_accuracy(out, bv, traits=("y",)):
    return [float(np.corrcoef(out[f"EBV_{t}"]["EBV"].to_numpy(dtype=float),
                              bv[:, k])[0, 1]) for k, t in enumerate(traits)]


def check(cond: bool, what: str):
    print(f"    check {what}: {'ok' if cond else 'FAILED'}")
    if not cond:
        raise AssertionError(what)


def rel_close(a, b, rtol, scale):
    """max |a - b| / scale <= rtol, elementwise scale (broadcast); a zero
    scale (a monomorphic marker) admits only a zero difference."""
    scale = np.maximum(np.asarray(scale, np.float64), np.finfo(np.float64).tiny)
    err = float(np.max(np.abs(np.asarray(a, np.float64)
                              - np.asarray(b, np.float64)) / scale))
    return err, err <= rtol


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

_DATA = {}


def data_50k():
    if "50k" not in _DATA:
        n, p, q, seed = SIZES["50k"]
        _DATA["50k"] = simulate(n, p, q, seed=seed)
    return _DATA["50k"]


def run_st(X, pheno, method, storage="f32", **kw):
    from jwas_tpu import build_model, get_genotypes, runMCMC

    geno = get_genotypes(X, method=method, storage=storage, name="geno",
                         quality_control=False)
    model = build_model("y = intercept + geno", genotypes=geno)
    opts = dict(CHAIN, fast_blocks=True, seed=2024, output_folder="",
                printout_model_info=False)
    opts.update(kw)
    return runMCMC(model, pheno, **opts)


def check_st(name, out, bv, floor, h2_band=None):
    acc = ebv_accuracy(out, bv)[0]
    h2 = float(out["heritability"]["Estimate"].iloc[0])
    print(f"    EBV accuracy {acc:.4f} (floor {floor}); h2 {h2:.4f} "
          f"(band {h2_band})")
    check(np.isfinite(acc) and acc >= floor, f"{name} EBV accuracy >= floor")
    if h2_band is not None:
        check(h2_band[0] <= h2 <= h2_band[1], f"{name} h2 in band")
    return acc, h2


def phase_A():
    X, pheno, bv = data_50k()
    out = run_st(X, pheno, "BayesC")
    _DATA["A_out"] = out
    return check_st("A", out, bv, FLOORS["A"], H2_BANDS["A"])


def phase_B():
    X, pheno, bv = data_50k()
    out = run_st(X, pheno, "BayesC", storage="2bit",
                 host_offload_genotypes=False)
    _DATA["B_out"] = out
    return check_st("B", out, bv, FLOORS["B"], H2_BANDS["B"])


def phase_offload():
    """Phase B with the store in pinned host memory: runMCMC end to end,
    then the grouped sweep streaming every group over PCIe against the
    device-resident store on the same draws (bit-equal)."""
    import jax
    import jax.numpy as jnp

    from jwas_tpu.io.packed import prepare_packed_genotypes
    from jwas_tpu.ops import grouped as gr

    X, pheno, bv = data_50k()
    check(gr.host_memory_supported(), "pinned-host staging supported")
    out = run_st(X, pheno, "BayesC", storage="2bit",
                 host_offload_genotypes=True)
    acc, _ = check_st("offload", out, bv, FLOORS["B"], H2_BANDS["B"])
    if "B_out" in _DATA:
        e_b = _DATA["B_out"]["EBV_y"]["EBV"].to_numpy(dtype=float)
        e_h = out["EBV_y"]["EBV"].to_numpy(dtype=float)
        c = float(np.corrcoef(e_b, e_h)[0, 1])
        print(f"    corr(EBV offload, EBV device-resident) {c:.5f}; "
              f"max |diff| {np.max(np.abs(e_b - e_h)):.3e}")
        check(c > 0.99, "offload EBV agrees with phase B")

    # ops level: every group streamed from pinned host (no hybrid split)
    store = prepare_packed_genotypes(X[:, :min(8192, X.shape[1])])
    gm = gr.build_grouped_markers(store, store.obs_ids, 24, group_blocks=128,
                                  host=False)
    gm_h = gm._replace(store=gr.to_host_memory(gm.store))
    check(gm_h.store.sharding.memory_kind == "pinned_host",
          "store placed in pinned host memory")
    p_pad = gm.xpx.shape[0]
    y = jnp.asarray(pheno["y"].to_numpy() - pheno["y"].mean(), jnp.float32)
    args = (jnp.zeros((p_pad,)), jnp.zeros((p_pad,)),
            jnp.where(gm.valid > 0, 1, 0).astype(jnp.int32), y, None,
            jnp.float32(1.0), jnp.float32(0.01),
            jnp.where(gm.valid > 0, 0.99, 1.0), jax.random.PRNGKey(3))
    dev = gr.sweep_blocks_abc_grouped(gm, *args, nreps=24, sync_every=8)
    host = gr.sweep_blocks_abc_grouped(gm_h, *args, nreps=24, sync_every=8,
                                       host_store=True, prefetch=True)
    same = all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(dev, host))
    check(same, "streamed sweep bit-equal to device-resident sweep")
    return acc


def phase_C():
    n, p, q, seed = SIZES["C"]
    X, pheno, bv = simulate(n, p, q, seed=seed)
    out = run_st(X, pheno, "BayesR")
    pi = out["pi_geno"]["Estimate"].to_numpy(dtype=float)
    print(f"    pi {np.round(pi, 4)}")
    check(abs(pi.sum() - 1.0) < 1e-3, "C class probabilities sum to 1")
    return check_st("C", out, bv, FLOORS["C"], H2_BANDS["C"])


def phase_D():
    from jwas_tpu import build_model, get_genotypes, runMCMC

    n, p, q, seed = SIZES["D"]
    X, pheno, bv = simulate(n, p, q, seed=seed, n_traits=2)
    geno = get_genotypes(X, method="BayesC", name="geno",
                         quality_control=False)
    model = build_model("y1 = intercept + geno\ny2 = intercept + geno",
                        genotypes=geno)
    out = runMCMC(model, pheno, **CHAIN, fast_blocks=True, seed=2024,
                  output_folder="", printout_model_info=False)
    accs = ebv_accuracy(out, bv, traits=("y1", "y2"))
    print(f"    EBV accuracy {np.round(accs, 4)} (floors {FLOORS['D']})")
    for k, (a, f) in enumerate(zip(accs, FLOORS["D"])):
        check(np.isfinite(a) and a >= f, f"D trait {k + 1} accuracy >= floor")
    return accs


def phase_gram():
    """Gram tiles and xpx of phase A (b=128) on the GPU against float64.
    Off-diagonal entries are compared on the Cauchy-Schwarz scale
    sqrt(xpx_r xpx_c), where TF32 products miss by ~1e-3. Then the
    per-round GEMVs X'w and X v as the sweeps compute them (markers.fdot),
    on the scale ||x_j|| ||w||: float32 sums miss by ~1e-8 there, TF32 by
    ~1e-5 (printed for X'w at the default precision)."""
    import jax
    import jax.numpy as jnp

    from jwas_tpu.ops import markers as mk

    X, _, _ = data_50k()
    Xc = X - X.mean(axis=0)
    md = mk.build_marker_blocks(jnp.asarray(Xc), block_size=128)
    grams = np.asarray(md.grams)
    xpx = np.asarray(md.xpx)
    blocks = np.linspace(0, grams.shape[2] - 2, 16).astype(int)
    worst_g = worst_x = 0.0
    for i in blocks:
        Xb = Xc[:, i * 128:(i + 1) * 128].astype(np.float64)
        g64 = Xb.T @ Xb
        d = np.sqrt(np.outer(np.diag(g64), np.diag(g64)))
        # j-major tiles: grams[j, r, i] = (X_i' X_i)[r, j]
        worst_g = max(worst_g, rel_close(grams[:, :, i].T, g64, 1e-5, d)[0])
        worst_x = max(worst_x, rel_close(xpx[i * 128:(i + 1) * 128],
                                         np.diag(g64), 1e-5,
                                         np.diag(g64))[0])
    print(f"    max scaled Gram error {worst_g:.3e}, max xpx rel error "
          f"{worst_x:.3e} (tolerance 1e-5, {len(blocks)} blocks)")
    check(worst_g <= 1e-5, "Gram tiles match float64")
    check(worst_x <= 1e-5, "xpx matches float64")

    rng = np.random.default_rng(0)
    p = Xc.shape[1]
    w = rng.normal(size=Xc.shape[0]).astype(np.float32)
    v = rng.normal(size=p).astype(np.float32)
    Xd, wd, vd = md.X[:, :p], jnp.asarray(w), jnp.asarray(v)
    rhs = np.asarray(jax.jit(lambda X, w: mk.fdot(X.T, w))(Xd, wd))
    res = np.asarray(jax.jit(mk.fdot)(Xd, vd))
    rhs_default = np.asarray(jax.jit(lambda X, w: X.T @ w)(Xd, wd))
    X64 = Xc.astype(np.float64)
    rhs64, scale = X64.T @ w, np.sqrt(xpx[:p]) * np.linalg.norm(w)
    e_rhs = rel_close(rhs, rhs64, 1e-6, scale)[0]
    e_res = rel_close(res, X64 @ v, 1e-6, np.linalg.norm(X64, axis=1)
                      * np.linalg.norm(v))[0]
    e_def = rel_close(rhs_default, rhs64, 1e-6, scale)[0]
    print(f"    sweep GEMVs: X'w error {e_rhs:.3e}, X v error {e_res:.3e} "
          f"(tolerance 1e-6); X'w at the default precision {e_def:.3e}")
    check(max(e_rhs, e_res) <= 1e-6, "sweep GEMVs run in float32")


def kernel_inputs(b, nblocks, reps, seed=0, n=10_000):
    """One sync round's worth of inputs at a real width: Gram tiles of
    simulated dosages, the rhs of a simulated phenotype, and the draws."""
    import jax
    import jax.numpy as jnp

    from jwas_tpu.ops import markers as mk

    key = jax.random.PRNGKey(seed)
    kx, ky, ka, ku, kz, kg = jax.random.split(key, 6)
    p = b * nblocks
    f = jax.random.uniform(kx, (p,), minval=0.05, maxval=0.95)
    u = jax.random.uniform(jax.random.fold_in(kx, 1), (2, n, p))
    X = (u[0] < f).astype(jnp.float32) + (u[1] < f).astype(jnp.float32)
    X = X - jnp.mean(X, axis=0)
    md = mk.build_marker_blocks(X, block_size=b)
    y = X[:, :: max(1, p // 200)] @ jax.random.normal(ky, (X[:, :: max(1, p // 200)].shape[1],))
    y = y + jnp.std(y) * jax.random.normal(ka, (n,))
    j = lambda v: mk._to_jmajor(v, nblocks, b)               # noqa: E731
    vare = float(jnp.var(y)) * 0.5
    return dict(
        grams=md.grams, xpx_b=j(md.xpx),
        var_eff_b=jnp.full((b, nblocks), 0.5 * float(jnp.var(y)) / (0.01 * p)),
        log_pi=jnp.full((b, nblocks), np.log(0.99), jnp.float32),
        log_pi_comp=jnp.full((b, nblocks), np.log(0.01), jnp.float32),
        alpha_b=jnp.zeros((b, nblocks)), beta_b=jnp.zeros((b, nblocks)),
        delta_b=jnp.zeros((b, nblocks), jnp.int32), rhs0=j(X.T @ y),
        us=jax.random.uniform(ku, (reps * b, nblocks)),
        zs=jax.random.normal(kz, (reps * b, nblocks)),
        inv_vare=jnp.float32(1.0 / vare), kg=kg, kz=kz,
        log_pi4=jnp.broadcast_to(jnp.log(jnp.asarray(
            [0.95, 0.03, 0.015, 0.005], jnp.float32)), (b, nblocks, 4)),
        sigma_sq=jnp.float32(0.5 * float(jnp.var(y)) / (0.05 * p)),
    )


def time_call(fn, repeats=5):
    import jax

    out = jax.block_until_ready(fn())                  # compile + warm up
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return out, float(np.median(ts))


def compare_inner_rounds(method, b, nblocks, reps):
    """Kernel against the XLA scan on the same draws, one sync round.
    Returns (xla_seconds, kernel_seconds, max_rel_err, delta_agreement)."""
    import jax

    from jwas_tpu.ops import markers as mk

    d = kernel_inputs(b, nblocks, reps)
    if method == "abc":
        args = [d[k] for k in ("grams", "xpx_b", "var_eff_b", "log_pi",
                               "log_pi_comp", "alpha_b", "beta_b", "delta_b",
                               "rhs0", "us", "zs", "inv_vare")]
        xla = jax.jit(lambda *a: mk.abc_inner_rounds(*a, use_pallas=False))
        ker = jax.jit(lambda *a: mk.abc_inner_rounds(*a, use_pallas=True))
        pairs = ((0, "alpha"), (1, "beta"))
    else:
        args = [d[k] for k in ("grams", "xpx_b", "log_pi4", "alpha_b",
                               "delta_b", "rhs0", "inv_vare", "sigma_sq",
                               "kg", "kz")]
        xla = jax.jit(lambda *a: mk.bayesr_inner_rounds(
            *a, reps=reps, use_pallas=False))
        ker = jax.jit(lambda *a: mk.bayesr_inner_rounds(
            *a, reps=reps, use_pallas=True))
        pairs = ((0, "alpha"),)
    ref, t_x = time_call(lambda: xla(*args))
    got, t_k = time_call(lambda: ker(*args))
    didx = 2 if method == "abc" else 1
    agree = float(np.mean(np.asarray(ref[didx]) == np.asarray(got[didx])))
    worst = 0.0
    for i, _ in pairs:
        r = np.asarray(ref[i], np.float64)
        g = np.asarray(got[i], np.float64)
        scale = np.maximum(np.abs(r), np.max(np.abs(r)) * 1e-3 + 1e-30)
        worst = max(worst, float(np.max(np.abs(r - g) / scale)))
    return t_x, t_k, worst, agree


KERNEL_SHAPES = (
    # (method, b, blocks per group, reps in one sync round)
    ("abc", 128, 128, 32),      # north-star group: b=128, gb=128, sync=32
    ("abc", 24, 128, 8),        # phase B's grouped 2-bit store
    ("abc", 128, 23, 8),        # phases A/D: n=10k caps a group at 23 blocks
    ("bayesr", 128, 23, 8),     # phase C
    ("bayesr", 128, 128, 32),
)


def phase_kernel():
    import jax

    from jwas_tpu.utils.backend import kernel_available

    check(kernel_available(), "a compiled inner-round kernel exists here")
    print(f"    {'method':7s} {'b':>4s} {'blocks':>6s} {'reps':>4s} "
          f"{'XLA ms':>9s} {'kernel ms':>9s} {'XLA us/step':>11s} "
          f"{'kernel us/step':>14s} {'max rel err':>11s} {'delta agree':>11s}")
    for method, b, nb, reps in KERNEL_SHAPES:
        t_x, t_k, err, agree = compare_inner_rounds(method, b, nb, reps)
        steps = reps * b
        print(f"    {method:7s} {b:4d} {nb:6d} {reps:4d} {t_x * 1e3:9.3f} "
              f"{t_k * 1e3:9.3f} {t_x / steps * 1e6:11.3f} "
              f"{t_k / steps * 1e6:14.3f} {err:11.3e} {agree:11.6f}",
              flush=True)
        # a flipped indicator changes that block's later steps, so values
        # are held to rtol 1e-5 only while indicators agree everywhere
        check(agree >= 0.999, f"{method} b={b} indicators agree >= 99.9%")
        if agree == 1.0:
            check(err <= 1e-5, f"{method} b={b} alpha/beta within rtol 1e-5")
    jax.clear_caches()


# --------------------------------------------------------------------------
# four cards
# --------------------------------------------------------------------------

def posterior_means(folder):
    """Posterior-mean marker effects and residual variance of the chain
    whose sample files are in `folder` (after burn-in, as saved)."""
    import pandas as pd

    a = pd.read_csv(os.path.join(folder, "MCMC_samples_marker_effects_geno_y.txt"))
    v = pd.read_csv(os.path.join(folder, "MCMC_samples_residual_variance.txt"))
    return a.to_numpy(dtype=float).mean(axis=0), float(v.to_numpy().mean())


def phase_four_a():
    """4 chains on a chain mesh at phase A's size; chain 0 shares the
    single-card run's key, and both run the XLA sweep, so they draw the
    same numbers and differ only in summation order."""
    from jwas_tpu.parallel.mesh import make_mesh

    X, pheno, bv = data_50k()
    tmp = tempfile.mkdtemp(prefix="smoke4a_")
    try:
        mesh = make_mesh(n_chains=4, n_marker_shards=1)
        out4 = run_st(X, pheno, "BayesC", n_chains=4, mesh=mesh,
                      use_pallas=False, output_folder=os.path.join(tmp, "m"))
        out1 = run_st(X, pheno, "BayesC", use_pallas=False,
                      output_folder=os.path.join(tmp, "s"))
        a4, v4 = posterior_means(os.path.join(tmp, "m"))
        a1, v1 = posterior_means(os.path.join(tmp, "s"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    corr = float(np.corrcoef(a4, a1)[0, 1])
    print(f"    chain 0 vs single card: alpha corr {corr:.5f}; vare "
          f"{v4:.4f} vs {v1:.4f}")
    check(corr > 0.99, "chain-0 posterior-mean alpha corr > 0.99")
    check(abs(v4 - v1) <= 0.05 * v1, "chain-0 vare within 5%")
    check_st("four_a pooled", out4, bv, FLOORS["four_a"])
    return check_st("four_a single", out1, bv, FLOORS["A"], H2_BANDS["A"])


def phase_four_b():
    """2 chains x 2 marker shards on dense storage, inside the flat
    schedule's stability bound (p <= 0.4 n), against the same two chains
    on one card (both on the XLA sweep, so on the same draws)."""
    from jwas_tpu.parallel.mesh import make_mesh

    n, p, q, seed = SIZES["four_b"]
    X, pheno, bv = simulate(n, p, q, seed=seed)
    mesh = make_mesh(n_chains=2, n_marker_shards=2)
    out = run_st(X, pheno, "BayesC", n_chains=2, mesh=mesh)
    ref = run_st(X, pheno, "BayesC", n_chains=2, use_pallas=False)
    e_m = out["EBV_y"]["EBV"].to_numpy(dtype=float)
    e_r = ref["EBV_y"]["EBV"].to_numpy(dtype=float)
    c = float(np.corrcoef(e_m, e_r)[0, 1])
    print(f"    corr(EBV 2x2 mesh, EBV one card) {c:.5f}")
    check(c > 0.99, "2x2 mesh EBV agrees with the one-card run")
    return check_st("four_b", out, bv, FLOORS["four_b"])


ONE_CARD = {"A": phase_A, "B": phase_B, "offload": phase_offload,
            "C": phase_C, "D": phase_D, "gram": phase_gram,
            "kernel": phase_kernel}
FOUR_CARDS = {"four_a": phase_four_a, "four_b": phase_four_b}


def run_phases(phases, clock, devices) -> list:
    failed = []
    for name, fn in phases.items():
        print(f"== phase {name}", flush=True)
        c0, h0 = clock.snapshot()
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:                                   # noqa: BLE001
            traceback.print_exc()
            failed.append(name)
        wall = time.perf_counter() - t0
        c1, h1 = clock.snapshot()
        print(f"    {name}: {'FAILED' if name in failed else 'passed'}; "
              f"wall {wall:.1f}s, compile {c1 - c0:.1f}s, chain and checks "
              f"{wall - (c1 - c0):.1f}s, compile-cache hits {h1 - h0}",
              flush=True)
        print(f"    memory: {memory_line(devices)}", flush=True)
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU mesh phases")
    ap.add_argument("--only", default="",
                    help="comma-separated one-GPU phases to run")
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX backend {jax.default_backend()!r}); "
              f"refusing to run", file=sys.stderr)
        return 2
    from jwas_tpu.utils.backend import enable_compile_cache

    cache = enable_compile_cache()
    devices = jax.devices()
    need = 4 if args.four_cards else 1
    if len(devices) < need:
        print(f"chip_smoke: {len(devices)} GPU(s), {need} needed",
              file=sys.stderr)
        return 2
    devices = devices[:need]
    print(f"card: {card_line()}")
    print(f"jax {jax.__version__}; devices {devices}; compile cache {cache}")
    clock = CompileClock()
    if args.four_cards:
        phases = FOUR_CARDS
    elif args.only:
        phases = {k: ONE_CARD[k] for k in args.only.split(",")}
    else:
        phases = ONE_CARD
    failed = run_phases(phases, clock, devices)
    if failed:
        print(f"chip_smoke: FAILED phases {failed}", file=sys.stderr)
        return 1
    print(f"card: {card_line()}")
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": need}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
