"""Single-trait marker-effect Gibbs samplers (the Bayesian Alphabet hot loops).

From-scratch accelerator re-design of the reference marker samplers (reference:
src/1.JWAS/src/markers/BayesianAlphabet/BayesABC.jl, BayesC0L.jl, BayesR.jl,
tools4genotypes.jl:237-275). The math per marker update is identical; the
execution model is rebuilt for XLA:

- **Exact sweep** (`sweep_exact_*`): a `lax.scan` over markers performing the
  reference single-site update — dot(x_j, ycorr) + rank-1 residual update.
  O(2 N p) per sweep and strictly sequential; used for parity testing and
  small problems (BayesABC.jl:60-80).

- **Blocked sweep** (`sweep_blocks_*`): the fast_blocks restructuring
  (BayesABC.jl:111-188). Markers are partitioned into `nblocks` blocks of
  size `b`; per block the RHS vector X_b' R^-1 ycorr and the Gram tile
  X_b' R^-1 X_b are used so the inner chain touches only O(b) state per step.
  All blocks advance **in parallel** (one scan step updates marker j of every
  block simultaneously, vectorized across the block axis) — the reference's
  documented `independent_blocks=true` semantics (BayesABC.jl:190-255), which
  is exact when X_b' W X_c = 0 and a controlled approximation otherwise.

  **Residual sync rounds**: cross-block staleness grows with the number of
  inner repetitions run against a frozen residual — left unchecked it biases
  the posterior (measured: EBV accuracy 0.85 vs 0.95 at p=200, nreps=128,
  2 blocks). The sweep therefore splits its `nreps` inner repetitions into
  rounds of `sync_every` reps; between rounds the shared residual is
  reconciled exactly (ycorr += X @ d_alpha; block RHS recomputed from the
  fresh residual). sync_every=8 is empirically indistinguishable from
  per-rep sync on EBV accuracy while amortizing the two O(n*p) GEMVs over 8
  effective sweeps; sync_every=None (or nreps) reproduces the reference's
  fully-amortized approximate mode. One outer iteration still advances the
  chain by `nreps` effective sweeps (JWAS.jl:293-316 chain-length rescaling).

Masking convention: markers are padded to nblocks*b. Padded columns are all
zero with xpx = 0 and prior inclusion probability pi = 1 (always excluded), so
they never touch the residual nor the sufficient statistics.

All samplers are pure: (state..., key) -> new state. RNG is threefry
counter-based, so fixed-seed replay is bitwise reproducible across runs and
shardings of the same configuration.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

BAYESR_GAMMA = (0.0, 0.01, 0.1, 1.0)


def full_precision(dtype):
    """The `precision` of matrix products whose float32 result must be a
    float32 result: the set-up products every conditional posterior reads
    (Gram tiles, W'R^-1 W) and the multi-trait GEMMs.

    A GPU runs float32 products in TF32 (about three decimal digits) by
    default, and `Precision.HIGHEST` does not buy float32 for a batched
    product there: on an H100 the batched Gram einsum at HIGHEST missed
    float64 by 1.3e-4 of the Cauchy-Schwarz scale, against 8e-6 with the
    float32 algorithm (PERF.md). Other types (float64 under
    double_precision) take HIGHEST, which is exact for them."""
    if jnp.dtype(dtype) == jnp.float32:
        return jax.lax.DotAlgorithmPreset.F32_F32_F32
    return jax.lax.Precision.HIGHEST


def fdot(a, b):
    """a @ b at full_precision: the GEMVs of the sweeps (X' w, X v). They
    are matrix-vector products, but an H100 still runs X' w in TF32 at the
    default precision (1.4e-5 of ||x_j|| ||w||, against 3e-9 for X v;
    PERF.md). They are memory-bound, so float32 costs nothing."""
    return jnp.matmul(a, b, precision=full_precision(jnp.result_type(a, b)))


def gram_tiles(X, Xw, obs_chunk: int = 128):
    """j-major block Gram tiles of (n, k, b) X against weighted Xw:
    out[j, r, i] = sum_n X[n, i, j] * Xw[n, i, r], shape (b, b, k).

    A matrix product sums its n terms into one running float32 total, and
    for a rare-allele marker (many equal small terms) the rounding is
    biased: about n * 1.4e-8 relative on an H100 (2.8e-5 at 2,048 rows,
    PERF.md). So the product sums chunks of `obs_chunk` rows, and the
    chunk totals are added by a reduction. With obs_chunk = b = 128 the
    chunk totals take as much memory as the (n, k, b) input."""
    n = X.shape[0]
    prec = full_precision(X.dtype)
    nc = -(-n // obs_chunk)
    if nc == 1:
        return jnp.einsum("nij,nir->jri", X, Xw, precision=prec)
    rows = -(-n // nc)
    pad = ((0, nc * rows - n), (0, 0), (0, 0))
    chunks = lambda a: jnp.pad(a, pad).reshape(nc, rows, *a.shape[1:])  # noqa: E731
    return jnp.einsum("cnij,cnir->cjri", chunks(X), chunks(Xw),
                      precision=prec).sum(axis=0)


class MarkerBlocks(NamedTuple):
    """Static per-chain marker data in blocked layout.

    X:      (n, p_pad) centered genotype covariates (padded cols are zero).
    xpx:    (p_pad,)  x_j' R^-1 x_j.
    grams:  (b, b, nblocks) block Gram matrices, **j-major**: grams[j, r, i] =
            (X_i' R^-1 X_i)[r, j]. The within-block marker index j is the
            leading axis so each sequential Gibbs step slices one contiguous
            (b, nblocks) slab; the block axis i is the minor dimension so
            the per-step arithmetic vectorizes across all blocks in flight.
    valid:  (p_pad,) 1.0 for real markers, 0.0 for padding.
    """

    X: jnp.ndarray
    xpx: jnp.ndarray
    grams: jnp.ndarray
    valid: jnp.ndarray


def default_block_size(n_obs: int) -> int:
    """Default fast-blocks block size from the number of OBSERVATIONS:
    the reference uses floor(sqrt(nObs)) (JWAS.jl:294-296), rounded up here
    to a multiple of 128 (min 128) — a deliberate divergence for small n
    where the reference would pick a tiny block. The sampler is valid for
    any b; b also sets how stale the parallel block updates are, so the
    rounding is kept as the geometry the schedule was tuned at."""
    b = int(math.sqrt(max(n_obs, 1)))
    return max(128, ((b + 127) // 128) * 128)


def build_marker_blocks(X, rinv=None, block_size=None, gram_chunk=64) -> MarkerBlocks:
    """Pad X to a whole number of blocks and precompute xpx + block Grams.

    Equivalent of `GibbsMats` (tools4genotypes.jl:237-275). Gram tiles are
    computed in chunks of blocks to bound peak memory.
    """
    X = jnp.asarray(X)
    n, p = X.shape
    b = block_size or default_block_size(p)
    nblocks = (p + b - 1) // b
    p_pad = nblocks * b
    if p_pad != p:
        X = jnp.pad(X, ((0, 0), (0, p_pad - p)))
    w = rinv if rinv is not None else None
    Xw = X if w is None else X * w[:, None]
    xpx = jnp.sum(Xw * X, axis=0)
    grams = []
    for c0 in range(0, nblocks, gram_chunk):
        c1 = min(c0 + gram_chunk, nblocks)
        Xr = X[:, c0 * b : c1 * b].reshape(n, c1 - c0, b)
        Xrw = Xr if w is None else Xr * w[:, None, None]
        grams.append(gram_tiles(Xr, Xrw))
    grams = jnp.concatenate(grams, axis=2)
    valid = (jnp.arange(p_pad) < p).astype(X.dtype)
    return MarkerBlocks(X=X, xpx=xpx, grams=grams, valid=valid)


# ---------------------------------------------------------------------------
# Inner per-marker updates, batched over an arbitrary leading block axis.
# Shapes: rhs_j, alpha_j, xpx_j, ... all (B,) where B = #blocks in flight.
# ---------------------------------------------------------------------------


def _abc_update(rhs_j, alpha_j, xpx_j, inv_vare, var_eff_j, log_pi_j, log_pi_comp_j, u, z):
    """Spike-slab (BayesA/B/C) marker update (BayesABC.jl:24-58).

    Returns (alpha_new, beta_new, delta_new). pi is P(excluded).
    """
    inv_var_eff = 1.0 / var_eff_j
    log_var_eff = jnp.log(var_eff_j)
    rhs = (rhs_j + xpx_j * alpha_j) * inv_vare
    lhs = xpx_j * inv_vare + inv_var_eff
    inv_lhs = 1.0 / lhs
    g_hat = rhs * inv_lhs
    log_delta1 = -0.5 * (jnp.log(lhs) + log_var_eff - g_hat * rhs) + log_pi_comp_j
    prob_delta1 = 1.0 / (1.0 + jnp.exp(log_pi_j - log_delta1))
    include = u < prob_delta1
    beta_in = g_hat + z * jnp.sqrt(inv_lhs)
    beta_out = z * jnp.sqrt(var_eff_j)
    beta_new = jnp.where(include, beta_in, beta_out)
    alpha_new = jnp.where(include, beta_in, 0.0)
    delta_new = include.astype(jnp.int32)
    return alpha_new, beta_new, delta_new


def _c0l_update(rhs_j, alpha_j, xpx_j, vare, lam_j, z, valid_j):
    """RR-BLUP / BayesL marker update (BayesC0L.jl:25-47). lam_j = vare/var_j."""
    rhs = rhs_j + xpx_j * alpha_j
    lhs = xpx_j + lam_j
    inv_lhs = 1.0 / lhs
    mean = inv_lhs * rhs
    alpha_new = mean + z * jnp.sqrt(inv_lhs * vare)
    return jnp.where(valid_j > 0, alpha_new, 0.0)


def bayesr_class_logprobs(rhs_j, alpha_j, xpx_j, inv_vare, sigma_sq, log_pi_j):
    """Unnormalized BayesR class log-probabilities plus posterior moments.

    The exact math of `bayesr_class_probabilities` in the reference replay
    harness (benchmarks/bayesr_parity_replay_jwas.jl:45-59, BayesR.jl:45-97):
    rhs_j = x_j' R^-1 ycorr (marker j excluded from ycorr via +xpx*alpha).
    Returns (log_probs (B,4), beta_hat (B,3), inv_lhs (B,3)). Shared by the
    production gumbel-max sweep and the fixed-draw parity replay so the
    replay exercises the deployed kernel math.
    """
    gamma = jnp.asarray(BAYESR_GAMMA, dtype=rhs_j.dtype)
    rhs = (rhs_j + xpx_j * alpha_j) * inv_vare               # (B,)
    var_eff = gamma[1:] * sigma_sq                            # (3,)
    lhs = xpx_j[:, None] * inv_vare + 1.0 / var_eff[None, :]  # (B, 3)
    inv_lhs = 1.0 / lhs
    beta_hat = inv_lhs * rhs[:, None]
    log_like = 0.5 * (jnp.log(inv_lhs) - jnp.log(var_eff)[None, :] + beta_hat * rhs[:, None])
    log_probs = jnp.concatenate(
        [log_pi_j[:, :1], log_pi_j[:, 1:] + log_like], axis=1
    )
    return log_probs, beta_hat, inv_lhs


def _bayesr_update(rhs_j, alpha_j, xpx_j, inv_vare, sigma_sq, log_pi_j, gumbel, z):
    """BayesR 4-class mixture update (BayesR.jl:45-97).

    log_pi_j: (B, 4) log class priors; gumbel: (B, 4); z: (B,).
    Returns (alpha_new, delta_new) with delta in {0,1,2,3}.
    """
    log_probs, beta_hat, inv_lhs = bayesr_class_logprobs(
        rhs_j, alpha_j, xpx_j, inv_vare, sigma_sq, log_pi_j
    )
    klass = jnp.argmax(log_probs + gumbel, axis=1)            # Gumbel-max draw
    take = jnp.clip(klass - 1, 0, 2)
    alpha_in = jnp.take_along_axis(beta_hat, take[:, None], axis=1)[:, 0] + z * jnp.sqrt(
        jnp.take_along_axis(inv_lhs, take[:, None], axis=1)[:, 0]
    )
    alpha_new = jnp.where(klass == 0, 0.0, alpha_in)
    return alpha_new, klass.astype(jnp.int32)


# ---------------------------------------------------------------------------
# Blocked sweeps: all blocks advance in parallel (independent-blocks
# semantics), one scan step per within-block marker index, `nreps` rounds.
# ---------------------------------------------------------------------------


def _blocked_round(step_fn, carry0, draws, nreps, b):
    """Run nreps * b inner steps of `step_fn` over carry0; j cycles 0..b-1."""
    idx = jnp.tile(jnp.arange(b), nreps)

    def scan_body(carry, inp):
        return step_fn(carry, inp), None

    carry, _ = jax.lax.scan(scan_body, carry0, (idx,) + draws, unroll=4)
    return carry


def abc_inner_rounds(grams, xpx_b, var_eff_b, log_pi, log_pi_comp, alpha_b,
                     beta_b, delta_b, rhs0, us, zs, inv_vare,
                     use_pallas: bool = False, interpret: bool = False):
    """The spike-slab within-block chain of one sync round on every block.

    grams: (b, b, nblocks) j-major; state/tiles: (b, nblocks); us/zs:
    (reps*b, nblocks) pre-drawn uniforms and normals. use_pallas runs the
    compiled GPU kernel (ops/pallas_sweep.py) on the same draws; interpret
    runs that kernel in the Pallas interpreter (tests only).
    Returns (alpha_b, beta_b, delta_b, rhs_b)."""
    b = grams.shape[0]
    if use_pallas:
        from jwas_tpu.ops.pallas_sweep import abc_inner_rounds_pallas

        return abc_inner_rounds_pallas(
            grams, xpx_b, var_eff_b, log_pi, log_pi_comp, alpha_b, beta_b,
            delta_b, rhs0, us, zs, inv_vare, nreps=us.shape[0] // b,
            interpret=interpret,
        )

    def step(carry, inp):
        a_b, be_b, d_b, rhs_b = carry
        j, u, z = inp
        a_j = a_b[j]
        a_new, b_new, d_new = _abc_update(
            rhs_b[j], a_j, xpx_b[j], inv_vare, var_eff_b[j],
            log_pi[j], log_pi_comp[j], u, z,
        )
        rhs_b = rhs_b + (a_j - a_new)[None, :] * grams[j]
        return (a_b.at[j].set(a_new), be_b.at[j].set(b_new),
                d_b.at[j].set(d_new), rhs_b)

    return _blocked_round(step, (alpha_b, beta_b, delta_b, rhs0), (us, zs),
                          us.shape[0] // b, b)


def bayesr_inner_rounds(grams, xpx_b, log_pi_b, alpha_b, delta_b, rhs0,
                        inv_vare, sigma_sq, kg, kz, reps: int,
                        use_pallas: bool = False, interpret: bool = False):
    """The BayesR within-block chain of one sync round on every block.

    log_pi_b: (b, nblocks, 4) log class priors; the Gumbel panels and the
    normals are drawn from (kg, kz) identically on both implementations.
    Returns (alpha_b, delta_b, rhs_b)."""
    b, _, nblocks = grams.shape
    if use_pallas:
        from jwas_tpu.ops.pallas_sweep import bayesr_inner_rounds_pallas

        return bayesr_inner_rounds_pallas(
            grams, xpx_b, log_pi_b, alpha_b, delta_b, rhs0, inv_vare,
            sigma_sq, kg, kz, nreps=reps, interpret=interpret,
        )
    dtype = rhs0.dtype
    gum = jax.random.gumbel(kg, (reps * b, nblocks, 4), dtype=dtype)
    zs = jax.random.normal(kz, (reps * b, nblocks), dtype=dtype)

    def step(carry, inp):
        a_b, d_b, rhs_b = carry
        j, g, z = inp
        a_j = a_b[j]
        a_new, k_new = _bayesr_update(
            rhs_b[j], a_j, xpx_b[j], inv_vare, sigma_sq, log_pi_b[j], g, z
        )
        rhs_b = rhs_b + (a_j - a_new)[None, :] * grams[j]
        return (a_b.at[j].set(a_new), d_b.at[j].set(k_new), rhs_b)

    return _blocked_round(step, (alpha_b, delta_b, rhs0), (gum, zs), reps, b)


def resolve_sync_every(nreps: int, sync_every) -> int:
    """Static resolution of the sync-round length (None/0 => fully amortized)."""
    if sync_every is None or int(sync_every) <= 0:
        return nreps
    return max(1, min(int(sync_every), nreps))


def _sync_rounds(nreps: int, sync_every, key, round_fn, state):
    """Drive `round_fn(state, key_r, reps) -> state` in residual-sync rounds.

    Splits nreps into `nreps // sync_every` equal rounds (lax.scan when >1)
    plus a remainder round; each round reconciles the shared residual so
    cross-block staleness is bounded by `sync_every` inner reps. Per-round
    keys come from fold_in(key, round_index) — deterministic and identical
    across the XLA / Pallas / packed implementations.
    """
    se = resolve_sync_every(nreps, sync_every)
    n_full = nreps // se
    rem = nreps - n_full * se
    if n_full == 1 and rem == 0:
        return round_fn(state, jax.random.fold_in(key, 0), se)
    if n_full > 0:
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(n_full))

        def body(s, kr):
            return round_fn(s, kr, se), None

        state, _ = jax.lax.scan(body, state, keys)
    if rem:
        state = round_fn(state, jax.random.fold_in(key, n_full), rem)
    return state


def _to_jmajor(x, nblocks, b):
    """(p_pad,) -> (b, nblocks): within-block index leading, block index minor."""
    return x.reshape(nblocks, b).T


def _from_jmajor(x):
    """(b, nblocks) -> (p_pad,)."""
    return x.T.reshape(-1)


@partial(jax.jit, static_argnames=("nreps", "sync_every", "use_pallas",
                                   "interpret"))
def sweep_blocks_abc(md: MarkerBlocks, alpha, beta, delta, ycorr, rinv, vare,
                     var_eff, pi, key, nreps: int = 1, sync_every=None,
                     use_pallas: bool = False, interpret: bool = False):
    """Fast-blocks BayesA/B/C sweep, all blocks in parallel.

    alpha/beta: (p_pad,); delta: (p_pad,) int32; ycorr: (n,);
    var_eff: scalar (BayesC) or (p_pad,) (BayesB); pi: (p_pad,) P(excluded).
    sync_every: inner reps between exact residual reconciliations (None =>
    all nreps run against a frozen residual, the fully-amortized mode).
    use_pallas/interpret: see abc_inner_rounds.
    Returns (alpha, beta, delta, ycorr).
    """
    b, _, nblocks = md.grams.shape
    dtype = ycorr.dtype
    inv_vare = 1.0 / vare
    var_eff_b = _to_jmajor(
        jnp.broadcast_to(jnp.asarray(var_eff, dtype), (nblocks * b,)), nblocks, b
    )
    pi_c = jnp.clip(pi.astype(dtype), 1e-10, 1.0)
    log_pi = _to_jmajor(jnp.log(pi_c), nblocks, b)
    log_pi_comp = _to_jmajor(jnp.log1p(-pi_c + 1e-12), nblocks, b)
    xpx_b = _to_jmajor(md.xpx, nblocks, b)

    def round_fn(stt, kr, reps):
        alpha_b, beta_b, delta_b, ycorr = stt
        w = ycorr if rinv is None else rinv * ycorr
        rhs0 = _to_jmajor(fdot(md.X.T, w), nblocks, b)
        ku, kz = jax.random.split(kr)
        us = jax.random.uniform(ku, (reps * b, nblocks), dtype=dtype)
        zs = jax.random.normal(kz, (reps * b, nblocks), dtype=dtype)
        alpha_start = alpha_b
        alpha_b, beta_b, delta_b, _ = abc_inner_rounds(
            md.grams, xpx_b, var_eff_b, log_pi, log_pi_comp, alpha_b, beta_b,
            delta_b, rhs0, us, zs, inv_vare, use_pallas, interpret,
        )
        ycorr = ycorr + fdot(md.X, _from_jmajor(alpha_start - alpha_b))
        return (alpha_b, beta_b, delta_b, ycorr)

    alpha_b, beta_b, delta_b, ycorr = _sync_rounds(
        nreps, sync_every, key, round_fn,
        (_to_jmajor(alpha, nblocks, b), _to_jmajor(beta, nblocks, b),
         _to_jmajor(delta, nblocks, b), ycorr),
    )
    return _from_jmajor(alpha_b), _from_jmajor(beta_b), _from_jmajor(delta_b), ycorr


@partial(jax.jit, static_argnames=("nreps", "sync_every"))
def sweep_blocks_c0l(md: MarkerBlocks, alpha, ycorr, rinv, vare, var_eff,
                     gamma_arr, key, nreps: int = 1, sync_every=None):
    """Fast-blocks RR-BLUP / BayesL sweep (blocked form of BayesC0L.jl:25-47).

    gamma_arr: (p_pad,) BayesL local shrinkage (ones for RR-BLUP).
    """
    b, _, nblocks = md.grams.shape
    dtype = ycorr.dtype
    lam = (vare / var_eff) / gamma_arr
    lam_b = _to_jmajor(lam.astype(dtype), nblocks, b)
    xpx_b = _to_jmajor(md.xpx, nblocks, b)
    valid_b = _to_jmajor(md.valid, nblocks, b)

    def step(carry, inp):
        alpha_b, rhs_b = carry
        j, z = inp
        a_j = alpha_b[j]
        a_new = _c0l_update(rhs_b[j], a_j, xpx_b[j], vare, lam_b[j], z, valid_b[j])
        rhs_b = rhs_b + (a_j - a_new)[None, :] * md.grams[j]
        return (alpha_b.at[j].set(a_new), rhs_b)

    def round_fn(stt, kr, reps):
        alpha_b, ycorr = stt
        w = ycorr if rinv is None else rinv * ycorr
        rhs0 = _to_jmajor(fdot(md.X.T, w), nblocks, b)
        zs = jax.random.normal(kr, (reps * b, nblocks), dtype=dtype)
        alpha_start = alpha_b
        alpha_b, _ = _blocked_round(step, (alpha_b, rhs0), (zs,), reps, b)
        ycorr = ycorr + fdot(md.X, _from_jmajor(alpha_start - alpha_b))
        return (alpha_b, ycorr)

    alpha_b, ycorr = _sync_rounds(
        nreps, sync_every, key, round_fn, (_to_jmajor(alpha, nblocks, b), ycorr)
    )
    return _from_jmajor(alpha_b), ycorr


@partial(jax.jit, static_argnames=("nreps", "sync_every", "use_pallas",
                                   "interpret"))
def sweep_blocks_bayesr(md: MarkerBlocks, alpha, delta, ycorr, rinv, vare,
                        sigma_sq, pi, key, nreps: int = 1, sync_every=None,
                        use_pallas: bool = False, interpret: bool = False):
    """Fast-blocks BayesR sweep (blocked form of BayesR.jl:99-193).

    pi: (p_pad, 4) per-marker class priors (broadcast the global pi in setup;
    padded rows must be [1,0,0,0]). delta: (p_pad,) int32 class labels.
    use_pallas/interpret: see bayesr_inner_rounds.
    """
    b, _, nblocks = md.grams.shape
    dtype = ycorr.dtype
    inv_vare = 1.0 / vare
    log_pi = jnp.transpose(
        jnp.log(jnp.clip(pi.astype(dtype), 1e-12, 1.0)).reshape(nblocks, b, 4),
        (1, 0, 2),
    )  # (b, nblocks, 4)
    xpx_b = _to_jmajor(md.xpx, nblocks, b)

    def round_fn(stt, kr, reps):
        alpha_b, delta_b, ycorr = stt
        w = ycorr if rinv is None else rinv * ycorr
        rhs0 = _to_jmajor(fdot(md.X.T, w), nblocks, b)
        kg, kz = jax.random.split(kr)
        alpha_start = alpha_b
        alpha_b, delta_b, _ = bayesr_inner_rounds(
            md.grams, xpx_b, log_pi, alpha_b, delta_b, rhs0, inv_vare,
            sigma_sq, kg, kz, reps, use_pallas, interpret,
        )
        ycorr = ycorr + fdot(md.X, _from_jmajor(alpha_start - alpha_b))
        return (alpha_b, delta_b, ycorr)

    alpha_b, delta_b, ycorr = _sync_rounds(
        nreps, sync_every, key, round_fn,
        (_to_jmajor(alpha, nblocks, b), _to_jmajor(delta, nblocks, b), ycorr),
    )
    return _from_jmajor(alpha_b), _from_jmajor(delta_b), ycorr


# ---------------------------------------------------------------------------
# Exact single-site sweeps (reference semantics, sequential over markers).
# Used for parity tests and small p; O(2 N p) with a length-p scan.
# ---------------------------------------------------------------------------


@jax.jit
def sweep_exact_abc(X, xpx, alpha, beta, delta, ycorr, rinv, vare, var_eff, pi, key):
    """Sequential single-site BayesA/B/C sweep (BayesABC.jl:60-80)."""
    n, p = X.shape
    dtype = ycorr.dtype
    inv_vare = 1.0 / vare
    var_eff_v = jnp.broadcast_to(jnp.asarray(var_eff, dtype), (p,))
    pi_c = jnp.clip(pi.astype(dtype), 1e-10, 1.0)
    log_pi = jnp.log(pi_c)
    log_pi_comp = jnp.log1p(-pi_c + 1e-12)
    ku, kz = jax.random.split(key)
    us = jax.random.uniform(ku, (p,), dtype=dtype)
    zs = jax.random.normal(kz, (p,), dtype=dtype)

    def step(carry, j):
        alpha, beta, delta, ycorr = carry
        x = jax.lax.dynamic_slice(X, (0, j), (n, 1))[:, 0]
        xw = x if rinv is None else x * rinv
        a_j = alpha[j]
        a_new, b_new, d_new = _abc_update(
            jnp.dot(xw, ycorr)[None], a_j[None], xpx[j][None], inv_vare,
            var_eff_v[j][None], log_pi[j][None], log_pi_comp[j][None],
            us[j][None], zs[j][None],
        )
        ycorr = ycorr + (a_j - a_new[0]) * x
        return (alpha.at[j].set(a_new[0]), beta.at[j].set(b_new[0]),
                delta.at[j].set(d_new[0]), ycorr), None

    (alpha, beta, delta, ycorr), _ = jax.lax.scan(
        step, (alpha, beta, delta, ycorr), jnp.arange(p)
    )
    return alpha, beta, delta, ycorr


@jax.jit
def sweep_exact_c0l(X, xpx, alpha, ycorr, rinv, vare, var_eff, gamma_arr, key):
    """Sequential single-site RR-BLUP / BayesL sweep (BayesC0L.jl:25-47)."""
    n, p = X.shape
    dtype = ycorr.dtype
    lam = ((vare / var_eff) / gamma_arr).astype(dtype)
    zs = jax.random.normal(key, (p,), dtype=dtype)
    ones = jnp.ones((1,), dtype)

    def step(carry, j):
        alpha, ycorr = carry
        x = jax.lax.dynamic_slice(X, (0, j), (n, 1))[:, 0]
        xw = x if rinv is None else x * rinv
        a_j = alpha[j]
        a_new = _c0l_update(
            jnp.dot(xw, ycorr)[None], a_j[None], xpx[j][None], vare,
            lam[j][None], zs[j][None], ones,
        )[0]
        ycorr = ycorr + (a_j - a_new) * x
        return (alpha.at[j].set(a_new), ycorr), None

    (alpha, ycorr), _ = jax.lax.scan(step, (alpha, ycorr), jnp.arange(p))
    return alpha, ycorr


@jax.jit
def sweep_exact_bayesr(X, xpx, alpha, delta, ycorr, rinv, vare, sigma_sq, pi, key):
    """Sequential single-site BayesR sweep (BayesR.jl:45-97). pi: (p, 4)."""
    n, p = X.shape
    dtype = ycorr.dtype
    inv_vare = 1.0 / vare
    log_pi = jnp.log(jnp.clip(pi.astype(dtype), 1e-12, 1.0))
    kg, kz = jax.random.split(key)
    gum = jax.random.gumbel(kg, (p, 4), dtype=dtype)
    zs = jax.random.normal(kz, (p,), dtype=dtype)

    def step(carry, j):
        alpha, delta, ycorr = carry
        x = jax.lax.dynamic_slice(X, (0, j), (n, 1))[:, 0]
        xw = x if rinv is None else x * rinv
        a_j = alpha[j]
        a_new, k_new = _bayesr_update(
            jnp.dot(xw, ycorr)[None], a_j[None], xpx[j][None], inv_vare,
            sigma_sq, log_pi[j][None, :], gum[j][None, :], zs[j][None],
        )
        ycorr = ycorr + (a_j - a_new[0]) * x
        return (alpha.at[j].set(a_new[0]), delta.at[j].set(k_new[0]), ycorr), None

    (alpha, delta, ycorr), _ = jax.lax.scan(step, (alpha, delta, ycorr), jnp.arange(p))
    return alpha, delta, ycorr


# ---------------------------------------------------------------------------
# GBLUP on the eigen-basis (GBLUP.jl:43-49): with orthogonal L the update of
# all pseudo-marker effects is a single vectorized draw, no sequential chain.
# ---------------------------------------------------------------------------


@jax.jit
def sweep_gblup(L, D, alpha, ycorr, rinv, vare, var_a, key):
    """GBLUP pseudo-marker update: y = mu + L alpha, var(alpha_i) = D_i var_a."""
    dtype = ycorr.dtype
    rv = jnp.ones_like(ycorr) if rinv is None else rinv
    ycorr = ycorr + fdot(L, alpha)
    lhs = rv + vare / (var_a * D)
    mean = fdot(L.T, rv * ycorr) / lhs
    z = jax.random.normal(key, alpha.shape, dtype=dtype)
    alpha_new = mean + z * jnp.sqrt(vare / lhs)
    ycorr = ycorr - fdot(L, alpha_new)
    return alpha_new, ycorr


# ---------------------------------------------------------------------------
# Group-sequential schedule for DENSE blocked sweeps.
#
# The flat blocked sweeps above advance ALL nblocks in parallel per sync
# round — independent-blocks semantics with a stale set of all p markers.
# That is metastable at p >> n (measured boundary: diverges at stale/n >= 1
# even with shallow schedules; benchmarks/results/stability_sweep_r05.md).
# The packed/out-of-core path solved this with the grouped store
# (ops/grouped.py); this wrapper brings the same schedule to dense
# MarkerBlocks: groups of blocks are visited SEQUENTIALLY (group g+1
# sees the residual updated by group g), so the parallel-stale set per sync
# round is b * group_blocks, capped by grouped.STALE_FRACTION.
# ---------------------------------------------------------------------------


def grouped_dense_sweep(call_group, md: MarkerBlocks, states, ycorr, key,
                        group_blocks: int):
    """Walk groups of blocks of a dense MarkerBlocks sequentially.

    call_group(md_g, states_g, ycorr, g, key_g) -> (states_g_out, ycorr):
    runs the flat blocked sweep on one group's sub-MarkerBlocks. `states` is
    a tuple of arrays whose LAST axis is the marker axis (p_pad = b*nblocks);
    leading axes (e.g. traits) pass through. group_blocks must divide
    nblocks. Key convention: group g gets fold_in(key, g), so a single-group
    call reproduces the flat sweep invoked with fold_in(key, 0)."""
    b, _, nblocks = md.grams.shape
    gb = int(group_blocks)
    if nblocks % gb:
        raise ValueError(f"group_blocks {gb} must divide nblocks {nblocks}")
    ngroups = nblocks // gb
    G = b * gb
    n = md.X.shape[0]

    def slice_p(x, g):
        start = (0,) * (x.ndim - 1) + (g * G,)
        return jax.lax.dynamic_slice(x, start, x.shape[:-1] + (G,))

    def body(carry, g):
        states_c, yc = carry
        md_g = MarkerBlocks(
            jax.lax.dynamic_slice(md.X, (0, g * G), (n, G)),
            slice_p(md.xpx, g),
            jax.lax.dynamic_slice(md.grams, (0, 0, g * gb), (b, b, gb)),
            slice_p(md.valid, g),
        )
        states_g = tuple(slice_p(s, g) for s in states_c)
        out_states, yc = call_group(md_g, states_g, yc, g,
                                    jax.random.fold_in(key, g))
        new_states = tuple(
            jax.lax.dynamic_update_slice(s, o.astype(s.dtype),
                                         (0,) * (s.ndim - 1) + (g * G,))
            for s, o in zip(states_c, out_states)
        )
        return (new_states, yc), None

    (states, ycorr), _ = jax.lax.scan(body, (tuple(states), ycorr),
                                      jnp.arange(ngroups))
    return states, ycorr


def stable_group_blocks(n_obs: int, b: int, nblocks: int) -> int:
    """Largest group of blocks (preferring multiples of 128, the geometry
    the schedule was tuned at) whose stale set b*gb honors
    grouped.STALE_FRACTION * n; 0 = flat sweep is fine."""
    from jwas_tpu.ops.grouped import STALE_FRACTION, pick_group_blocks

    cap = max(1, int(STALE_FRACTION * n_obs) // b)
    if nblocks <= cap:
        return 0
    return pick_group_blocks(nblocks, prefer=128, cap=cap)
