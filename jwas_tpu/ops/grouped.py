"""Group-streamed 2-bit packed sweeps, device-resident or out of core.

Device-side re-design of the reference's out-of-core decode loop (reference:
src/1.JWAS/src/markers/streaming_genotypes.jl:978-1027 and the block driver
BayesABC.jl:111-188). The packed store is shaped (ngroups, G, bpm) and lives
in device memory or, out of core, in PINNED HOST memory; one jitted
`lax.scan` walks marker groups **sequentially** (group g+1 sees the residual
updated by group g — the reference's sequential-exact block schedule),
staging each group's packed rows into device memory exactly once per outer
iteration:

  per group: host-to-device copy of (G, bpm) rows    <- 1 store pass / iter
             rhs_g   = X_g' R^-1 ycorr                 (decode-fused tiles)
             inner rounds on the group's Gram tiles    (GPU kernel / XLA)
             ycorr  += X_g (alpha_old - alpha_new)     (same resident tile)

Memory-space mechanics: the store array carries memory_kind="pinned_host";
inside jit a `jax.lax.dynamic_slice` of the host operand followed by
`jax.device_put(..., jax.memory.Space.Device)` lowers to an asynchronous
copy of just that slice, so the store never materializes on the device.
`host_memory_supported()` probes whether the backend can do this.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from jwas_tpu.ops import markers as mk
from jwas_tpu.ops.packed import decode_tile
from jwas_tpu.utils.backend import device_memory_bytes

try:  # jax >= 0.9 memory-space API
    from jax.memory import Space as _Space
except ImportError:  # pragma: no cover - older jax
    _Space = None


class GroupedPackedMarkers(NamedTuple):
    """All-array pytree for the grouped store. Static sizes from shapes:
    ngroups, G (markers per group), bpm = store.shape; b = grams.shape[0];
    group_blocks = G // b."""

    store: jnp.ndarray      # (ngroups, G, bpm) uint8, pinned_host or device
    means: jnp.ndarray      # (p_pad,) f32 (device)
    row_perm: Optional[jnp.ndarray]  # (n_obs,) int32 or None (identity)
    xpx: jnp.ndarray        # (p_pad,) diag X'R^-1 X
    grams: jnp.ndarray      # (b, b, nblocks) j-major Gram tiles (device)
    valid: jnp.ndarray      # (p_pad,)
    # hybrid out-of-core: device-resident copy of the FIRST k groups (spare
    # device memory soaks up part of the store; only groups >= k stream).
    # None = no hybrid split. Groups are indexed globally either way.
    dev_store: Optional[jnp.ndarray] = None   # (k, G, bpm) uint8 on device


@lru_cache(maxsize=None)
def host_memory_supported() -> bool:
    """True when the default device has a pinned_host memory space AND
    jitted programs can move data between it and device memory in both
    directions. Probed once per process with tiny programs: the CPU backend
    advertises the space but has no implementation of the device-to-host
    placement inside jit."""
    if _Space is None:
        return False
    dev = jax.devices()[0]
    if not any(m.kind == "pinned_host" for m in dev.addressable_memories()):
        return False
    host = pinned_host_sharding(dev)

    def row(s, i):
        # the sweeps' own pattern: slice the host array, stage the slice
        return _stage(jax.lax.dynamic_slice_in_dim(s, i, 1)[0], True)

    try:
        x = jax.device_put(jnp.arange(8, dtype=jnp.int32).reshape(2, 4), host)
        got = jax.jit(lambda s: jnp.sum(row(s, 1)))(x)
        back = jax.jit(lambda s: jax.device_put(row(s, 0) * 2, _Space.Host),
                       out_shardings=host)(x)
        return int(got) == 22 and int(np.asarray(back).sum()) == 12
    except Exception:  # noqa: BLE001 - any failure means "cannot stage"
        return False


def pinned_host_sharding(device=None):
    dev = device if device is not None else jax.devices()[0]
    return jax.sharding.SingleDeviceSharding(dev, memory_kind="pinned_host")


def _stage(x, host_store: bool):
    """Move a sliced host chunk into device memory (an asynchronous copy
    under XLA's memory-space model); identity for a device-resident store."""
    if host_store:
        return jax.device_put(x, _Space.Device)
    return x


def to_host_memory(x):
    """Offload an array to pinned host memory of the device that holds it
    (no-op without support)."""
    if host_memory_supported():
        dev = next(iter(x.devices())) if hasattr(x, "devices") else None
        return jax.device_put(x, pinned_host_sharding(dev))
    return x


# Stability bound for the parallel-block inner rounds: within a group, all
# b*group_blocks markers update against a shared (per-sync-round) residual —
# independent-blocks semantics (BayesABC.jl:190-255). The parallel update is
# a regularized Jacobi step whose coupling radius grows with the stale-set
# aspect ratio q = G/n AND the schedule depth (consecutive sync rounds per
# group visit). Measured boundaries (benchmarks/stability_sweep.py; table
# committed at benchmarks/results/stability_sweep_r05.md, 2048-sweep
# synthetic chains): with shallow visits (2x8-rep rounds) divergence starts at
# q >= 1.0 (stale set >= n: more simultaneously-updated coordinates than
# data constraints); at the production schedule (4x32-rep rounds,
# nreps = block = 128) the boundary drops to between q = 0.40 (stable,
# EBV acc 0.975) and q = 0.67 (diverges). The cap 0.4 n therefore sits at
# the stable edge of the deepest schedule the engine ships; real-genotype
# LD strengthens cross-block coupling vs the synthetic, so the cap is not
# relaxed. pick_stable_blocks keeps 128 blocks per group by shrinking b (the
# geometry the schedule was tuned at; retuning it is a statistical change).
STALE_FRACTION = 0.4


def pick_stable_blocks(n_obs: int, block_size: int, p: int,
                       warn: bool = True):
    """Choose (block_size, group_blocks) with b * gb <= STALE_FRACTION * n.

    Prefers gb = 128, shrinking b in multiples of 8 to honor the cap; for
    small n (or small p) falls back to smaller groups. The cap is NOT
    floored at 64: for n < 160 a 64-marker stale set already reaches the
    measured q ~ 0.66 divergence threshold (SCALING.md), so tiny problems
    degrade to b=8, gb=1 instead.

    When the stability cap forces a block size different from the user's
    request a warning is emitted — the reference honors the requested
    fast_blocks size verbatim (JWAS.jl:293-316), so a silent change would
    alter chain-length accounting semantics underfoot."""
    req = max(8, (int(block_size) // 8) * 8)
    cap = min(max(8, int(STALE_FRACTION * n_obs)), max(p, 8))
    b = max(8, (min(int(block_size), max(cap, 8)) // 8) * 8)
    out = None
    if -(-p // b) >= 128:
        if b * 128 > cap:
            b = (cap // 128) // 8 * 8
        if b >= 8 and -(-p // b) >= 128:
            out = (b, 128)
        else:
            b = 8
    if out is None:
        gb = min(-(-p // b), max(1, cap // b))
        while b > 8 and b * gb > cap:
            b = max(8, b - 8)
            gb = min(-(-p // b), max(1, cap // b))
        out = (b, gb)
    if warn and out[0] != req:
        import warnings

        warnings.warn(
            f"fast_blocks size {block_size} exceeds the parallel-update "
            f"stability cap (b*group_blocks <= {STALE_FRACTION}*n = "
            f"{STALE_FRACTION * n_obs:.0f}; see SCALING.md): using "
            f"block_size={out[0]}, group_blocks={out[1]}. Effective inner "
            f"sweeps per outer iteration follow the adjusted size."
        )
    return out


def plan_device_groups(ngroups: int, G: int, bpm: int, grams_bytes: int,
                       budget: Optional[int] = None,
                       cushion: int = 7 << 29, device=None) -> int:
    """Hybrid out-of-core split: how many leading groups fit in spare
    device memory.

    budget defaults to the memory budget of `device`
    (utils/backend.device_memory_bytes); cushion reserves room for the chain
    state, staged tiles, random draws, and compiler scratch (3.5 GB)."""
    if budget is None:
        budget = device_memory_bytes(device)
    free = budget - int(grams_bytes) - cushion
    per_group = G * bpm
    if per_group <= 0 or free <= 0:
        return 0
    return max(0, min(ngroups, free // per_group))


@partial(jax.jit, static_argnames=("k",))
def _hybrid_copy(store, k: int):
    """Stage the leading k groups of a grouped store into device memory.

    The store is a TRACED jit argument — exactly like `grouped_stats` —
    never a closure: closing over a pinned-host array captures the FULL
    store as a lowering constant (26 GB at the north-star shape), which
    both defeats the out-of-core design and stalls compilation
    (regression guarded by tests/test_grouped.py's lowering-constant
    check, which traces this function on CPU)."""
    _, G, bpm = store.shape

    def body(_, g):
        rows = _stage(
            jax.lax.dynamic_slice(store, (g, 0, 0), (1, G, bpm))[0], True
        )
        return None, rows

    _, dev = jax.lax.scan(body, None, jnp.arange(k))
    return dev


def hybridize(gm: GroupedPackedMarkers,
              budget: Optional[int] = None) -> GroupedPackedMarkers:
    """Fill spare device memory with the leading groups of a host-resident
    grouped store (host-to-device traffic then only covers the remainder).
    No-op when the store is already device-resident or nothing fits.

    The copy stages group by group INSIDE jit (dynamic_slice + device_put:
    the same lowering as the sweeps' `_stage`); general jnp ops on
    pinned-host operands (e.g. `store[:k]`) are not lowered reliably."""
    if gm.dev_store is not None:
        return gm
    if getattr(gm.store, "sharding", None) is None or (
        gm.store.sharding.memory_kind != "pinned_host"
    ):
        return gm
    ngroups, G, bpm = gm.store.shape
    k = plan_device_groups(ngroups, G, bpm, gm.grams.size * 4, budget=budget,
                           device=next(iter(gm.store.devices())))
    if k <= 0:
        return gm
    return gm._replace(dev_store=_hybrid_copy(gm.store, k=k))


def pick_group_blocks(nblocks: int, prefer: int = 128, cap: int = 256) -> int:
    """Blocks per group: a divisor of nblocks, preferring multiples of
    `prefer` up to `cap`; falls back to the largest divisor <= cap, then to
    nblocks itself."""
    best = 0
    for gb in range(min(cap, nblocks), 0, -1):
        if nblocks % gb:
            continue
        if gb % prefer == 0:
            return gb
        if best == 0:
            best = gb
    return best or nblocks


def _sub_chunk(G: int, b: int, n_obs: int, budget_bytes: int = 1 << 28) -> int:
    """Markers per decode sub-chunk: bound the (n, sc) f32 tile to ~budget,
    keep sc a divisor of G and a multiple of b."""
    sc = max(b, min(G, (budget_bytes // max(4 * n_obs, 1)) // b * b))
    while G % sc:
        sc -= b
    return max(b, sc)


def _sub_chunk_planes(G: int, b: int, bpm: int,
                      budget_bytes: int = 1 << 28) -> int:
    """Markers per plane sub-chunk: bound one (sc, bpm) f32 plane to
    ~budget, sc a divisor of G and a multiple of b."""
    sc = max(b, min(G, (budget_bytes // max(4 * bpm, 1)) // b * b))
    while G % sc:
        sc -= b
    return max(b, sc)


# ---------------------------------------------------------------------------
# Plane-decomposed GEMVs: the 2-bit store packs 4 observations per byte; the
# reductions over observations are order-free, so instead of decoding to the
# interleaved (n, chunk) layout (shift+and+reshape+compare+select+sub+
# transpose per code), each of the four bit-planes is used AS IS:
#     X' w = sum_j C_j @ w[j::4]  - m (1'w)  [+ (m-3) (M_j @ w[j::4]) missing]
#     X v  interleave(C_j' v)     - 1 (m'v)  [+ ...]
# where C_j = (packed >> 2j) & 3 is a (chunk, bpm) integer plane: three
# elementwise ops per code (shift, and, convert) feeding matrix-vector
# products; the mean centering and missing->mean imputation become rank-1 /
# masked corrections.
# ---------------------------------------------------------------------------


def _pad_w(w, bpm: int, row_perm):
    """Observation vector -> store-order (4*bpm,) plane source."""
    n_pad = 4 * bpm
    if row_perm is None:
        return jnp.zeros((n_pad,), w.dtype).at[: w.shape[0]].set(w)
    return jnp.zeros((n_pad,), w.dtype).at[row_perm].add(w)


def _plane_rhs(rows, mns, w_pad, has_missing: bool):
    """X_chunk' w from bit planes; w_pad is store-ordered (4*bpm,)."""
    dtype = w_pad.dtype
    w4 = w_pad.reshape(-1, 4)                      # (bpm, 4)
    w_sum = jnp.sum(w_pad)
    acc = None
    miss = None
    for j in range(4):
        Cj = ((rows >> jnp.uint8(2 * j)) & jnp.uint8(3)).astype(dtype)
        part = mk.fdot(Cj, w4[:, j])
        acc = part if acc is None else acc + part
        if has_missing:
            Mj = (Cj == 3.0).astype(dtype)
            mp = mk.fdot(Mj, w4[:, j])
            miss = mp if miss is None else miss + mp
    rhs = acc - mns * w_sum
    if has_missing:
        rhs = rhs + (mns - 3.0) * miss
    return rhs


def _plane_matvec(rows, mns, v, n_obs: int, row_perm, has_missing: bool):
    """X_chunk @ v from bit planes -> (n_obs,) observation order."""
    dtype = v.dtype
    mv = jnp.dot(mns, v)
    planes = []
    for j in range(4):
        Cj = ((rows >> jnp.uint8(2 * j)) & jnp.uint8(3)).astype(dtype)
        part = mk.fdot(Cj.T, v)                     # (bpm,)
        if has_missing:
            Mj = (Cj == 3.0).astype(dtype)
            part = part + mk.fdot(Mj.T, (mns - 3.0) * v)
        planes.append(part)
    out_pad = jnp.stack(planes, axis=1).reshape(-1) - mv   # (4*bpm,)
    if row_perm is None:
        return out_pad[:n_obs]
    return out_pad[row_perm]


def _tile_rhs_planes(rows, mns, w_pad, sc: int, has_missing: bool):
    G = rows.shape[0]
    if sc >= G:
        return _plane_rhs(rows, mns, w_pad, has_missing)
    nch = G // sc

    def body(_, k):
        r = jax.lax.dynamic_slice(rows, (k * sc, 0), (sc, rows.shape[1]))
        m = jax.lax.dynamic_slice(mns, (k * sc,), (sc,))
        return None, _plane_rhs(r, m, w_pad, has_missing)

    _, parts = jax.lax.scan(body, None, jnp.arange(nch))
    return parts.reshape(-1)


def _tile_matvec_planes(rows, mns, v, n_obs: int, row_perm, sc: int,
                        has_missing: bool):
    G = rows.shape[0]
    if sc >= G:
        return _plane_matvec(rows, mns, v, n_obs, row_perm, has_missing)
    nch = G // sc
    bpm = rows.shape[1]

    def body(acc, k):
        r = jax.lax.dynamic_slice(rows, (k * sc, 0), (sc, bpm))
        m = jax.lax.dynamic_slice(mns, (k * sc,), (sc,))
        vs = jax.lax.dynamic_slice(v, (k * sc,), (sc,))
        # accumulate in store order; permute once at the end
        return acc + _plane_matvec(r, m, vs, 4 * bpm, None, has_missing), None

    acc, _ = jax.lax.scan(body, jnp.zeros((4 * bpm,), v.dtype),
                          jnp.arange(nch))
    if row_perm is None:
        return acc[:n_obs]
    return acc[row_perm]


def _tile_rhs(rows, mns, row_perm, w, n_obs: int, sc: int):
    """X_g' w over one resident packed group tile, decoded in sub-chunks."""
    G = rows.shape[0]
    if sc >= G:
        X = decode_tile(rows, mns, row_perm, w.dtype, n_obs=n_obs)
        return mk.fdot(X.T, w)
    nch = G // sc

    def body(_, k):
        r = jax.lax.dynamic_slice(rows, (k * sc, 0), (sc, rows.shape[1]))
        m = jax.lax.dynamic_slice(mns, (k * sc,), (sc,))
        X = decode_tile(r, m, row_perm, w.dtype, n_obs=n_obs)
        return None, mk.fdot(X.T, w)

    _, parts = jax.lax.scan(body, None, jnp.arange(nch))
    return parts.reshape(-1)


def _tile_matvec(rows, mns, row_perm, v, n_obs: int, sc: int):
    """X_g @ v over one resident packed group tile, decoded in sub-chunks."""
    G = rows.shape[0]
    if sc >= G:
        X = decode_tile(rows, mns, row_perm, v.dtype, n_obs=n_obs)
        return mk.fdot(X, v)
    nch = G // sc

    def body(acc, k):
        r = jax.lax.dynamic_slice(rows, (k * sc, 0), (sc, rows.shape[1]))
        m = jax.lax.dynamic_slice(mns, (k * sc,), (sc,))
        vs = jax.lax.dynamic_slice(v, (k * sc,), (sc,))
        X = decode_tile(r, m, row_perm, v.dtype, n_obs=n_obs)
        return acc + mk.fdot(X, vs), None

    acc, _ = jax.lax.scan(body, jnp.zeros((n_obs,), v.dtype), jnp.arange(nch))
    return acc


@partial(jax.jit, static_argnames=("n_obs", "host_store", "has_missing"))
def grouped_matvec(gm: GroupedPackedMarkers, v, n_obs: int,
                   host_store: bool = False, has_missing: bool = True):
    """X @ v over the whole grouped store (one streaming pass)."""
    ngroups, G, bpm = gm.store.shape
    b = gm.grams.shape[0]
    sc = _sub_chunk_planes(G, b, bpm)

    def body(acc, g):
        rows = _stage(
            jax.lax.dynamic_slice(gm.store, (g, 0, 0), (1,) + gm.store.shape[1:])[0],
            host_store,
        )
        mns = jax.lax.dynamic_slice(gm.means, (g * G,), (G,))
        vs = jax.lax.dynamic_slice(v, (g * G,), (G,))
        return acc + _tile_matvec_planes(rows, mns, vs, 4 * bpm, None, sc,
                                         has_missing), None

    acc, _ = jax.lax.scan(body, jnp.zeros((4 * bpm,), v.dtype),
                          jnp.arange(ngroups))
    if gm.row_perm is None:
        return acc[:n_obs]
    return acc[gm.row_perm]


@partial(jax.jit, static_argnames=("host_store", "has_missing"))
def grouped_rhs(gm: GroupedPackedMarkers, w, host_store: bool = False,
                has_missing: bool = True):
    """X' w over the whole grouped store (one streaming pass)."""
    ngroups, G, bpm = gm.store.shape
    b = gm.grams.shape[0]
    sc = _sub_chunk_planes(G, b, bpm)
    w_pad = _pad_w(w, bpm, gm.row_perm)

    def body(_, g):
        rows = _stage(
            jax.lax.dynamic_slice(gm.store, (g, 0, 0), (1,) + gm.store.shape[1:])[0],
            host_store,
        )
        mns = jax.lax.dynamic_slice(gm.means, (g * G,), (G,))
        return None, _tile_rhs_planes(rows, mns, w_pad, sc, has_missing)

    _, parts = jax.lax.scan(body, None, jnp.arange(ngroups))
    return parts.reshape(-1)


@partial(jax.jit, static_argnames=("nreps", "sync_every", "host_store",
                                   "use_pallas", "interpret", "use_planes",
                                   "has_missing", "prefetch"))
def sweep_blocks_abc_grouped(gm: GroupedPackedMarkers, alpha, beta, delta,
                             ycorr, rinv, vare, var_eff, pi, key,
                             nreps: int = 1, sync_every=None,
                             host_store: bool = False,
                             use_pallas: bool = False,
                             interpret: bool = False,
                             use_planes: bool = True,
                             has_missing: bool = True,
                             prefetch: bool = False):
    """Group-sequential fast-blocks BayesA/B/C sweep over the grouped store.

    Identical per-marker math to sweep_blocks_abc_packed (BayesABC block
    path, BayesABC.jl:111-188); the schedule walks groups sequentially
    (exact across groups) with `nreps` inner reps per group split into
    sync_every-rep rounds (staleness bounded WITHIN a group). Per-group RNG
    keys are fold_in(key, g), then the shared _sync_rounds fold per round —
    so a 1-group store reproduces sweep_blocks_abc_packed's draws when called
    with key = fold_in(key, 0).

    Streaming cost: ONE full-store H2D pass per call (vs 2 passes per sync
    round for the flat host_store mode).
    """
    ngroups, G, bpm = gm.store.shape
    b, _, nblocks = gm.grams.shape
    gb = nblocks // ngroups
    dtype = ycorr.dtype
    n_obs = ycorr.shape[0]
    sc = (_sub_chunk_planes(G, b, bpm) if use_planes
          else _sub_chunk(G, b, n_obs))
    inv_vare = 1.0 / vare

    var_eff_b = mk._to_jmajor(
        jnp.broadcast_to(jnp.asarray(var_eff, dtype), (nblocks * b,)), nblocks, b
    )
    pi_c = jnp.clip(pi.astype(dtype), 1e-10, 1.0)
    log_pi = mk._to_jmajor(jnp.log(pi_c), nblocks, b)
    log_pi_comp = mk._to_jmajor(jnp.log1p(-pi_c + 1e-12), nblocks, b)
    xpx_b = mk._to_jmajor(gm.xpx, nblocks, b)

    n_dev = 0 if gm.dev_store is None else gm.dev_store.shape[0]

    def dev_fetch(g):
        return jax.lax.dynamic_slice(gm.dev_store, (g, 0, 0), (1, G, bpm))[0]

    def host_fetch(g):
        return _stage(
            jax.lax.dynamic_slice(gm.store, (g, 0, 0), (1, G, bpm))[0],
            host_store,
        )

    def group_fn(carry, g, fetch=host_fetch, pre=prefetch):
        if pre:
            # software pipelining: `rows` (group g) was staged by the
            # PREVIOUS iteration; this iteration starts the H2D copy of
            # group g+1 for overlap with the compute below
            alpha_b, beta_b, delta_b, ycorr, rows = carry
            g_next = jnp.minimum(g + 1, ngroups - 1)
            rows_next = fetch(g_next)
        else:
            alpha_b, beta_b, delta_b, ycorr = carry
            rows = fetch(g)
        mns = jax.lax.dynamic_slice(gm.means, (g * G,), (G,))

        lane = lambda x: jax.lax.dynamic_slice(  # noqa: E731
            x, (0, g * gb), (b, gb)
        )
        grams_g = jax.lax.dynamic_slice(gm.grams, (0, 0, g * gb), (b, b, gb))
        xpx_g = lane(xpx_b)
        var_eff_g = lane(var_eff_b)
        log_pi_g = lane(log_pi)
        log_pi_comp_g = lane(log_pi_comp)

        def round_fn(stt, kr, reps):
            a_g, be_g, d_g, yc = stt
            w = yc if rinv is None else rinv * yc
            if use_planes:
                w_pad = _pad_w(w, bpm, gm.row_perm)
                rhs_flat = _tile_rhs_planes(rows, mns, w_pad, sc, has_missing)
            else:
                rhs_flat = _tile_rhs(rows, mns, gm.row_perm, w, n_obs, sc)
            rhs0 = mk._to_jmajor(rhs_flat, gb, b)
            ku, kz = jax.random.split(kr)
            us = jax.random.uniform(ku, (reps * b, gb), dtype=dtype)
            zs = jax.random.normal(kz, (reps * b, gb), dtype=dtype)
            a_start = a_g
            a_g, be_g, d_g, _ = mk.abc_inner_rounds(
                grams_g, xpx_g, var_eff_g, log_pi_g, log_pi_comp_g,
                a_g, be_g, d_g, rhs0, us, zs, inv_vare, use_pallas, interpret,
            )
            d_alpha = mk._from_jmajor(a_start - a_g)
            if use_planes:
                yc = yc + _tile_matvec_planes(rows, mns, d_alpha, n_obs,
                                              gm.row_perm, sc, has_missing)
            else:
                yc = yc + _tile_matvec(rows, mns, gm.row_perm, d_alpha,
                                       n_obs, sc)
            return (a_g, be_g, d_g, yc)

        state_g = (lane(alpha_b), lane(beta_b),
                   jax.lax.dynamic_slice(delta_b, (0, g * gb), (b, gb)), ycorr)
        key_g = jax.random.fold_in(key, g)
        a_g, be_g, d_g, ycorr = mk._sync_rounds(
            nreps, sync_every, key_g, round_fn, state_g
        )
        put = lambda x, v: jax.lax.dynamic_update_slice(  # noqa: E731
            x, v, (0, g * gb)
        )
        out_carry = (put(alpha_b, a_g), put(beta_b, be_g),
                     put(delta_b, d_g), ycorr)
        if pre:
            out_carry = out_carry + (rows_next,)
        return out_carry, None

    carry = (
        mk._to_jmajor(alpha, nblocks, b),
        mk._to_jmajor(beta, nblocks, b),
        mk._to_jmajor(delta, nblocks, b),
        ycorr,
    )
    # hybrid split: groups [0, n_dev) read straight from device memory, the
    # rest stream from the host store (sequential-exact order is preserved)
    if n_dev:
        carry, _ = jax.lax.scan(
            lambda c, g: group_fn(c, g, fetch=dev_fetch, pre=False),
            carry, jnp.arange(n_dev),
        )
    if n_dev < ngroups:
        if prefetch:
            carry = carry + (host_fetch(n_dev),)
        carry, _ = jax.lax.scan(group_fn, carry,
                                jnp.arange(n_dev, ngroups))
    alpha_b, beta_b, delta_b, ycorr = carry[:4]
    return (
        mk._from_jmajor(alpha_b),
        mk._from_jmajor(beta_b),
        mk._from_jmajor(delta_b),
        ycorr,
    )


@partial(jax.jit, static_argnames=("nreps", "sync_every", "host_store",
                                   "use_pallas", "interpret", "use_planes",
                                   "has_missing", "prefetch"))
def sweep_blocks_bayesr_grouped(gm: GroupedPackedMarkers, alpha, delta,
                                ycorr, rinv, vare, sigma_sq, pi, key,
                                nreps: int = 1, sync_every=None,
                                host_store: bool = False,
                                use_pallas: bool = False,
                                interpret: bool = False,
                                use_planes: bool = True,
                                has_missing: bool = True,
                                prefetch: bool = False):
    """Group-sequential fast-blocks BayesR sweep over the grouped store.

    The 4-class mixture update (BayesR.jl:45-97) with the out-of-core
    schedule of sweep_blocks_abc_grouped: groups walk sequentially (exact
    across groups), sync rounds bound staleness within a group, and the
    store streams from pinned host exactly once per call. A capability the
    reference does not have — its streaming backend is single-trait BayesC
    only (input_data_validation.jl:81-111). pi: (p_pad, 4) class priors
    (padded rows [1,0,0,0]); delta: (p_pad,) int32 class labels.
    Key convention matches the ABC grouped sweep: per-group fold_in(key, g).
    """
    ngroups, G, bpm = gm.store.shape
    b, _, nblocks = gm.grams.shape
    gb = nblocks // ngroups
    dtype = ycorr.dtype
    n_obs = ycorr.shape[0]
    sc = (_sub_chunk_planes(G, b, bpm) if use_planes
          else _sub_chunk(G, b, n_obs))
    inv_vare = 1.0 / vare

    log_pi_full = jnp.transpose(
        jnp.log(jnp.clip(pi.astype(dtype), 1e-12, 1.0)).reshape(nblocks, b, 4),
        (1, 0, 2),
    )  # (b, nblocks, 4)
    xpx_b = mk._to_jmajor(gm.xpx, nblocks, b)

    n_dev = 0 if gm.dev_store is None else gm.dev_store.shape[0]

    def dev_fetch(g):
        return jax.lax.dynamic_slice(gm.dev_store, (g, 0, 0), (1, G, bpm))[0]

    def host_fetch(g):
        return _stage(
            jax.lax.dynamic_slice(gm.store, (g, 0, 0), (1, G, bpm))[0],
            host_store,
        )

    def group_fn(carry, g, fetch=host_fetch, pre=prefetch):
        if pre:
            alpha_b, delta_b, ycorr, rows = carry
            g_next = jnp.minimum(g + 1, ngroups - 1)
            rows_next = fetch(g_next)
        else:
            alpha_b, delta_b, ycorr = carry
            rows = fetch(g)
        mns = jax.lax.dynamic_slice(gm.means, (g * G,), (G,))

        grams_g = jax.lax.dynamic_slice(gm.grams, (0, 0, g * gb), (b, b, gb))
        xpx_g = jax.lax.dynamic_slice(xpx_b, (0, g * gb), (b, gb))
        log_pi_g = jax.lax.dynamic_slice(log_pi_full, (0, g * gb, 0),
                                         (b, gb, 4))

        def round_fn(stt, kr, reps):
            a_g, d_g, yc = stt
            w = yc if rinv is None else rinv * yc
            if use_planes:
                w_pad = _pad_w(w, bpm, gm.row_perm)
                rhs_flat = _tile_rhs_planes(rows, mns, w_pad, sc, has_missing)
            else:
                rhs_flat = _tile_rhs(rows, mns, gm.row_perm, w, n_obs, sc)
            rhs0 = mk._to_jmajor(rhs_flat, gb, b)
            kg, kz = jax.random.split(kr)
            a_start = a_g
            a_g, d_g, _ = mk.bayesr_inner_rounds(
                grams_g, xpx_g, log_pi_g, a_g, d_g, rhs0, inv_vare, sigma_sq,
                kg, kz, reps, use_pallas, interpret,
            )
            d_alpha = mk._from_jmajor(a_start - a_g)
            if use_planes:
                yc = yc + _tile_matvec_planes(rows, mns, d_alpha, n_obs,
                                              gm.row_perm, sc, has_missing)
            else:
                yc = yc + _tile_matvec(rows, mns, gm.row_perm, d_alpha,
                                       n_obs, sc)
            return (a_g, d_g, yc)

        state_g = (jax.lax.dynamic_slice(alpha_b, (0, g * gb), (b, gb)),
                   jax.lax.dynamic_slice(delta_b, (0, g * gb), (b, gb)),
                   ycorr)
        key_g = jax.random.fold_in(key, g)
        a_g, d_g, ycorr = mk._sync_rounds(
            nreps, sync_every, key_g, round_fn, state_g
        )
        put = lambda x, v: jax.lax.dynamic_update_slice(  # noqa: E731
            x, v, (0, g * gb)
        )
        out_carry = (put(alpha_b, a_g), put(delta_b, d_g), ycorr)
        if pre:
            out_carry = out_carry + (rows_next,)
        return out_carry, None

    carry = (
        mk._to_jmajor(alpha, nblocks, b),
        mk._to_jmajor(delta, nblocks, b),
        ycorr,
    )
    if n_dev:
        carry, _ = jax.lax.scan(
            lambda c, g: group_fn(c, g, fetch=dev_fetch, pre=False),
            carry, jnp.arange(n_dev),
        )
    if n_dev < ngroups:
        if prefetch:
            carry = carry + (host_fetch(n_dev),)
        carry, _ = jax.lax.scan(group_fn, carry,
                                jnp.arange(n_dev, ngroups))
    alpha_b, delta_b, ycorr = carry[:3]
    return (
        mk._from_jmajor(alpha_b),
        mk._from_jmajor(delta_b),
        ycorr,
    )


# ---------------------------------------------------------------------------
# Builders: grouped store materialization + streamed Gram precompute.
# ---------------------------------------------------------------------------


def materialize_grouped_host(gen_group_fn, ngroups: int, G: int, bpm: int):
    """Build a (ngroups, G, bpm) pinned-host store from a traceable per-group
    generator `gen_group_fn(g) -> (G, bpm) uint8` WITHOUT ever holding the
    full store in device memory: a scan generates each group on device and
    offloads it to host memory as the stacked scan output (the
    activation-offloading pattern; XLA allocates the stacked buffer in pinned host and DMAs each
    chunk). Falls back to plain stacking without host support."""
    offload = host_memory_supported() and _Space is not None

    def gen_all():
        def body(_, g):
            c = gen_group_fn(g)
            if offload:
                c = jax.device_put(c, _Space.Host)
            return None, c

        _, ys = jax.lax.scan(body, None, jnp.arange(ngroups))
        return ys

    if offload:
        return jax.jit(gen_all, out_shardings=pinned_host_sharding())()
    return jax.jit(gen_all)()


def grouped_store_from_numpy(packed_np, ngroups: int, host: bool = True):
    """Reshape a host (p_pad, bpm) packed matrix into (ngroups, G, bpm) and
    place it in pinned host memory (device memory when host=False or
    unsupported). The numpy->pinned_host transfer never touches the device."""
    p_pad, bpm = packed_np.shape
    assert p_pad % ngroups == 0
    arr = packed_np.reshape(ngroups, p_pad // ngroups, bpm)
    if host and host_memory_supported():
        return jax.device_put(arr, pinned_host_sharding())
    return jnp.asarray(arr)


@partial(jax.jit, static_argnames=("b", "n_obs", "host_store", "exact_bf16",
                                   "budget"))
def grouped_stats(store, means, valid, row_perm, rinv, b: int, n_obs: int,
                  host_store: bool = False, exact_bf16: bool = False,
                  budget: int = 1 << 28):
    """One streaming pass over the grouped store computing the fast-blocks
    Gram tiles (j-major (b, b, nblocks)) and xpx (GibbsMats analogue,
    tools4genotypes.jl:237-275).

    exact_bf16 (unit weights, identity perm, no missing codes only): computes
    X_b'X_b = Z'Z - m s' - s m' + n m m' with the INTEGER code matrix Z in
    bfloat16 with float32 accumulation — exact because products of {0,1,2}
    and their f32 accumulations (< 2^24) are representable.
    The no-missing-codes precondition cannot be checked on the traced store;
    callers must establish it (store_has_missing / the manifest flag) first.
    """
    if exact_bf16 and (rinv is not None or row_perm is not None):
        raise ValueError(
            "grouped_stats(exact_bf16=True) requires unit weights and "
            "identity row order (rinv=None, row_perm=None); use the f32 "
            "decode path (exact_bf16=False) for weighted/permuted stores"
        )
    ngroups, G, bpm = store.shape
    gb = G // b
    dtype = jnp.float32
    sc = _sub_chunk(G, b, n_obs, budget)
    nch = G // sc
    scb = sc // b

    def group_fn(_, g):
        rows_full = _stage(
            jax.lax.dynamic_slice(store, (g, 0, 0), (1, G, bpm))[0], host_store
        )
        mns_full = jax.lax.dynamic_slice(means, (g * G,), (G,))

        def chunk_fn(__, k):
            rows = jax.lax.dynamic_slice(rows_full, (k * sc, 0), (sc, bpm))
            mns = jax.lax.dynamic_slice(mns_full, (k * sc,), (sc,))
            if exact_bf16:
                shifts = jnp.asarray([0, 2, 4, 6], jnp.uint8)
                codes = (rows[:, :, None] >> shifts[None, None, :]) & jnp.uint8(3)
                Z = codes.reshape(sc, -1)[:, :n_obs].astype(jnp.bfloat16).T
                Zr = Z.reshape(n_obs, scb, b)
                zz = jnp.einsum("nij,nir->jri", Zr, Zr,
                                preferred_element_type=dtype)
                s = jnp.sum(Zr.astype(dtype), axis=0)          # (scb, b)
                m = mns.reshape(scb, b)
                # (Z - 1 m')'(Z - 1 m') = Z'Z - m s' - s m' + n m m', j-major
                # [j, r, i] = zz[j,r,i] - m[i,j] s[i,r] - s[i,j] m[i,r]
                #             + n m[i,j] m[i,r]
                mT, sT = m.T, s.T                              # (b, scb)
                g_t = (zz - mT[:, None] * sT[None] - sT[:, None] * mT[None]
                       + n_obs * mT[:, None] * mT[None])
                xpx_c = jnp.einsum("jji->ij", g_t).reshape(-1)
                return None, (g_t, xpx_c)
            X = decode_tile(rows, mns, row_perm, dtype, n_obs=n_obs)
            Xr = X.reshape(n_obs, scb, b)
            Xw = Xr if rinv is None else Xr * rinv[:, None, None]
            g_t = mk.gram_tiles(Xr, Xw)
            xpx_c = jnp.sum(Xw * Xr, axis=0).reshape(-1)
            return None, (g_t, xpx_c)

        _, (g_parts, xpx_parts) = jax.lax.scan(chunk_fn, None, jnp.arange(nch))
        # (nch, b, b, scb) -> (b, b, gb); (nch, sc) -> (G,)
        g_all = jnp.moveaxis(g_parts, 0, 2).reshape(b, b, gb)
        return None, (g_all, xpx_parts.reshape(-1))

    _, (grams_parts, xpx_parts) = jax.lax.scan(group_fn, None, jnp.arange(ngroups))
    grams = jnp.moveaxis(grams_parts, 0, 2).reshape(b, b, ngroups * gb)
    xpx = xpx_parts.reshape(-1)
    xpx = jnp.where(valid > 0, jnp.maximum(xpx, 1e-10), 1.0)
    return grams, xpx


def build_grouped_markers(store, obs_ids, block_size: int, rinv=None,
                          dtype=jnp.float32, group_blocks: int = 0,
                          host: bool = True) -> GroupedPackedMarkers:
    """Stage a host Packed2BitStore into the grouped pinned-host layout and
    precompute Gram tiles with one streaming pass (out-of-core GibbsMats).

    The reference's streaming constraints apply upstream (single-trait
    spike-slab; input_data_validation.jl:81-111)."""
    index = {s: i for i, s in enumerate(store.obs_ids)}
    try:
        perm = np.asarray([index[s] for s in obs_ids], dtype=np.int32)
    except KeyError as e:
        raise ValueError(f"individual {e} has no genotypes") from None
    if len(perm) == store.n_obs and (perm == np.arange(store.n_obs)).all():
        perm = None

    p = store.n_markers
    b = block_size
    nblocks_min = -(-p // b)
    # prefer 128 blocks/group (the tuned geometry; <=1.6% padding at
    # p >= 1M); small problems collapse to a single group. The default is
    # additionally capped by the parallel-update stability bound (see
    # STALE_FRACTION): callers wanting the kernel at small n should shrink
    # b via pick_stable_blocks instead of widening the group.
    cap_gb = max(1, int(STALE_FRACTION * len(obs_ids)) // b)
    gb = group_blocks or max(
        1, min(128 if nblocks_min >= 128 else nblocks_min, cap_gb)
    )
    align = b * gb
    p_pad = -(-p // align) * align
    means_np = np.zeros(p_pad, dtype=np.float32)
    means_np[:p] = store.means
    valid_np = np.zeros(p_pad, dtype=np.float32)
    valid_np[:p] = 1.0

    ngroups = p_pad // align
    bpm = store.bytes_per_marker
    if p_pad == p:
        # aligned: stage the (possibly memmapped) store directly; device_put
        # streams pages into the pinned-host buffer without an in-RAM copy
        arr = grouped_store_from_numpy(store.packed, ngroups, host=host)
    elif host and host_memory_supported():
        # padding needed: stage group by group through a host callback so a
        # memmapped store never materializes a second full in-RAM copy
        # (peak = pinned-host target + one group tile)
        packed_src = store.packed

        def _host_group(g):
            g = int(np.asarray(g))
            out = np.zeros((align, bpm), dtype=np.uint8)
            lo = g * align
            hi = min(lo + align, p)
            out[: hi - lo] = packed_src[lo:hi]
            return out

        def gen_group(g):
            return jax.pure_callback(
                _host_group, jax.ShapeDtypeStruct((align, bpm), jnp.uint8), g
            )

        arr = materialize_grouped_host(gen_group, ngroups, align, bpm)
    else:
        # CPU fallback: one preallocated padded copy (document: mmap only
        # avoids the copy when p is already group-aligned on this backend)
        padded = np.zeros((p_pad, bpm), dtype=np.uint8)
        padded[:p] = store.packed
        arr = grouped_store_from_numpy(padded, ngroups, host=host)
    host_store = arr.sharding.memory_kind == "pinned_host" if hasattr(
        arr, "sharding"
    ) else False
    means = jnp.asarray(means_np)
    valid = jnp.asarray(valid_np, dtype)
    perm_d = None if perm is None else jnp.asarray(perm)
    rinv_d = None if rinv is None else jnp.asarray(rinv, dtype)
    n_obs = len(obs_ids)
    grams, xpx = grouped_stats(
        arr, means, valid, perm_d, rinv_d, b, n_obs, host_store=host_store,
        exact_bf16=False,
    )
    return GroupedPackedMarkers(
        store=arr, means=means, row_perm=perm_d, xpx=xpx, grams=grams,
        valid=valid,
    )


_MISS_LUT = None


def store_has_missing(packed_np) -> bool:
    """Host-side scan: does any byte of the 2-bit store contain code 3
    (missing)? One vectorized LUT pass; decides the static has_missing flag
    for the plane GEMVs."""

    global _MISS_LUT
    if _MISS_LUT is None:
        v = np.arange(256, dtype=np.uint16)
        lut = np.zeros(256, dtype=bool)
        for j in range(4):
            lut |= ((v >> (2 * j)) & 3) == 3
        _MISS_LUT = lut
    flat = np.asarray(packed_np).reshape(-1)
    step = 1 << 26
    for i in range(0, flat.size, step):
        if _MISS_LUT[flat[i : i + step]].any():
            return True
    return False
