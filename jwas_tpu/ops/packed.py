"""Device-side 2-bit packed genotype operations.

Device-side replacement for the reference's decode-one-marker CPU loop
(reference: src/1.JWAS/src/markers/streaming_genotypes.jl:978-1027): the
packed (p, ceil(n/4)) uint8 matrix lives in device memory at 1/16 the dense
f32 footprint; marker tiles are decoded to centered float32 on the fly and fused
into the surrounding GEMVs by XLA, so the blocked Gibbs sweep never holds a
dense X.

Decode: code c in {0,1,2} is the dosage, 3 = missing -> marker mean, then
center by the mean (missing decodes to exactly 0 after centering).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from jwas_tpu.ops import markers as mk


class PackedMarkers(NamedTuple):
    """All-array pytree; static sizes come from shapes (n_obs =
    row_perm.shape[0], p_pad = packed.shape[0])."""

    packed: jnp.ndarray     # (p_pad, bpm) uint8, marker-major
    means: jnp.ndarray      # (p_pad,) f32
    row_perm: jnp.ndarray   # (n_obs,) int32 store-row index per observation
    xpx: jnp.ndarray        # (p_pad,) diag X'R^-1 X
    grams: jnp.ndarray      # (b, b, nblocks) fast-blocks Gram tiles
    valid: jnp.ndarray      # (p_pad,)


def decode_tile(packed_rows, means_rows, row_perm, dtype=jnp.float32,
                n_obs: int = 0):
    """Decode (k, bpm) packed rows -> centered (n_obs, k) float tile.

    row_perm=None is the identity fast path (observations already in store
    order): the permutation gather is skipped and only the first `n_obs`
    decoded columns are kept (the tail is sub-byte padding)."""
    shifts = jnp.asarray([0, 2, 4, 6], jnp.uint8)
    codes = (packed_rows[:, :, None] >> shifts[None, None, :]) & jnp.uint8(3)
    codes = codes.reshape(packed_rows.shape[0], -1)            # (k, 4*bpm)
    x = codes.astype(dtype)
    m = means_rows.astype(dtype)[:, None]
    x = jnp.where(x == 3.0, m, x) - m
    if row_perm is None:
        return x[:, :n_obs].T                                   # (n_obs, k)
    return x[:, row_perm].T                                     # (n_obs, k)


def _pick_chunk(p_pad: int, b: int, target: int = 4096) -> int:
    """Largest multiple of b that divides p_pad and is <= target."""
    nblocks = max(1, p_pad // b)
    k = max(1, min(nblocks, max(1, target // b)))
    while nblocks % k:
        k -= 1
    return k * b


@partial(jax.jit, static_argnames=("chunk", "n_obs"))
def packed_matvec(pm: PackedMarkers, v, chunk: int = 0, n_obs: int = 0):
    """X @ v without densifying X: scan over marker chunks of the packed
    store, decoding each tile on the fly (streaming_mul_alpha!, :1009-1027,
    but tiled and on-device). n_obs is required (static) when
    pm.row_perm is None (identity fast path)."""
    p_pad = pm.packed.shape[0]
    if chunk <= 0:
        chunk = _pick_chunk(p_pad, pm.grams.shape[0])
    nchunks = p_pad // chunk
    dtype = v.dtype
    n = pm.row_perm.shape[0] if pm.row_perm is not None else n_obs

    def body(acc, k):
        rows = jax.lax.dynamic_slice(pm.packed, (k * chunk, 0),
                                     (chunk, pm.packed.shape[1]))
        mns = jax.lax.dynamic_slice(pm.means, (k * chunk,), (chunk,))
        vs = jax.lax.dynamic_slice(v, (k * chunk,), (chunk,))
        X = decode_tile(rows, mns, pm.row_perm, dtype, n_obs=n)
        return acc + mk.fdot(X, vs), None

    acc0 = jnp.zeros((n,), dtype)
    acc, _ = jax.lax.scan(body, acc0, jnp.arange(nchunks))
    return acc


@partial(jax.jit, static_argnames=("chunk",))
def packed_rhs(pm: PackedMarkers, w, chunk: int = 0):
    """X' w over the packed store, tiled (the rhs0 of the blocked sweep)."""
    p_pad = pm.packed.shape[0]
    if chunk <= 0:
        chunk = _pick_chunk(p_pad, pm.grams.shape[0])
    nchunks = p_pad // chunk
    dtype = w.dtype
    n = w.shape[0]

    def body(_, k):
        rows = jax.lax.dynamic_slice(pm.packed, (k * chunk, 0),
                                     (chunk, pm.packed.shape[1]))
        mns = jax.lax.dynamic_slice(pm.means, (k * chunk,), (chunk,))
        X = decode_tile(rows, mns, pm.row_perm, dtype, n_obs=n)
        return None, mk.fdot(X.T, w)

    _, parts = jax.lax.scan(body, None, jnp.arange(nchunks))
    return parts.reshape(-1)


@partial(jax.jit, static_argnames=("nreps", "sync_every", "chunk"))
def sweep_blocks_abc_packed(pm: PackedMarkers, alpha, beta, delta, ycorr,
                            rinv, vare, var_eff, pi, key, nreps: int = 1,
                            sync_every=None, chunk: int = 0):
    """Fast-blocks BayesA/B/C sweep over the packed store.

    Identical math to markers.sweep_blocks_abc (BayesABC block path,
    BayesABC.jl:111-188) — the only difference is that the two O(n*p) GEMVs
    bounding the inner block rounds stream decoded tiles instead of reading a
    dense X. Constraint parity with the reference streaming backend: this is
    the single-trait spike-slab path (input_data_validation.jl:81-111).
    """
    b = pm.grams.shape[0]
    nblocks = pm.grams.shape[2]
    dtype = ycorr.dtype
    inv_vare = 1.0 / vare
    var_eff_b = mk._to_jmajor(
        jnp.broadcast_to(jnp.asarray(var_eff, dtype), (nblocks * b,)), nblocks, b
    )
    pi_c = jnp.clip(pi.astype(dtype), 1e-10, 1.0)
    log_pi = mk._to_jmajor(jnp.log(pi_c), nblocks, b)
    log_pi_comp = mk._to_jmajor(jnp.log1p(-pi_c + 1e-12), nblocks, b)
    xpx_b = mk._to_jmajor(pm.xpx, nblocks, b)

    def round_fn(stt, kr, reps):
        alpha_b, beta_b, delta_b, ycorr = stt
        w = ycorr if rinv is None else rinv * ycorr
        rhs0 = mk._to_jmajor(packed_rhs(pm, w, chunk=chunk), nblocks, b)
        ku, kz = jax.random.split(kr)
        us = jax.random.uniform(ku, (reps * b, nblocks), dtype=dtype)
        zs = jax.random.normal(kz, (reps * b, nblocks), dtype=dtype)
        alpha_start = alpha_b
        alpha_b, beta_b, delta_b, _ = mk.abc_inner_rounds(
            pm.grams, xpx_b, var_eff_b, log_pi, log_pi_comp, alpha_b, beta_b,
            delta_b, rhs0, us, zs, inv_vare,
        )
        ycorr = ycorr + packed_matvec(
            pm, mk._from_jmajor(alpha_start - alpha_b), chunk=chunk,
            n_obs=ycorr.shape[0],
        )
        return (alpha_b, beta_b, delta_b, ycorr)

    alpha_b, beta_b, delta_b, ycorr = mk._sync_rounds(
        nreps, sync_every, key, round_fn,
        (mk._to_jmajor(alpha, nblocks, b), mk._to_jmajor(beta, nblocks, b),
         mk._to_jmajor(delta, nblocks, b), ycorr),
    )
    return (
        mk._from_jmajor(alpha_b),
        mk._from_jmajor(beta_b),
        mk._from_jmajor(delta_b),
        ycorr,
    )


@partial(jax.jit, static_argnames=("nreps", "sync_every", "chunk"))
def sweep_blocks_bayesr_packed(pm: PackedMarkers, alpha, delta, ycorr,
                               rinv, vare, sigma_sq, pi, key, nreps: int = 1,
                               sync_every=None, chunk: int = 0):
    """Fast-blocks BayesR 4-class sweep over the packed store.

    Identical math to markers.sweep_blocks_bayesr (BayesR.jl:99-193) with the
    O(n*p) sync GEMVs streaming decoded tiles from the 2-bit store — the
    configuration the reference cannot run (its streaming backend is
    BayesC-only, input_data_validation.jl:81-111). pi: (p_pad, 4) class
    priors (padded rows [1,0,0,0]); delta: (p_pad,) int32 class labels.
    """
    b = pm.grams.shape[0]
    nblocks = pm.grams.shape[2]
    dtype = ycorr.dtype
    inv_vare = 1.0 / vare
    log_pi = jnp.transpose(
        jnp.log(jnp.clip(pi.astype(dtype), 1e-12, 1.0)).reshape(nblocks, b, 4),
        (1, 0, 2),
    )  # (b, nblocks, 4)
    xpx_b = mk._to_jmajor(pm.xpx, nblocks, b)

    def round_fn(stt, kr, reps):
        alpha_b, delta_b, ycorr = stt
        w = ycorr if rinv is None else rinv * ycorr
        rhs0 = mk._to_jmajor(packed_rhs(pm, w, chunk=chunk), nblocks, b)
        kg, kz = jax.random.split(kr)
        alpha_start = alpha_b
        alpha_b, delta_b, _ = mk.bayesr_inner_rounds(
            pm.grams, xpx_b, log_pi, alpha_b, delta_b, rhs0, inv_vare,
            sigma_sq, kg, kz, reps,
        )
        ycorr = ycorr + packed_matvec(
            pm, mk._from_jmajor(alpha_start - alpha_b), chunk=chunk,
            n_obs=ycorr.shape[0],
        )
        return (alpha_b, delta_b, ycorr)

    alpha_b, delta_b, ycorr = mk._sync_rounds(
        nreps, sync_every, key, round_fn,
        (mk._to_jmajor(alpha, nblocks, b), mk._to_jmajor(delta, nblocks, b),
         ycorr),
    )
    return (
        mk._from_jmajor(alpha_b),
        mk._from_jmajor(delta_b),
        ycorr,
    )


def packed_markers_from_arrays(packed, means, valid, row_perm, n_obs: int,
                               block_size: int, rinv=None, dtype=jnp.float32,
                               gram_chunk: int = 8) -> PackedMarkers:
    """Device-side PackedMarkers constructor: precompute the fast-blocks Gram
    tiles + xpx from decoded tiles (GibbsMats analogue,
    tools4genotypes.jl:237-275). packed (p_pad, bpm) uint8 / means (p_pad,) /
    valid (p_pad,) may already live on device; row_perm=None is the identity
    fast path (observations in store order)."""
    b = block_size
    p_pad = packed.shape[0]
    assert p_pad % b == 0
    nblocks = p_pad // b
    packed = jnp.asarray(packed)
    means = jnp.asarray(means)
    valid = jnp.asarray(valid)
    rinv_d = None if rinv is None else jnp.asarray(rinv, dtype)
    row_perm_d = None if row_perm is None else jnp.asarray(row_perm)

    # packed/means enter as jit ARGUMENTS: a closure capture would bake the
    # multi-GB packed store into the executable as a lowering constant
    @partial(jax.jit, static_argnames=("nblk",))
    def gram_group(packed_a, means_a, rp, rv, k0, nblk):
        rows = jax.lax.dynamic_slice(
            packed_a, (k0 * b, 0), (nblk * b, packed_a.shape[1])
        )
        mns = jax.lax.dynamic_slice(means_a, (k0 * b,), (nblk * b,))
        X = decode_tile(rows, mns, rp, dtype, n_obs=n_obs)   # (n, nblk*b)
        Xb = X.reshape(n_obs, nblk, b)
        Xw = Xb if rv is None else Xb * rv[:, None, None]
        g = mk.gram_tiles(Xb, Xw)                            # (b, b, nblk)
        xpx = jnp.sum(Xw * Xb, axis=0).reshape(-1)
        return g, xpx

    grams_parts, xpx_parts = [], []
    for k0 in range(0, nblocks, gram_chunk):
        nblk = min(gram_chunk, nblocks - k0)
        g, xpx = gram_group(packed, means, row_perm_d, rinv_d, k0, nblk)
        grams_parts.append(g)
        xpx_parts.append(xpx)
    grams = jnp.concatenate(grams_parts, axis=2)
    xpx = jnp.concatenate(xpx_parts)
    xpx = jnp.where(valid > 0, jnp.maximum(xpx, 1e-10), 1.0)

    return PackedMarkers(
        packed=packed, means=means, row_perm=row_perm_d,
        xpx=xpx, grams=grams, valid=valid,
    )


def build_packed_markers(store, obs_ids, block_size: int, rinv=None,
                         dtype=jnp.float32, gram_chunk: int = 8,
                         mesh=None, marker_axis: str = "marker") -> PackedMarkers:
    """Stage a host Packed2BitStore on device and precompute the fast-blocks
    Gram tiles from decoded tiles (GibbsMats analogue, tools4genotypes.jl:237-275).

    obs_ids selects/permutes store rows to the phenotype order (row gather on
    device after decode — packed bits are never repacked). An identity
    permutation is detected and elided.

    When `mesh` has a `marker_axis` with extent > 1, the packed store is
    marker-sharded across the mesh and the Gram precompute runs as a
    shard_map (each device decodes + Grams only its local blocks —
    parallel.distributed.sharded_packed_markers); every returned leaf is a
    global sharded array laid out as `st_data_shardings` expects.
    """
    import numpy as np

    index = {s: i for i, s in enumerate(store.obs_ids)}
    try:
        perm = np.asarray([index[s] for s in obs_ids], dtype=np.int32)
    except KeyError as e:
        raise ValueError(f"individual {e} has no genotypes") from None
    if len(perm) == store.n_obs and (perm == np.arange(store.n_obs)).all():
        perm = None

    n_shards = 0
    if mesh is not None and marker_axis in tuple(getattr(mesh, "axis_names", ())):
        n_shards = int(mesh.shape[marker_axis])

    p = store.n_markers
    b = block_size
    align = b * n_shards if n_shards > 1 else b
    p_pad = -(-p // align) * align
    packed_np = store.packed
    if p_pad != p:
        pad = np.zeros((p_pad - p, store.bytes_per_marker), dtype=np.uint8)
        packed_np = np.concatenate([packed_np, pad], axis=0)
    means_np = np.zeros(p_pad, dtype=np.float32)
    means_np[:p] = store.means
    valid_np = np.zeros(p_pad, dtype=np.float32)
    valid_np[:p] = 1.0

    if n_shards > 1:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from jwas_tpu.parallel.distributed import sharded_packed_markers

        packed_g = jax.device_put(
            packed_np, NamedSharding(mesh, P(marker_axis, None))
        )
        means_g = jax.device_put(means_np, NamedSharding(mesh, P(marker_axis)))
        valid_g = jax.device_put(valid_np, NamedSharding(mesh, P(marker_axis)))
        return sharded_packed_markers(
            packed_g, means_g, valid_g, len(obs_ids), b, mesh, marker_axis,
            row_perm=perm, rinv=rinv, dtype=dtype, gram_chunk=gram_chunk,
        )

    return packed_markers_from_arrays(
        packed_np, means_np, valid_np, perm, len(obs_ids), b,
        rinv=rinv, dtype=dtype, gram_chunk=gram_chunk,
    )
