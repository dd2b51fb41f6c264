"""Multi-host (multi-process) execution layer.

The reference is strictly single-process — no MPI/NCCL/Distributed.jl
anywhere (SURVEY.md §2.9: "Distributed communication backend: none").
This module is the multi-device scaling layer the reference lacks:

- `initialize_multihost` brings up `jax.distributed` (process
  coordination) so `jax.devices()` spans every process; the math itself
  communicates only through XLA collectives, inserted from the
  NamedShardings in `jwas_tpu.parallel.mesh`.
- `load_packed_global` builds GLOBAL marker-sharded `jax.Array`s from a
  saved 2-bit packed store (`Packed2BitStore.save`, io/packed.py) with
  **each process reading only the byte ranges of its own shards**: the
  `.j2b` file is marker-major, so a marker shard is one contiguous
  memmap row slice — no host ever materializes the full genotype file.
  (Reference decode-loop analogue: streaming_genotypes.jl:978-1027.)
- `sharded_packed_markers` precomputes the fast-blocks Gram tiles with a
  `shard_map` over the marker axis: every device decodes and Grams only
  its local marker blocks (tools4genotypes.jl:237-275 semantics, but
  embarrassingly parallel across the mesh — block Grams never mix
  markers from different blocks, so there is no cross-shard term).

The same code runs unchanged on one host with N local devices (the test
configuration: 8 virtual CPU devices) and across several processes;
`jax.make_array_from_callback` only invokes the loader for addressable
shards in both cases.
"""

from __future__ import annotations

import json
import os
from functools import partial
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_initialized = False


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
    force: bool = False,
) -> bool:
    """Bring up `jax.distributed` for a multi-host run.

    Configuration comes from the arguments or, when omitted, from
    JAX_COORDINATOR_ADDRESS; num_processes and process_id are then needed
    as arguments or in JAX's own environment variables, since nothing
    detects a cluster. `force=True` calls initialize() unconditionally. Returns False (no-op) when nothing indicates a
    multi-process launch — single-host runs never pay the bring-up, and
    calling this unconditionally at the top of a driver script is safe.
    """
    global _initialized
    if _initialized:
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if coordinator_address is None and num_processes is None and not force:
        return False
    # private API: a jax upgrade may move this symbol; degrade to "attempt
    # the bring-up anyway" rather than failing every launch on import
    try:
        from jax._src import xla_bridge

        backends_up = xla_bridge.backends_are_initialized()
    except (ImportError, AttributeError):
        backends_up = False
    if backends_up:
        import warnings

        warnings.warn(
            "jax.distributed bring-up skipped: the XLA backend is already "
            "initialized. Call jwas_tpu.parallel.initialize_multihost() (or "
            "runMCMC) before any other JAX computation in multi-process "
            "runs."
        )
        return False
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = int(num_processes)
    if process_id is not None:
        kwargs["process_id"] = int(process_id)
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)
    _initialized = True
    return True


def load_packed_global(
    path: str,
    mesh: Mesh,
    block_size: int,
    marker_axis: str = "marker",
) -> Tuple[jax.Array, jax.Array, jax.Array, int, int]:
    """Load a saved packed store as global marker-sharded arrays.

    Returns (packed (p_pad, bpm) uint8, means (p_pad,) f32,
    valid (p_pad,) f32, n_obs, n_markers). p_pad is aligned to
    block_size × n_marker_shards so every shard holds whole blocks; the
    padding tail decodes to code 0 and is masked by valid=0 (identical
    to the single-device `build_packed_markers` padding convention,
    ops/packed.py).

    Each process memmaps `<path>.j2b` and copies only the rows of its
    addressable shards.
    """
    with open(path + ".manifest.json") as f:
        man = json.load(f)
    if man.get("format") != "jwas_tpu-2bit-v1":
        raise ValueError(f"unrecognized packed-store format in {path}")
    n, p = int(man["n_obs"]), int(man["n_markers"])
    bpm = (n + 3) // 4
    n_shards = mesh.shape[marker_axis]
    align = block_size * n_shards
    p_pad = -(-p // align) * align

    mm = np.memmap(path + ".j2b", dtype=np.uint8, mode="r", shape=(p, bpm))
    means_host = np.zeros(p_pad, np.float32)
    means_host[:p] = np.asarray(man["means"], np.float32)
    valid_host = np.zeros(p_pad, np.float32)
    valid_host[:p] = 1.0

    sh_rows = NamedSharding(mesh, P(marker_axis, None))
    sh_vec = NamedSharding(mesh, P(marker_axis))

    def rows_cb(idx):
        r = idx[0]
        start = r.start or 0
        stop = r.stop if r.stop is not None else p_pad
        out = np.zeros((stop - start, bpm), np.uint8)
        hi = min(stop, p)
        if hi > start:
            out[: hi - start] = mm[start:hi]
        return out

    packed = jax.make_array_from_callback((p_pad, bpm), sh_rows, rows_cb)
    means = jax.make_array_from_callback(
        (p_pad,), sh_vec, lambda i: means_host[i]
    )
    valid = jax.make_array_from_callback(
        (p_pad,), sh_vec, lambda i: valid_host[i]
    )
    return packed, means, valid, n, p


def sharded_packed_markers(
    packed,
    means,
    valid,
    n_obs: int,
    block_size: int,
    mesh: Mesh,
    marker_axis: str = "marker",
    row_perm=None,
    rinv=None,
    dtype=jnp.float32,
    gram_chunk: int = 8,
):
    """Fast-blocks Gram precompute over a marker-sharded packed store.

    shard_map over the marker axis: each device decodes its local packed
    rows tile-by-tile and computes its blocks' (b, b) Gram matrices and
    xpx diagonals — zero inter-device communication (block Grams are
    block-local by construction, tools4genotypes.jl:237-275). Output
    grams are sharded P(None, None, marker), xpx/valid P(marker) —
    exactly the layouts `st_data_shardings` expects.
    """
    try:
        from jax import shard_map
    except ImportError:  # pragma: no cover - older jax
        from jax.experimental.shard_map import shard_map

    from jwas_tpu.ops.markers import gram_tiles
    from jwas_tpu.ops.packed import PackedMarkers, decode_tile

    b = block_size
    p_pad = packed.shape[0]
    n_shards = mesh.shape[marker_axis]
    if p_pad % (b * n_shards):
        raise ValueError(
            f"p_pad={p_pad} not aligned to block_size*shards={b * n_shards}"
        )
    local_p = p_pad // n_shards
    nblocks_local = local_p // b
    chunk_blk = max(1, min(gram_chunk, nblocks_local))
    while nblocks_local % chunk_blk:
        chunk_blk -= 1

    rp = None if row_perm is None else jnp.asarray(row_perm)
    rv = None if rinv is None else jnp.asarray(rinv, dtype)

    def local_grams(pk, mn, *rest):
        i = 0
        rp_l = rest[i] if row_perm is not None else None
        i += row_perm is not None
        rv_l = rest[i] if rinv is not None else None

        def body(_, k0):
            rows = jax.lax.dynamic_slice(
                pk, (k0 * chunk_blk * b, 0), (chunk_blk * b, pk.shape[1])
            )
            mns = jax.lax.dynamic_slice(
                mn, (k0 * chunk_blk * b,), (chunk_blk * b,)
            )
            X = decode_tile(rows, mns, rp_l, dtype, n_obs=n_obs)
            Xb = X.reshape(n_obs, chunk_blk, b)
            Xw = Xb if rv_l is None else Xb * rv_l[:, None, None]
            g = gram_tiles(Xb, Xw)
            xpx = jnp.sum(Xw * Xb, axis=0).reshape(-1)
            return None, (g, xpx)

        _, (gs, xs) = jax.lax.scan(
            body, None, jnp.arange(nblocks_local // chunk_blk)
        )
        grams = jnp.moveaxis(gs, 0, 2).reshape(b, b, nblocks_local)
        return grams, xs.reshape(-1)

    in_specs = [P(marker_axis, None), P(marker_axis)]
    args = [packed, means]
    if row_perm is not None:
        in_specs.append(P())
        args.append(rp)
    if rinv is not None:
        in_specs.append(P())
        args.append(rv)

    grams, xpx = jax.jit(
        shard_map(
            local_grams,
            mesh=mesh,
            in_specs=tuple(in_specs),
            out_specs=(P(None, None, marker_axis), P(marker_axis)),
        )
    )(*args)
    xpx = jnp.where(valid > 0, jnp.maximum(xpx, 1e-10), 1.0)
    return PackedMarkers(
        packed=packed, means=means, row_perm=rp,
        xpx=xpx, grams=grams, valid=valid,
    )


def build_packed_markers_multihost(
    path: str,
    mesh: Mesh,
    block_size: int,
    marker_axis: str = "marker",
    rinv=None,
    dtype=jnp.float32,
    gram_chunk: int = 8,
):
    """One-call multi-host staging: per-host shard loading + sharded Gram
    precompute. Observations are used in STORE order (the identity
    decode fast path) — align phenotypes to `store.obs_ids` before
    calling, as `prepare_packed_genotypes` writes them.

    Returns (PackedMarkers with globally sharded leaves, n_obs, n_markers).
    """
    packed, means, valid, n, p = load_packed_global(
        path, mesh, block_size, marker_axis
    )
    pm = sharded_packed_markers(
        packed, means, valid, n, block_size, mesh, marker_axis,
        row_perm=None, rinv=rinv, dtype=dtype, gram_chunk=gram_chunk,
    )
    return pm, n, p
