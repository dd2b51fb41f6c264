"""Device-mesh sharding for multi-chip MCMC.

The scaling design (SURVEY.md §7, BASELINE north star): shard the n x p
genotype matrix **column-wise** (marker axis) across chips and run the blocked
Gibbs sweep on local marker blocks — the multi-device equivalent of the
reference's `independent_blocks=true` thread parallelism
(BayesABC.jl:190-255), with the shared residual reconciled by an XLA-inserted psum in the `X @ d_alpha` GEMM.
Multiple chains shard across the "chain" mesh axis (new capability vs the
reference, which is single-process; SURVEY.md §2.9 P6).

No collectives are written by hand: the step function is pure JAX, and
`jax.jit` with these shardings makes XLA insert the reduce over the marker
axis. The same step runs unchanged on one device or several.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_chains: int = 1, n_marker_shards: Optional[int] = None,
              devices=None) -> Mesh:
    """Create a ("chain", "marker") mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    n_dev = len(devices)
    if n_marker_shards is None:
        n_marker_shards = n_dev // n_chains
    if n_chains * n_marker_shards != n_dev:
        raise ValueError(
            f"chain x marker grid {n_chains}x{n_marker_shards} != {n_dev} devices"
        )
    dev_grid = np.array(devices).reshape(n_chains, n_marker_shards)
    return Mesh(dev_grid, ("chain", "marker"))


def st_data_shardings(mesh: Mesh):
    """PartitionSpecs for STData: markers column-sharded (incl. the 2-bit
    packed store, marker-major rows), the rest replicated."""
    from jwas_tpu.engine.mcmc import STData

    rep = P()
    return STData(
        W=NamedSharding(mesh, rep),
        WtRinvW=NamedSharding(mesh, rep),
        rinv=NamedSharding(mesh, rep),
        y=NamedSharding(mesh, rep),
        X=NamedSharding(mesh, P(None, "marker")),
        xpx=NamedSharding(mesh, P("marker")),
        grams=NamedSharding(mesh, P(None, None, "marker")),
        valid=NamedSharding(mesh, P("marker")),
        Vinv=tuple(),
        vc_scale=tuple(),
        out_geno=NamedSharding(mesh, P(None, "marker")),
        out_W=NamedSharding(mesh, rep),
        packed=NamedSharding(mesh, P("marker", None)),
        packed_means=NamedSharding(mesh, P("marker")),
        row_perm=NamedSharding(mesh, rep),
        anno_A=NamedSharding(mesh, P("marker", None)),
    )


def _fits(arr, mesh: Mesh, spec: P) -> P:
    """Drop named axes whose dimension does not divide the mesh extent so
    device_put never fails on awkward shapes (padding differences)."""
    dims = []
    for d, name in enumerate(spec):
        if name is None:
            dims.append(None)
            continue
        size = int(np.prod([mesh.shape[a] for a in ((name,) if isinstance(name, str) else name)]))
        dims.append(name if arr.shape[d] % size == 0 else None)
    return P(*dims)


def shard_st_multichain(mesh: Mesh, cfg, data, states, accums,
                        chain_ax: str, marker_ax: Optional[str]):
    """Place multi-chain state/accums (leading chain axis) + shared data onto
    a (chain, marker) mesh. Marker-dimension leaves additionally shard along
    the marker axis when their size divides the shard count."""
    import jax

    def put(x, *names):
        if x is None or not hasattr(x, "shape"):
            return x
        spec = _fits(x, mesh, P(*names))
        return jax.device_put(x, NamedSharding(mesh, spec))

    # chain axis on every leading dim of state/accum leaves
    def put_chain(x):
        return put(x, chain_ax, *([None] * (getattr(x, "ndim", 1) - 1)))

    states = jax.tree.map(put_chain, states)
    accums = jax.tree.map(put_chain, accums)

    if marker_ax is not None:
        # marker-sharded (chain, p_pad) state leaves
        marker_fields = ["alpha", "beta", "delta", "gamma_l"]
        if cfg.method in ("BayesC", "BayesB"):
            marker_fields.append("pi")
        if cfg.method == "BayesB":
            marker_fields.append("varg")
        st_updates = {}
        for f in marker_fields:
            x = getattr(states, f)
            if x is not None and getattr(x, "ndim", 0) >= 2:
                tail = [None] * (x.ndim - 2)
                st_updates[f] = put(x, chain_ax, marker_ax, *tail)
        states = states._replace(**st_updates)
        ac_updates = {}
        for f in ("alpha_m", "alpha_m2", "delta_m"):
            x = getattr(accums, f)
            if x is not None and getattr(x, "ndim", 0) >= 2:
                ac_updates[f] = put(x, chain_ax, marker_ax)
        accums = accums._replace(**ac_updates)

        d_updates = dict(
            X=put(data.X, None, marker_ax),
            xpx=put(data.xpx, marker_ax),
            grams=put(data.grams, None, None, marker_ax),
            valid=put(data.valid, marker_ax),
            out_geno=put(data.out_geno, None, marker_ax),
        )
        if data.packed is not None:
            d_updates["packed"] = put(data.packed, marker_ax, None)
            d_updates["packed_means"] = put(data.packed_means, marker_ax)
        if data.anno_A is not None:
            d_updates["anno_A"] = put(data.anno_A, marker_ax, None)
        data = data._replace(**d_updates)
    return data, states, accums


def st_state_shardings(mesh: Mesh, cfg, n_vc: int = 0):
    """PartitionSpecs for ChainState under marker sharding."""
    from jwas_tpu.engine.state import ChainState

    rep = NamedSharding(mesh, P())
    mrk = NamedSharding(mesh, P("marker"))
    varg = mrk if cfg.method == "BayesB" else rep
    if cfg.method == "BayesR":
        pi = rep
    elif cfg.method in ("BayesC", "BayesB"):
        pi = mrk
    else:
        pi = rep
    return ChainState(
        key=rep, sol=rep, alpha=mrk, beta=mrk, delta=mrk, gamma_l=mrk,
        ycorr=rep, vare=rep, varg=varg, pi=pi, scale_g=rep,
        vc=tuple(rep for _ in range(n_vc)),
    )


def shard_st(mesh: Mesh, cfg, data, state):
    """Place STData/ChainState onto the mesh with marker-axis sharding."""
    dsh = st_data_shardings(mesh)
    ssh = st_state_shardings(mesh, cfg, n_vc=len(state.vc))
    rep = NamedSharding(mesh, P())
    opt = {
        f: jax.device_put(getattr(data, f), getattr(dsh, f))
        for f in ("packed", "packed_means", "row_perm", "anno_A")
        if getattr(data, f) is not None
    }
    data = data._replace(
        **{
            f: jax.device_put(getattr(data, f), getattr(dsh, f))
            for f in ("W", "WtRinvW", "rinv", "y", "X", "xpx", "grams", "valid",
                      "out_geno", "out_W")
        },
        Vinv=tuple(jax.device_put(v, rep) for v in data.Vinv),
        vc_scale=tuple(jax.device_put(v, rep) for v in data.vc_scale),
        **opt,
    )
    state = state._replace(
        **{
            f: jax.device_put(getattr(state, f), getattr(ssh, f))
            for f in ("key", "sol", "alpha", "beta", "delta", "gamma_l",
                      "ycorr", "vare", "varg", "pi", "scale_g")
        },
        vc=tuple(jax.device_put(v, rep) for v in state.vc),
    )
    return data, state
