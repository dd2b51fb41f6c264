"""Stability sweep backing STALE_FRACTION = 0.4 (ops/grouped.py).

Within a marker group, all b*group_blocks markers update against a residual
that is only refreshed every `sync_every` inner reps — independent-blocks
semantics (reference: BayesABC.jl:190-255). The parallel update is a
regularized Jacobi step whose coupling radius grows with the stale-set
aspect ratio q = (b*gb)/n; past a threshold the iteration amplifies
cross-block interference and the chain diverges (exploding |alpha|, vare).

This script measures that boundary with the PRODUCTION engine window
(grouped 2-bit store, BayesC, vare/pi/sigma estimated): for each q it runs
>= 2048 effective sweeps at fixed stale-set size b*gb = 2048 and varying n,
and reports the vare trajectory (start -> mid -> end), max |alpha|, and the
EBV accuracy against simulated truth. Divergence is unambiguous: vare and
|alpha| blow up by orders of magnitude and accuracy collapses.

Run:  python benchmarks/stability_sweep.py          (GPU, or CPU: slow)
Committed results: benchmarks/results/stability_sweep_r05.md
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_one(jax, jnp, q, *, stale=2048, ngroups=4, nreps=16, sync_every=8,
            n_outer=128, seed=0):
    from bench import _build_northstar, _sync
    from jwas_tpu.engine.mcmc import (STData, STEngineCfg, _init_accum,
                                      make_run_window)
    from jwas_tpu.engine.state import ChainState
    from jwas_tpu.ops.grouped import grouped_matvec

    n = int(round(stale / q / 256)) * 256          # keep bpm lane-aligned
    block, gbk = 16, stale // 16
    p = stale * ngroups
    dtype = jnp.float32

    gm, y, host, tbv = _build_northstar(jax, jnp, n, p, block, gbk, dtype,
                                        device_store=True)
    p_pad = gm.xpx.shape[0]
    K = 1
    W = jnp.ones((n, K), dtype)
    genvar = 0.001 * p * 0.42
    vary = float(2.0 * genvar)
    cfg = STEngineCfg(
        method="BayesC", n_obs=n, n_markers=p, n_loc=K,
        estimate_pi=True, estimate_marker_variance=True, estimate_scale=False,
        estimate_residual_variance=True, use_blocks=True, nreps=nreps,
        sync_every=sync_every, re_groups=(), df_residual=4.0, df_marker=4.0,
        has_weights=False, use_pallas=False, is_packed=True, grouped=True,
        host_offload=False, has_missing_codes=False, scale_R=vary * 0.5,
    )
    data = STData(
        W=W, WtRinvW=(W.T @ W), rinv=jnp.ones((n,), dtype), y=y,
        X=jnp.zeros((n, 0), dtype), xpx=gm.xpx, grams=gm.grams,
        valid=gm.valid, Vinv=(), vc_scale=(),
        out_geno=jnp.zeros((0, p), dtype), out_W=jnp.zeros((0, K), dtype),
        packed=gm.store, packed_means=gm.means, row_perm=gm.row_perm,
    )
    state = ChainState(
        key=jax.random.PRNGKey(42 + seed), sol=jnp.zeros((K,), dtype),
        alpha=jnp.zeros((p_pad,), dtype), beta=jnp.zeros((p_pad,), dtype),
        delta=jnp.where(gm.valid > 0, 1, 0).astype(jnp.int32),
        gamma_l=jnp.ones((p_pad,), dtype), ycorr=y,
        vare=jnp.asarray(vary * 0.5, dtype), varg=jnp.asarray(0.5, dtype),
        pi=jnp.where(gm.valid > 0, 0.999, 1.0).astype(dtype),
        scale_g=jnp.asarray(0.25, dtype), vc=(),
    )
    run_window = make_run_window(cfg)
    accum = _init_accum(cfg, data, state)
    vare_traj = [float(state.vare)]
    win = 8
    done = 0
    while done < n_outer:
        state, accum, _ = run_window(state, data, accum, win, accumulate=True)
        done += win
        v = float(state.vare)
        vare_traj.append(v)
        if not (v == v) or v > 1e12:   # NaN or exploded: stop early
            break
    _sync(state.vare)
    import numpy as np

    amax = float(jnp.max(jnp.abs(state.alpha)))
    ebv = grouped_matvec(gm, accum.alpha_m, n_obs=n, host_store=False,
                         has_missing=False)
    with np.errstate(all="ignore"):
        acc = float(np.corrcoef(np.asarray(ebv), np.asarray(tbv))[0, 1])
    mid = vare_traj[len(vare_traj) // 2]
    return {
        "q": round(stale / n, 3), "n": n, "stale": stale,
        "sweeps": done * nreps, "vare0": round(vare_traj[0], 1),
        "vare_mid": round(mid, 1), "vare_end": round(vare_traj[-1], 1),
        "max_abs_alpha": round(amax, 2),
        "ebv_accuracy": round(acc, 3) if acc == acc else float("nan"),
        "diverged": bool(vare_traj[-1] > 10 * vary or amax > 100
                         or acc != acc),
    }


def main():
    import jax
    import jax.numpy as jnp

    rows = []
    for q in (0.2, 0.33, 0.4, 0.5, 0.66):
        t0 = time.time()
        r = run_one(jax, jnp, q)
        r["wall_s"] = round(time.time() - t0, 1)
        rows.append(r)
        print(json.dumps(r), flush=True)
    print("\n| q | n | sweeps | vare start/mid/end | max|a| | EBV acc | diverged |",
          flush=True)
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['q']} | {r['n']} | {r['sweeps']} | "
              f"{r['vare0']}/{r['vare_mid']}/{r['vare_end']} | "
              f"{r['max_abs_alpha']} | {r['ebv_accuracy']} | "
              f"{'YES' if r['diverged'] else 'no'} |")


if __name__ == "__main__":
    main()
