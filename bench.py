"""Benchmark: single-trait BayesC marker-effect updates/sec on one chip.

Headline metric matching BASELINE.md: EFFECTIVE marker-effect updates per
second for the blocked (fast_blocks) BayesC sampler, using the reference's
own block-mode accounting (each outer iteration performs nreps inner sweeps;
chain length is rescaled accordingly, JWAS.jl:293-316).

Modes (BENCH_MODE; default "packed"):
- northstar — the workload of BASELINE.md row 1: N=50k x P=2M, L=2000
  effective sweeps, a 26 GB 2-bit store (in pinned host memory, or on the
  device with BENCH_DEVICE_STORE=1); reports chain rate,
  full-run wall clock vs the reference's 3,449 s, and EBV accuracy vs the
  simulated truth.
- packed — the device-resident grouped configuration (p=1M, n=12k, 3.3 GB
  store), the engine's single-device path for stores that fit.
- dense — dense-f32 X (p=98,304), the small-p code path.
- mt — two-trait blocked sampler at p=262,144.
Every mode reports ebv_accuracy: a diverged chain cannot pass as fast.
BENCH_PALLAS (auto | 1 | 0) chooses the inner-round kernel as runMCMC's
use_pallas does. The script refuses to run without a GPU and prints the
card's name and power limit.

vs_baseline compares against the reference's BEST published configuration:
blocked BayesC at N=50k, P=2M, L=2000 effective sweeps in 3,449 s on a
64-CPU node (docs/src/manual/benchmark.md:58-62) = 1.16M effective
updates/s. The single-core non-block rate (~15.6k updates/s,
benchmark.md:81-90) is reported on the comment line for context.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
"""

import json
import os
import sys
import time

# JWAS fast_blocks on a 64-CPU node: 2e6 markers * 2000 effective sweeps / 3449 s
BASELINE_UPDATES_PER_SEC = 2_000_000 * 2_000 / 3_449.0  # ~1.16e6
SINGLE_CORE_NONBLOCK = 15_600.0


def _use_pallas() -> bool:
    """BENCH_PALLAS (auto | 1 | 0), resolved like runMCMC's use_pallas."""
    from jwas_tpu.utils.backend import resolve_use_pallas

    flag = os.environ.get("BENCH_PALLAS", "auto")
    return resolve_use_pallas(flag if flag == "auto" else flag == "1")


def _build_dense(jax, jnp, n, p, block, dtype):
    """Dense-f32 marker blocks with synthetic binomial genotypes."""
    from jwas_tpu.ops import markers as mk

    key = jax.random.PRNGKey(0)
    kf, ke = jax.random.split(key, 2)
    freqs = jax.random.uniform(kf, (p,), minval=0.1, maxval=0.9)

    @jax.jit
    def gen_chunk(k, f):
        k1, k2 = jax.random.split(k)
        cn = f.shape[0]
        raw = (
            (jax.random.uniform(k1, (n, cn)) < f).astype(dtype)
            + (jax.random.uniform(k2, (n, cn)) < f).astype(dtype)
        )
        return raw - 2.0 * f[None, :]  # center with the theoretical mean

    chunk = 16_384
    cols = []
    for c0 in range(0, p, chunk):
        c1 = min(c0 + chunk, p)
        cols.append(gen_chunk(jax.random.fold_in(key, c0), freqs[c0:c1]))
    X = jnp.concatenate(cols, axis=1)
    del cols
    beta_true = jax.random.normal(ke, (p,)) * jnp.where(
        jax.random.uniform(ke, (p,)) < 0.01, 1.0, 0.0
    )
    tbv = X @ beta_true
    y = tbv + jax.random.normal(ke, (n,)) * 1.0
    y = y - jnp.mean(y)
    md = mk.build_marker_blocks(X, block_size=block)
    return md, None, y, tbv


def _build_northstar(jax, jnp, n, p, block, gb, dtype, device_store=False):
    """The north-star shape (BASELINE.md row 1: N=50k, P=2M): a 26 GB 2-bit
    packed store, built group by group on the device or directly into
    pinned host memory, swept with the group-sequential sweep
    (ops/grouped.py)."""
    from jwas_tpu.ops.grouped import (
        GroupedPackedMarkers,
        grouped_matvec,
        grouped_stats,
        host_memory_supported,
        materialize_grouped_host,
    )

    key = jax.random.PRNGKey(0)
    G = block * gb
    p_pad = -(-p // G) * G
    ngroups = p_pad // G
    n_pad = -(-n // 512) * 512          # bpm a multiple of 128 bytes
    bpm = n_pad // 4

    kf = jax.random.fold_in(key, 1)
    freqs = jax.random.uniform(kf, (p_pad,), minval=0.1, maxval=0.9)
    # inverse-CDF Binomial(2, f): one uniform, two compares
    q0 = (1.0 - freqs) ** 2             # P(code 0)
    q01 = q0 + 2.0 * freqs * (1.0 - freqs)

    sub = 2048                           # markers per generation sub-chunk
    assert G % sub == 0

    def gen_group(g):
        def gen_sub(k):
            j0 = g * G + k * sub
            u = jax.random.uniform(
                jax.random.fold_in(key, g * (G // sub) + k + 17), (sub, n_pad)
            )
            lo = jax.lax.dynamic_slice(q0, (j0,), (sub,))[:, None]
            hi = jax.lax.dynamic_slice(q01, (j0,), (sub,))[:, None]
            codes = (u > lo).astype(jnp.uint8) + (u > hi).astype(jnp.uint8)
            c = codes.reshape(sub, bpm, 4)
            return (c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4)
                    | (c[:, :, 3] << 6))

        parts = [gen_sub(k) for k in range(G // sub)]
        return jnp.concatenate(parts, axis=0)

    t0 = time.perf_counter()
    if device_store or os.environ.get("BENCH_DEVICE_STORE", "0") == "1":
        # store device-resident (must fit with the Gram tiles): one scan
        # generates straight into the stacked device buffer
        _, store = jax.jit(
            lambda: jax.lax.scan(
                lambda _, g: (None, gen_group(g)), None, jnp.arange(ngroups)
            )
        )()
    else:
        store = materialize_grouped_host(gen_group, ngroups, G, bpm)
    store.block_until_ready()
    host = hasattr(store, "sharding") and getattr(
        store.sharding, "memory_kind", ""
    ) == "pinned_host"
    gb_store = store.size / 1e9
    print(f"# store build: {time.perf_counter() - t0:.1f}s "
          f"({gb_store:.1f} GB packed, pinned_host={host}, "
          f"host_mem_supported={host_memory_supported()})", file=sys.stderr)

    means = (2.0 * freqs).astype(jnp.float32)
    valid = (jnp.arange(p_pad) < p).astype(dtype)
    t0 = time.perf_counter()
    grams, xpx = grouped_stats(
        store, means, valid, None, None, block, n, host_store=host,
        exact_bf16=True,
    )
    jax.block_until_ready(xpx)
    print(f"# gram precompute (exact bf16 codes): "
          f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)

    gm = GroupedPackedMarkers(store=store, means=means, row_perm=None,
                              xpx=xpx, grams=grams, valid=valid)

    ke = jax.random.fold_in(key, 2)
    beta_true = valid * jax.random.normal(ke, (p_pad,)) * jnp.where(
        jax.random.uniform(ke, (p_pad,)) < 0.001, 1.0, 0.0
    )
    g = grouped_matvec(gm, beta_true.astype(dtype), n_obs=n, host_store=host,
                       has_missing=False)
    # h2 = 0.5: residual sd matched to the realized genetic sd (an h2 ~ 1
    # synthetic is numerically pathological for ANY blocked sampler)
    y = g + jax.random.normal(ke, (n,)).astype(dtype) * jnp.std(g)
    y = y - jnp.mean(y)
    return gm, y, host, g


def run_northstar(jax, jnp, *, n_default=50_000, p_default=2_097_152,
                  block_default=128, chain_default=2_000,
                  device_store=False, mode_name="northstar"):
    """See _run_northstar. Prints the JSON result line."""
    res = _run_northstar(jax, jnp, n_default=n_default, p_default=p_default,
                         block_default=block_default,
                         chain_default=chain_default,
                         device_store=device_store, mode_name=mode_name)
    print(json.dumps(res["json"]), flush=True)
    print(res["comment"], file=sys.stderr)
    return res


def _run_northstar(jax, jnp, *, n_default, p_default, block_default,
                   chain_default, device_store, mode_name):
    """Full north-star run: N=50k x P=2M, L=2000 effective sweeps — the
    workload of BASELINE.md row 1 (benchmark.md:47-62, 3,449 s on a 64-CPU
    node), end to end. Reports the chain-rate headline plus the full-run
    wall clock (store build + Grams + compile + chain) against 3,449 s.
    The same harness runs the device-resident grouped configuration (mode
    "packed")."""
    from jwas_tpu.engine.mcmc import (STData, STEngineCfg, _init_accum,
                                      make_run_window)
    from jwas_tpu.engine.state import ChainState

    n = int(os.environ.get("BENCH_N", n_default))
    p = int(os.environ.get("BENCH_P", p_default))
    block = int(os.environ.get("BENCH_BLOCK", block_default))
    gbk = int(os.environ.get("BENCH_GROUP_BLOCKS", 128))
    nreps = int(os.environ.get("BENCH_NREPS", block))
    L = int(os.environ.get("BENCH_CHAIN", chain_default))
    n_outer = -(-L // nreps)
    sync_every = int(os.environ.get("BENCH_SYNC", 32))
    dtype = jnp.float32
    from jwas_tpu.ops.grouped import STALE_FRACTION

    if block * gbk > STALE_FRACTION * n:
        print(f"# WARNING: stale set b*gb={block*gbk} exceeds "
              f"{STALE_FRACTION}*n={STALE_FRACTION*n:.0f} — the parallel "
              f"blocked update may diverge (watch ebv_accuracy)",
              file=sys.stderr)

    t_all = time.perf_counter()
    gm, y, host, tbv = _build_northstar(jax, jnp, n, p, block, gbk, dtype,
                                        device_store=device_store)
    if host and os.environ.get("BENCH_HYBRID", "1") == "1":
        from jwas_tpu.ops.grouped import hybridize

        t_h = time.perf_counter()
        gm = hybridize(gm)
        if gm.dev_store is not None:
            gm.dev_store.block_until_ready()
            print(f"# hybrid split: {gm.dev_store.shape[0]}/{gm.store.shape[0]} "
                  f"groups device-resident "
                  f"({gm.dev_store.size/1e9:.1f} GB, "
                  f"{time.perf_counter()-t_h:.1f}s)", file=sys.stderr)
    p_pad = gm.xpx.shape[0]
    nblocks = gm.grams.shape[2]

    K = 1
    W = jnp.ones((n, K), dtype)
    # h2=0.5 synthetic: genetic var ~ 0.001*p*0.42 (Binomial(2,f) variance,
    # E[2f(1-f)] ~ 0.42 for f ~ U(0.1, 0.9)), residual var matched to it
    genvar = 0.001 * p * 0.42
    vary_analytic = float(2.0 * genvar)
    use_pallas = _use_pallas()

    cfg = STEngineCfg(
        method="BayesC", n_obs=n, n_markers=p, n_loc=K,
        estimate_pi=True, estimate_marker_variance=True, estimate_scale=False,
        estimate_residual_variance=True, use_blocks=True, nreps=nreps,
        sync_every=sync_every,
        re_groups=(), df_residual=4.0, df_marker=4.0, has_weights=False,
        use_pallas=use_pallas, is_packed=True, grouped=True,
        host_offload=host, has_missing_codes=False,
        prefetch=os.environ.get("BENCH_PREFETCH", "1") == "1" and host,
        scale_R=vary_analytic * 0.5,
    )
    data = STData(
        W=W, WtRinvW=(W.T @ W), rinv=jnp.ones((n,), dtype), y=y,
        X=jnp.zeros((n, 0), dtype), xpx=gm.xpx, grams=gm.grams,
        valid=gm.valid, Vinv=(), vc_scale=(),
        out_geno=jnp.zeros((0, p), dtype), out_W=jnp.zeros((0, K), dtype),
        packed=gm.store, packed_means=gm.means, row_perm=gm.row_perm,
        packed_dev=gm.dev_store,
    )
    pi0 = jnp.where(gm.valid > 0, 0.999, 1.0).astype(dtype)
    state = ChainState(
        key=jax.random.PRNGKey(42), sol=jnp.zeros((K,), dtype),
        alpha=jnp.zeros((p_pad,), dtype), beta=jnp.zeros((p_pad,), dtype),
        delta=jnp.where(gm.valid > 0, 1, 0).astype(jnp.int32),
        gamma_l=jnp.ones((p_pad,), dtype),
        ycorr=y, vare=jnp.asarray(vary_analytic * 0.5, dtype),
        varg=jnp.asarray(0.5, dtype), pi=pi0,
        scale_g=jnp.asarray(0.25, dtype), vc=(),
    )

    run_window = make_run_window(cfg)
    accum = _init_accum(cfg, data, state)

    win = 2
    t_c = time.perf_counter()
    state, accum, _ = run_window(state, data, accum, win, accumulate=True)
    jax.block_until_ready(state.vare)
    t_compile_and_first = time.perf_counter() - t_c
    print(f"# compile + first window ({win} outer): "
          f"{t_compile_and_first:.1f}s", file=sys.stderr)

    # under a wall-clock budget a partial chain still yields a valid
    # updates/s figure
    budget_s = float(os.environ.get("BENCH_BUDGET_S", 1800))
    t0 = time.perf_counter()
    done = win
    while done < n_outer:
        if time.perf_counter() - t_all > budget_s:
            print(f"# budget {budget_s:.0f}s reached at {done}/{n_outer} "
                  f"outer iterations; reporting the partial chain",
                  file=sys.stderr)
            break
        state, accum, out = run_window(state, data, accum, win, accumulate=True)
        done += win
    n_outer = done
    jax.block_until_ready(state.vare)
    dt_rest = time.perf_counter() - t0
    chain_s = t_compile_and_first + dt_rest   # conservative: includes compile
    full_s = time.perf_counter() - t_all
    effective = p * nreps * n_outer

    # statistical sanity of the timed chain: EBV from the running posterior
    # mean of alpha vs the simulated true breeding values (h2=0.5 synthetic)
    from jwas_tpu.ops.grouped import grouped_matvec as _gmv

    ebv = _gmv(gm, accum.alpha_m, n_obs=n, host_store=host, has_missing=False)
    import numpy as _np

    ebv_acc = float(_np.corrcoef(_np.asarray(ebv), _np.asarray(tbv))[0, 1])
    rate = effective / chain_s
    return {
        "json": {
            "metric": "marker_updates_per_sec",
            "value": round(rate, 1),
            "unit": "updates/s",
            "vs_baseline": round(rate / BASELINE_UPDATES_PER_SEC, 2),
        },
        "comment": (
            f"# mode={mode_name} n={n} p={p} "
            f"({gm.store.size/1e9:.1f} GB packed, "
            f"pinned_host={host}) block={block} group_blocks={gbk} "
            f"nreps={nreps} "
            f"sync={sync_every} outer={n_outer} "
            f"effective_sweeps={nreps*n_outer} "
            f"chain={chain_s:.1f}s full_run={full_s:.1f}s "
            f"vs_reference_3449s={3449.0/full_s:.1f}x_full "
            f"{3449.0*(nreps*n_outer)/2000.0/chain_s:.1f}x_chain "
            f"ebv_accuracy={ebv_acc:.3f} "
            f"pallas={cfg.use_pallas} device={jax.devices()[0]}"
        ),
        "ebv_accuracy": ebv_acc,
        "rate": rate,
    }


def run_mt(jax, jnp):
    """Multi-trait (t=2) blocked sampler-I rate at p >= 256k on one chip —
    the measured MT perf point (XLA scan path; MTBayesABC.jl:243-646 is the
    reference analogue, which has no published MT benchmark). Reports
    marker-trait updates/s and EBV accuracy per trait vs simulated truth."""
    from jwas_tpu.ops import markers as mk
    from jwas_tpu.ops import multitrait as mt

    t = 2
    n = int(os.environ.get("BENCH_N", 8_000))
    p = int(os.environ.get("BENCH_P", 262_144))
    block = int(os.environ.get("BENCH_BLOCK", 64))
    nreps = int(os.environ.get("BENCH_NREPS", 64))
    n_outer = int(os.environ.get("BENCH_OUTER", 4))
    sync_every = int(os.environ.get("BENCH_SYNC", 8))
    dtype = jnp.float32

    key = jax.random.PRNGKey(0)
    kf, ke = jax.random.split(key)
    freqs = jax.random.uniform(kf, (p,), minval=0.1, maxval=0.9)

    @jax.jit
    def gen_chunk(k, f):
        k1, k2 = jax.random.split(k)
        cn = f.shape[0]
        raw = (
            (jax.random.uniform(k1, (n, cn)) < f).astype(dtype)
            + (jax.random.uniform(k2, (n, cn)) < f).astype(dtype)
        )
        return raw - 2.0 * f[None, :]

    chunk = 16_384
    cols = [gen_chunk(jax.random.fold_in(key, c0), freqs[c0:min(c0 + chunk, p)])
            for c0 in range(0, p, chunk)]
    X = jnp.concatenate(cols, axis=1)
    del cols
    t_setup = time.perf_counter()
    md = mk.build_marker_blocks(X, block_size=block)
    jax.block_until_ready(md.xpx)
    print(f"# MT grams: {time.perf_counter() - t_setup:.1f}s "
          f"(X {X.size * 4 / 1e9:.1f} GB)", file=sys.stderr)

    # shared QTL, genetic correlation 0.6, h2 = 0.5 per trait
    qtl = jax.random.uniform(ke, (p,)) < 0.002
    e1 = jax.random.normal(jax.random.fold_in(ke, 1), (p,))
    e2 = 0.6 * e1 + 0.8 * jax.random.normal(jax.random.fold_in(ke, 2), (p,))
    eff = jnp.stack([e1, e2]) * qtl[None, :].astype(dtype)
    tbv = jnp.einsum("np,tp->tn", X, eff)
    noise = jax.random.normal(jax.random.fold_in(ke, 3), (t, n))
    y = tbv + noise * jnp.std(tbv, axis=1, keepdims=True)
    y = y - jnp.mean(y, axis=1, keepdims=True)

    genvar = jnp.var(tbv, axis=1)
    R = jnp.diag(genvar)                      # h2=0.5: vare ~ genvar
    ginv = jnp.linalg.inv(jnp.eye(t) * 0.5)
    pi = jnp.asarray([0.996, 0.001, 0.001, 0.002], dtype)

    p_pad = md.X.shape[1]
    alpha = jnp.zeros((t, p_pad), dtype)
    beta = jnp.zeros((t, p_pad), dtype)
    delta = jnp.zeros((t, p_pad), dtype)
    ycorr = y

    # md is a jit ARGUMENT, never a closure: closing over it captures the
    # 8.4 GB dense X as a lowering constant (the hybridize bug class).
    # The sweep runs the group-sequential schedule: flat blocked MT at
    # p/n = 33 is past the divergence boundary (stability_sweep_r05.md;
    # the first round-5 MT capture measured NEGATIVE accuracy flat).
    gb_mt = mk.stable_group_blocks(n, block, md.grams.shape[2])
    print(f"# MT schedule: group_blocks={gb_mt or 'flat'} "
          f"(stale={(gb_mt or md.grams.shape[2]) * block}, n={n})",
          file=sys.stderr)

    def _run(md_, alpha, beta, delta, ycorr, k):
        if gb_mt:
            def cg(md_g, sts, yc, g, kg):
                a, be, d = sts
                a, be, d, yc = mt.mt_abc_blocks_I(
                    md_g, a, be, d, yc, None, R, ginv, pi, kg,
                    nreps=nreps, sync_every=sync_every,
                )
                return (a, be, d), yc

            (alpha, beta, delta), ycorr = mk.grouped_dense_sweep(
                cg, md_, (alpha, beta, delta), ycorr, k, gb_mt
            )
            return alpha, beta, delta, ycorr
        return mt.mt_abc_blocks_I(
            md_, alpha, beta, delta, ycorr, None, R, ginv, pi, k,
            nreps=nreps, sync_every=sync_every,
        )

    run = jax.jit(_run)

    t_c = time.perf_counter()
    alpha, beta, delta, ycorr = run(md, alpha, beta, delta, ycorr,
                                    jax.random.fold_in(key, 100))
    jax.block_until_ready(alpha)
    print(f"# compile+warmup: {time.perf_counter() - t_c:.1f}s",
          file=sys.stderr)

    acc_sum = jnp.zeros((t, p_pad), dtype)
    t0 = time.perf_counter()
    for i in range(n_outer):
        alpha, beta, delta, ycorr = run(md, alpha, beta, delta, ycorr,
                                        jax.random.fold_in(key, 101 + i))
        acc_sum = acc_sum + alpha
    jax.block_until_ready(alpha)
    dt = time.perf_counter() - t0

    import numpy as _np

    ebv = jnp.einsum("np,tp->tn", md.X, acc_sum / n_outer)
    accs = [float(_np.corrcoef(_np.asarray(ebv[k]), _np.asarray(tbv[k]))[0, 1])
            for k in range(t)]
    rate = t * p * nreps * n_outer / dt
    print(json.dumps({
        "metric": "mt_marker_trait_updates_per_sec",
        "value": round(rate, 1), "unit": "updates/s",
        "vs_baseline": round(rate / BASELINE_UPDATES_PER_SEC, 2),
    }))
    print(f"# mode=mt t={t} n={n} p={p} block={block} nreps={nreps} "
          f"sync={sync_every} outer={n_outer} wall={dt:.2f}s "
          f"sweeps/s={nreps*n_outer/dt:.2f} "
          f"ebv_accuracy={accs[0]:.3f},{accs[1]:.3f} "
          f"device={jax.devices()[0]}", file=sys.stderr)


def main():
    import subprocess

    import jax
    import jax.numpy as jnp

    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py: no GPU (JAX backend {jax.default_backend()!r})")
    from jwas_tpu.utils.backend import enable_compile_cache

    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"# card: {card}; device_kind={jax.devices()[0].device_kind}",
          file=sys.stderr)

    mode = os.environ.get("BENCH_MODE", "packed")
    if mode == "northstar":
        return run_northstar(jax, jnp)
    if mode == "mt":
        return run_mt(jax, jnp)
    if mode == "packed":
        # single-device grouped path: p >= 1M markers, 2-bit store (3.3 GB
        # at n=12k) + Gram tiles; b chosen under the stability cap
        # (b=32 x gb=128 = 4096 stale markers <= 0.4 n)
        return run_northstar(
            jax, jnp, n_default=12_000, p_default=1_048_576,
            block_default=32, chain_default=1_024, device_store=True,
            mode_name="packed-device",
        )
    if mode != "dense":
        sys.exit(f"bench.py: unknown BENCH_MODE {mode!r}")

    from jwas_tpu.engine.mcmc import STEngineCfg, make_run_window, _init_accum, STData
    from jwas_tpu.engine.state import ChainState
    # dense f32 X (4.7 GB at these defaults)
    n = int(os.environ.get("BENCH_N", 12_000))
    p = int(os.environ.get("BENCH_P", 98_304))
    block = int(os.environ.get("BENCH_BLOCK", 256))
    nreps = int(os.environ.get("BENCH_NREPS", block))
    n_outer = int(os.environ.get("BENCH_OUTER", 4))
    dtype = jnp.float32

    t_setup = time.perf_counter()
    md, pm, y, tbv = _build_dense(jax, jnp, n, p, block, dtype)
    X, xpx, grams, valid = md.X, md.xpx, md.grams, md.valid
    p_pad = X.shape[1]
    print(f"# setup: {time.perf_counter() - t_setup:.1f}s", file=sys.stderr)

    K = 1
    W = jnp.ones((n, K), dtype)
    vary_analytic = float(0.01 * p * 0.42 + 1.0)

    use_pallas = _use_pallas()
    sync_every = int(os.environ.get("BENCH_SYNC", min(8, nreps)))
    nblocks = grams.shape[2]
    # group-sequential schedule: flat at p/n ~ 8 is past the stability
    # boundary (stability_sweep_r05.md)
    from jwas_tpu.ops import markers as _mk

    gb_dense = _mk.stable_group_blocks(n, block, nblocks)
    cfg = STEngineCfg(
        method="BayesC", n_obs=n, n_markers=p, n_loc=K,
        estimate_pi=True, estimate_marker_variance=True, estimate_scale=False,
        estimate_residual_variance=True, use_blocks=True, nreps=nreps,
        sync_every=sync_every,
        re_groups=(), df_residual=4.0, df_marker=4.0, has_weights=False,
        use_pallas=use_pallas,
        is_packed=False,
        group_blocks=gb_dense,
        scale_R=vary_analytic * 0.5,
    )
    data = STData(
        W=W, WtRinvW=(W.T @ W), rinv=jnp.ones((n,), dtype), y=y,
        X=X, xpx=xpx, grams=grams, valid=valid,
        Vinv=(), vc_scale=(),
        out_geno=jnp.zeros((0, p), dtype), out_W=jnp.zeros((0, K), dtype),
    )
    pi0 = jnp.where(valid > 0, 0.95, 1.0).astype(dtype)
    state = ChainState(
        key=jax.random.PRNGKey(42), sol=jnp.zeros((K,), dtype),
        alpha=jnp.zeros((p_pad,), dtype), beta=jnp.zeros((p_pad,), dtype),
        delta=jnp.where(valid > 0, 1, 0).astype(jnp.int32),
        gamma_l=jnp.ones((p_pad,), dtype),
        ycorr=y - W @ jnp.zeros((K,), dtype),
        vare=jnp.asarray(vary_analytic * 0.5, dtype),
        varg=jnp.asarray(0.01, dtype),
        pi=pi0,
        scale_g=jnp.asarray(0.005, dtype),
        vc=(),
    )

    run_window = make_run_window(cfg)
    accum = _init_accum(cfg, data, state)

    # warm-up / compile with the same static n_iters as the timed call
    t_c = time.perf_counter()
    state, accum, _ = run_window(state, data, accum, n_outer, accumulate=True)
    jax.block_until_ready(state.vare)
    print(f"# compile+warmup: {time.perf_counter() - t_c:.1f}s", file=sys.stderr)

    t0 = time.perf_counter()
    state, accum, out = run_window(state, data, accum, n_outer, accumulate=True)
    jax.block_until_ready(state.vare)
    dt = time.perf_counter() - t0

    effective_updates = p * nreps * n_outer
    rate = effective_updates / dt
    import numpy as _np

    ebv = X @ accum.alpha_m
    ebv_acc = float(_np.corrcoef(_np.asarray(ebv), _np.asarray(tbv))[0, 1])
    print(
        json.dumps(
            {
                "metric": "marker_updates_per_sec",
                "value": round(rate, 1),
                "unit": "updates/s",
                "vs_baseline": round(rate / BASELINE_UPDATES_PER_SEC, 2),
            }
        )
    )
    print(
        f"# mode={mode} n={n} p={p} block={block} nreps={nreps} sync={sync_every} "
        f"outer={n_outer} wall={dt:.2f}s sweeps/s={nreps*n_outer/dt:.2f} "
        f"vs_single_core_nonblock={rate/SINGLE_CORE_NONBLOCK:.0f}x "
        f"ebv_accuracy={ebv_acc:.3f} "
        f"pallas={use_pallas} device={jax.devices()[0]}",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
