"""Inner-round kernel efficiency on the GPU: the XLA scan against the Pallas
(Triton route) kernel on the same fast-blocks computation and draws.

For every shape the engine dispatches it prints the time of one call of
each implementation, the time per strictly sequential step (nreps * b
steps per call), the agreement of the two on the same draws, and the
kernel's share of a bandwidth yardstick: each step reads one Gram row of
every block, bytes = 4 * nreps * b^2 * nblocks, over the card's peak
bandwidth. The chain is latency-bound (each step depends on the last), so
that share is small by nature; it is reported to show how far the kernel
is from the memory system, not as a target.

It then times the 2-bit GEMVs that form each right-hand side (X' w) and
update the residual (X v): the flat packed store (ops/packed.py) and the
grouped store's bit-plane GEMVs (ops/grouped.py), in bytes/s of packed
store read against the card's peak. These are memory-bound.

Last, end to end: chip_smoke.py's phase A (BayesC, n=10,000 x p=50,000,
dense, through runMCMC) with the XLA scan and with the kernel, in turns
(XLA, kernel, kernel, XLA), in seconds with compilation subtracted.

Run on a GPU from the repository root:  python benchmarks/kernel_efficiency.py
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Peak device-memory bandwidth by jax device_kind (NVIDIA data sheets, SXM
# parts). A device that is not listed is an error, not a default.
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}

SHAPES = (
    # (method, b, blocks, reps per call)
    ("abc", 128, 128, 32),       # north-star group, one sync round
    ("abc", 128, 128, 128),      # north-star group, one full visit
    ("abc", 24, 128, 8),         # 2-bit grouped store at n=10k
    ("abc", 128, 23, 8),         # dense grouped at n=10k
    ("bayesr", 128, 23, 8),
    ("bayesr", 128, 128, 32),
)


def gemv_cases(peak, n=12_000, p=1_048_576, b=32, gb=128):
    """bytes/s of the 2-bit GEMVs over a p x n store (3.1 GB at the
    defaults: the device-resident configuration of bench.py's packed
    mode)."""
    import jax
    import jax.numpy as jnp

    import chip_smoke as cs
    from jwas_tpu.ops import grouped as gr
    from jwas_tpu.ops import packed as pk

    bpm = -(-n // 4)
    G = b * gb
    key = jax.random.PRNGKey(0)
    store = jax.random.randint(key, (p, bpm), 0, 256, jnp.int32).astype(
        jnp.uint8)
    means = jnp.full((p,), 1.0, jnp.float32)
    w = jax.random.normal(jax.random.fold_in(key, 1), (n,))
    v = jax.random.normal(jax.random.fold_in(key, 2), (p,))
    grams = jnp.zeros((b, b, 1), jnp.float32)
    pm = pk.PackedMarkers(store, means, None, means, grams, means)
    gm = gr.GroupedPackedMarkers(store.reshape(p // G, G, bpm), means, None,
                                 means, grams, means)
    cases = {
        "flat packed_rhs (X'w)": lambda: pk.packed_rhs(pm, w),
        "flat packed_matvec (Xv)": lambda: pk.packed_matvec(pm, v, n_obs=n),
        "grouped_rhs planes (X'w)": lambda: gr.grouped_rhs(
            gm, w, has_missing=False),
        "grouped_matvec planes (Xv)": lambda: gr.grouped_matvec(
            gm, v, n_obs=n, has_missing=False),
    }
    nbytes = p * bpm + 4 * (n + p)
    for name, fn in cases.items():
        _, t = cs.time_call(fn)
        print(json.dumps({
            "gemv": name, "n": n, "p": p, "store_GB": round(p * bpm / 1e9, 3),
            "ms": round(t * 1e3, 3), "GB_per_s": round(nbytes / t / 1e9, 1),
            "pct_of_peak_bandwidth": round(100 * nbytes / t / peak, 1),
        }), flush=True)


def end_to_end():
    import time

    import chip_smoke as cs

    clock = cs.CompileClock()
    X, pheno, bv = cs.data_50k()
    for use_pallas in (False, True, True, False):
        c0, _ = clock.snapshot()
        t0 = time.perf_counter()
        out = cs.run_st(X, pheno, "BayesC", use_pallas=use_pallas)
        wall = time.perf_counter() - t0
        compile_s = clock.snapshot()[0] - c0
        print(json.dumps({
            "end_to_end": "phase A runMCMC", "kernel": use_pallas,
            "wall_s": round(wall, 2), "compile_s": round(compile_s, 2),
            "wall_minus_compile_s": round(wall - compile_s, 2),
            "ebv_accuracy": round(cs.ebv_accuracy(out, bv)[0], 4),
        }), flush=True)


def main():
    import jax

    import chip_smoke as cs

    if jax.default_backend() != "gpu":
        sys.exit("kernel_efficiency: no GPU")
    kind = jax.devices()[0].device_kind
    if kind not in PEAK_BYTES_PER_S:
        raise KeyError(f"no peak bandwidth recorded for device {kind!r}")
    peak = PEAK_BYTES_PER_S[kind]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"# card: {card}; device_kind={kind}; peak {peak / 1e12:.2f} TB/s")
    for method, b, nb, reps in SHAPES:
        t_x, t_k, err, agree = cs.compare_inner_rounds(method, b, nb, reps)
        steps = reps * b
        bound = 4.0 * reps * b * b * nb / peak
        print(json.dumps({
            "method": method, "b": b, "blocks": nb, "reps": reps,
            "xla_us": round(t_x * 1e6, 1), "kernel_us": round(t_k * 1e6, 1),
            "xla_us_per_step": round(t_x / steps * 1e6, 3),
            "kernel_us_per_step": round(t_k / steps * 1e6, 3),
            "speedup": round(t_x / t_k, 2),
            "kernel_pct_of_bandwidth_bound": round(100 * bound / t_k, 2),
            "max_rel_err": err, "delta_agreement": agree,
        }), flush=True)
    gemv_cases(peak)
    end_to_end()


if __name__ == "__main__":
    main()
