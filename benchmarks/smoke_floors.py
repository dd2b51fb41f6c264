"""Accuracy floors for chip_smoke.py from a CPU run of the same phases.

Runs chip_smoke.py's runMCMC phases (A, B, C, D and the 2x2 mesh data set)
on the CPU backend with the same seeds, sizes and chain settings, and prints
each EBV accuracy beside the floor it implies (accuracy - 0.05) and each
posterior-mean h2 beside the band it implies (h2 +- 0.1). chip_smoke.FLOORS
and chip_smoke.H2_BANDS are taken from a full-size run of this script.

Usage (from the repository root):
  JAX_PLATFORMS=cpu python benchmarks/smoke_floors.py             full size
  JAX_PLATFORMS=cpu python benchmarks/smoke_floors.py --scale 0.05 rehearsal
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="multiply every n and p by this factor")
    ap.add_argument("--only", default="A,B,C,D,four_b")
    args = ap.parse_args()
    if jax.default_backend() != "cpu":
        sys.exit("smoke_floors: run with JAX_PLATFORMS=cpu")
    cs.SIZES = {k: (max(64, int(n * args.scale)), max(256, int(p * args.scale)),
                    max(5, int(q * args.scale)), seed)
                for k, (n, p, q, seed) in cs.SIZES.items()}
    cs.FLOORS = {k: ((-1.0, -1.0) if k == "D" else -1.0) for k in cs.FLOORS}
    cs.H2_BANDS = {k: None for k in cs.H2_BANDS}

    def four_b():
        X, pheno, bv = cs.simulate(*cs.SIZES["four_b"][:3],
                                   seed=cs.SIZES["four_b"][3])
        return cs.check_st("four_b", cs.run_st(X, pheno, "BayesC"), bv, -1.0)

    phases = {"A": cs.phase_A, "B": cs.phase_B, "C": cs.phase_C,
              "D": cs.phase_D, "four_b": four_b}
    print(f"sizes {cs.SIZES}")
    for name in args.only.split(","):
        t0 = time.perf_counter()
        res = phases[name]()
        if name == "D":
            accs, h2 = res, None
        else:
            (acc, h2), accs = res, [res[0]]
        print(f"{name}: accuracy {[round(a, 4) for a in accs]} -> floor "
              f"{[round(a - 0.05, 2) for a in accs]}"
              + ("" if h2 is None else
                 f"; h2 {h2:.4f} -> band ({h2 - 0.1:.2f}, {h2 + 0.1:.2f})")
              + f" ({time.perf_counter() - t0:.0f}s)", flush=True)


if __name__ == "__main__":
    main()
