"""Pedigree engine: topological coding, inbreeding, and the sparse A-inverse.

From-scratch reimplementation of the capabilities of the reference pedigree
module (reference: src/2.PedModule/src/PedModule.jl):

- `get_pedigree` parses a pedigree file/DataFrame, assigns a topological code
  to every individual (parents before offspring), and computes inbreeding
  coefficients.
- `Pedigree.a_inverse()` builds the inverse numerator-relationship matrix with
  Henderson's rules, as the sparse triple product hAi' hAi
  (PedModule.jl:167-219).

Differences from the reference by design:
- All algorithms are iterative (no recursion), so very deep pedigrees do not
  hit stack limits.
- Inbreeding uses the Meuwissen & Luo (1992) algorithm instead of a memoised
  recursive additive-relationship dictionary; results are identical.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set

import numpy as np
import pandas as pd
import scipy.sparse as sp

MISSING = "missing"


@dataclass
class Pedigree:
    """Coded pedigree with inbreeding coefficients.

    ids: individual IDs in topological (coding) order — the row/col order of A.
    sire / dam: integer arrays of parent codes (0-based), -1 for unknown.
    inbreeding: F coefficients per individual, same order as `ids`.
    """

    ids: List[str]
    sire: np.ndarray
    dam: np.ndarray
    inbreeding: np.ndarray
    id_index: Dict[str, int] = field(default_factory=dict)
    # Partition bookkeeping for single-step analyses (forSSBR.jl analogue):
    set_nongenotyped: Set[str] = field(default_factory=set)
    set_genotyped: Set[str] = field(default_factory=set)

    def __post_init__(self):
        if not self.id_index:
            self.id_index = {s: i for i, s in enumerate(self.ids)}

    def __len__(self):
        return len(self.ids)

    @property
    def n(self) -> int:
        return len(self.ids)

    def a_inverse(self) -> sp.csc_matrix:
        """A^-1 via Henderson's rules with inbreeding (PedModule.jl:174-219).

        Builds the half-stored factor hAi with rows
          d * (e_i - 0.5 e_sire - 0.5 e_dam)
        where d = sqrt(4 / (2 - F_s - F_d)) (both parents), and the analogous
        one-parent / no-parent forms, then returns hAi' hAi.
        """
        hAi = self.a_inverse_factor()
        return (hAi.T @ hAi).tocsc()

    def a_inverse_factor(self) -> sp.csc_matrix:
        """The Henderson factor hAi with A^-1 = hAi' hAi (PedModule.jl:174-219).

        Exposed separately because the sparse location-MME sampler
        (ops/sparse_mme.py) needs a factor F of every random-effect
        precision (Vinv = F'F) for exact perturbation-optimization draws;
        for single-step's A_nn epsilon term the factor is the column slice
        hAi[:, nongenotyped] since (U'U)[nn] = U[:, nn]' U[:, nn].
        """
        n = self.n
        rows: List[int] = []
        cols: List[int] = []
        vals: List[float] = []
        F = self.inbreeding
        for i in range(n):
            s, d = int(self.sire[i]), int(self.dam[i])
            if s >= 0 and d >= 0:
                dd = np.sqrt(4.0 / (2.0 - F[s] - F[d]))
                rows += [i, i, i]
                cols += [s, d, i]
                vals += [-0.5 * dd, -0.5 * dd, dd]
            elif s >= 0:
                dd = np.sqrt(4.0 / (3.0 - F[s]))
                rows += [i, i]
                cols += [s, i]
                vals += [-0.5 * dd, dd]
            elif d >= 0:
                dd = np.sqrt(4.0 / (3.0 - F[d]))
                rows += [i, i]
                cols += [d, i]
                vals += [-0.5 * dd, dd]
            else:
                rows.append(i)
                cols.append(i)
                vals.append(1.0)
        return sp.csc_matrix((vals, (rows, cols)), shape=(n, n))

    def a_matrix(self) -> np.ndarray:
        """Dense numerator relationship matrix A (tabular method).

        For testing and small problems only (O(n^2) memory).
        """
        n = self.n
        A = np.zeros((n, n))
        for i in range(n):
            s, d = int(self.sire[i]), int(self.dam[i])
            a_sd = A[s, d] if (s >= 0 and d >= 0) else 0.0
            A[i, i] = 1.0 + 0.5 * a_sd
            for j in range(i):
                a_js = A[j, s] if s >= 0 else 0.0
                a_jd = A[j, d] if d >= 0 else 0.0
                A[i, j] = A[j, i] = 0.5 * (a_js + a_jd)
        return A


def _topological_codes(
    parents: Dict[str, tuple], order_hint: Sequence[str]
) -> Dict[str, int]:
    """Assign codes so every parent precedes its offspring.

    Iterative version of the recursive `code!` (PedModule.jl:79-94).
    """
    codes: Dict[str, int] = {}
    next_code = 0
    for start in order_hint:
        if start in codes:
            continue
        stack = [start]
        while stack:
            node = stack[-1]
            if node in codes:
                stack.pop()
                continue
            s, d = parents.get(node, (MISSING, MISSING))
            pending = [p for p in (s, d) if p != MISSING and p not in codes]
            if pending:
                stack.extend(pending)
            else:
                codes[node] = next_code
                next_code += 1
                stack.pop()
    return codes


_PED_LIB = None
_PED_LIB_TRIED = False


def _native_ped_lib():
    """Build (once, cached) and load the C++ pedigree kernel via ctypes
    (native/pedigree.cpp; same loader pattern as io/packed.py)."""
    global _PED_LIB, _PED_LIB_TRIED
    if _PED_LIB is not None or _PED_LIB_TRIED:
        return _PED_LIB
    _PED_LIB_TRIED = True
    import ctypes
    import os
    import subprocess

    from jwas_tpu.io.packed import native_build_dir

    src = os.path.abspath(os.path.join(
        os.path.dirname(__file__), "..", "..", "native", "pedigree.cpp"
    ))
    if not os.path.exists(src):
        return None
    lib_path = os.path.join(native_build_dir(), "libjwasped.so")
    if (not os.path.exists(lib_path)
            or os.path.getmtime(lib_path) < os.path.getmtime(src)):
        # OpenMP build first; a toolchain without it falls back to the
        # sequential build (identical results, single-threaded)
        built = False
        for flags in (["-O3", "-fopenmp"], ["-O3"]):
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            cmd = ["g++", *flags, "-shared", "-fPIC", src, "-o", tmp]
            try:
                subprocess.run(cmd, check=True, capture_output=True,
                               timeout=120)
                os.replace(tmp, lib_path)
                built = True
                break
            except Exception:
                continue
        if not built:
            return None
    try:
        lib = ctypes.CDLL(lib_path)
    except OSError:
        return None
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
    lib.jwas_inbreeding_ml.argtypes = [i64p, i64p, ctypes.c_int64, f64p]
    lib.jwas_inbreeding_ml_eps.argtypes = [i64p, i64p, ctypes.c_int64,
                                           ctypes.c_double, f64p]
    _PED_LIB = lib
    return _PED_LIB


def _inbreeding_meuwissen_luo(sire: np.ndarray, dam: np.ndarray,
                              tolerance: float = 0.0) -> np.ndarray:
    """Inbreeding coefficients for a topologically coded pedigree.

    Meuwissen & Luo (1992). Equivalent to the reference's memoised recursive
    `calcInbreeding!`/`calcAddRel!` (PedModule.jl:117-165). Dispatches to
    the C++ kernel (native/pedigree.cpp) when available — the per-animal
    ancestor walk is a scalar pointer chase, ~30x faster native, which is
    what makes 1e5+-animal single-step pedigrees practical to load."""
    lib = _native_ped_lib()
    if lib is not None:
        F = np.zeros(len(sire), dtype=np.float64)
        lib.jwas_inbreeding_ml_eps(
            np.ascontiguousarray(sire, dtype=np.int64),
            np.ascontiguousarray(dam, dtype=np.int64),
            len(sire), float(tolerance), F,
        )
        return F
    if tolerance:
        raise ValueError(
            "inbreeding_tolerance requires the native pedigree kernel "
            "(native/pedigree.cpp failed to build)"
        )
    return _inbreeding_meuwissen_luo_py(sire, dam)


def _inbreeding_meuwissen_luo_py(sire: np.ndarray, dam: np.ndarray) -> np.ndarray:
    """Pure-Python fallback (and the native kernel's test oracle)."""
    n = len(sire)
    F = np.zeros(n)
    # D[j] = 0.5 - 0.25 (F_s + F_d), with F = -1 for an unknown parent.
    for i in range(n):
        s, d = int(sire[i]), int(dam[i])
        if s < 0 or d < 0:
            F[i] = 0.0
            continue
        # Accumulate F_i = sum_j L_j^2 D_j - 1 over ancestors j of i.
        L: Dict[int, float] = {i: 1.0}
        heap = [-i]
        visited = set()
        f_acc = -1.0
        while heap:
            j = -heapq.heappop(heap)
            if j in visited:
                continue
            visited.add(j)
            Lj = L.pop(j)
            sj, dj = int(sire[j]), int(dam[j])
            fs = F[sj] if sj >= 0 else -1.0
            fd = F[dj] if dj >= 0 else -1.0
            Dj = 0.5 - 0.25 * (fs + fd)
            f_acc += Lj * Lj * Dj
            for p in (sj, dj):
                if p >= 0:
                    if p in L:
                        L[p] += 0.5 * Lj
                    else:
                        L[p] = 0.5 * Lj
                        heapq.heappush(heap, -p)
        F[i] = f_acc
    return F


def get_pedigree(
    pedfile,
    header: bool = False,
    separator: str = ",",
    missingstring: Sequence[str] = ("0",),
    inbreeding_tolerance: float = 0.0,
) -> Pedigree:
    """Load a pedigree from a CSV file or DataFrame (id, sire, dam).

    Mirrors `get_pedigree` (PedModule.jl:22-58): individuals referenced only as
    parents get founder entries; IDs are coded topologically; inbreeding is
    computed for everyone.

    inbreeding_tolerance: truncate each Meuwissen-Luo ancestor walk at path
    coefficients below this value (0 = exact, the default). Deep complete
    pedigrees (50+ generations, every ancestor recorded) make the exact
    walk O(all ancestors) per animal; 1e-8 bounds the per-animal F error
    below ~1e-10 while capping the walk at ~27 generations — at the 500k-
    animal single-step flagship scale this is the difference between
    minutes and hours.
    """
    if isinstance(pedfile, pd.DataFrame):
        df = pedfile.iloc[:, :3].astype(str)
    else:
        df = pd.read_csv(
            pedfile,
            sep=separator,
            header=0 if header else None,
            dtype=str,
        ).iloc[:, :3]
    missing_set = set(missingstring) | {"", "nan", "NaN", MISSING}

    cols = [df.iloc[:, k].astype(str).str.strip() for k in range(3)]
    for c in cols:
        c[c.isin(missing_set)] = MISSING
    parents: Dict[str, tuple] = {}
    order_hint: List[str] = []
    for ind, s, d in zip(cols[0].tolist(), cols[1].tolist(),
                         cols[2].tolist()):
        if ind == MISSING:
            continue
        for p in (s, d):
            if p != MISSING and p not in parents:
                parents[p] = (MISSING, MISSING)
                order_hint.append(p)
        parents[ind] = (s, d)
        order_hint.append(ind)

    codes = _topological_codes(parents, order_hint)
    n = len(codes)
    ids: List[Optional[str]] = [None] * n
    for name, c in codes.items():
        ids[c] = name
    sire = np.full(n, -1, dtype=np.int64)
    dam = np.full(n, -1, dtype=np.int64)
    for name, (s, d) in parents.items():
        c = codes[name]
        if s != MISSING:
            sire[c] = codes[s]
        if d != MISSING:
            dam[c] = codes[d]
    inbreeding = _inbreeding_meuwissen_luo(sire, dam,
                                           tolerance=inbreeding_tolerance)
    return Pedigree(ids=list(ids), sire=sire, dam=dam, inbreeding=inbreeding)


def get_info(ped: Pedigree, Ai: bool = False):
    """Print pedigree summary; optionally return (IDs, A-inverse, inbreeding).

    Mirrors `get_info` (PedModule.jl:289-305).
    """
    n = ped.n
    sires = set(int(s) for s in ped.sire if s >= 0)
    dams = set(int(d) for d in ped.dam if d >= 0)
    founders = int(np.sum((ped.sire < 0) | (ped.dam < 0)))
    print("Pedigree information:")
    print(f"#individuals: {n}")
    print(f"#sires:       {len(sires)}")
    print(f"#dams:        {len(dams)}")
    print(f"#founders:    {founders}")
    if Ai:
        return ped.ids, ped.a_inverse(), ped.inbreeding
    return None
