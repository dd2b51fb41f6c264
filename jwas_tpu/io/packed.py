"""2-bit packed marker store (the reference's streaming backend).

From-scratch counterpart of the out-of-core 2-bit genotype backend
(reference: src/1.JWAS/src/markers/streaming_genotypes.jl): marker-major
2-bit codes (0/1/2 dosage, 3 = missing -> marker mean), a JSON manifest
sidecar, atomic publish, and a disk/memory guard. Differences by design:

- the packed matrix is resident in device memory and decoded to centered
  float32 tiles on device (jwas_tpu.ops.packed), instead of the reference's
  decode-one-marker-at-a-time CPU loop;
- the conversion hot loops (stats scan, packing, decode) run in C++
  (native/packer.cpp) loaded through ctypes, with a numpy fallback when the
  shared library cannot be built.

At p = 1M markers and n = 500k individuals the packed store is 125 GB vs
2 TB dense float32 (memory_usage.md:55-80) — shard the marker axis over
devices, or keep the store in pinned host memory (ops/grouped.py).
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import pandas as pd

_LIB = None
_LIB_TRIED = False


def native_build_dir() -> str:
    """`<checkout>/build`, where the native helpers (native/*.cpp) are
    compiled on first use: private to the checkout, created with mode 0700
    (a shared temporary directory would let another user plant a library)."""
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
    path = os.path.join(root, "build")
    os.makedirs(path, mode=0o700, exist_ok=True)
    return path


def _native_lib() -> Optional[ctypes.CDLL]:
    """Build (once, cached) and load the C++ packer via ctypes."""
    global _LIB, _LIB_TRIED
    if _LIB is not None or _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    src = os.path.join(os.path.dirname(__file__), "..", "..", "native", "packer.cpp")
    src = os.path.abspath(src)
    if not os.path.exists(src):
        return None
    lib_path = os.path.join(native_build_dir(), "libjwaspack.so")
    if (not os.path.exists(lib_path)
            or os.path.getmtime(lib_path) < os.path.getmtime(src)):
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-shared", "-fPIC", src, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, lib_path)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(lib_path)
    except OSError:
        return None
    i64, f32p, f64p, u8p, i64p = (
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.float32, flags="C"),
        np.ctypeslib.ndpointer(np.float64, flags="C"),
        np.ctypeslib.ndpointer(np.uint8, flags="C"),
        np.ctypeslib.ndpointer(np.int64, flags="C"),
    )
    lib.jwas_scan_stats.argtypes = [f32p, i64, i64, ctypes.c_float, f64p, f64p, i64p]
    lib.jwas_pack_2bit.argtypes = [f32p, i64, i64, ctypes.c_float, u8p]
    lib.jwas_scan_stats_accum.argtypes = [f32p, i64, i64, ctypes.c_float, f64p, i64p]
    lib.jwas_pack_tile_transposed.argtypes = [f32p, i64, i64, ctypes.c_float, u8p]
    lib.jwas_decode_markers.argtypes = [u8p, i64, i64, i64p, i64, f64p,
                                        ctypes.c_int, f32p]
    lib.jwas_packed_xtw.argtypes = [u8p, i64, i64, i64, f64p, f32p, f32p]
    _LIB = lib
    return _LIB


@dataclass
class Packed2BitStore:
    """Marker-major 2-bit packed genotypes (Packed2BitBackend analogue,
    streaming_genotypes.jl:7-25)."""

    obs_ids: List[str]
    marker_ids: List[str]
    packed: np.ndarray        # (p, ceil(n/4)) uint8
    means: np.ndarray         # (p,) float64, per-marker mean over non-missing
    allele_freq: np.ndarray   # (p,)
    n_obs: int
    n_markers: int
    # whether any 2-bit code is 3 (missing). Known at packing time and kept in
    # the manifest so startup never needs a second full-store scan; None for
    # stores from pre-flag manifests (callers fall back to a LUT scan).
    has_missing: Optional[bool] = None

    @property
    def bytes_per_marker(self) -> int:
        return (self.n_obs + 3) // 4

    @property
    def sum2pq(self) -> float:
        p = self.allele_freq
        return float(np.sum(2.0 * p * (1.0 - p)))

    def decode(self, cols: Sequence[int], center: bool = True) -> np.ndarray:
        """Centered float32 columns (n, len(cols)); missing -> mean."""
        cols = np.asarray(cols, dtype=np.int64)
        lib = _native_lib()
        if lib is not None:
            out = np.empty((len(cols), self.n_obs), dtype=np.float32)
            lib.jwas_decode_markers(
                np.ascontiguousarray(self.packed), self.n_obs,
                self.bytes_per_marker, cols, len(cols),
                np.ascontiguousarray(self.means), int(center),
                out.reshape(-1),
            )
            return out.T
        return _decode_numpy(self.packed, self.n_obs, cols, self.means, center)

    def save(self, path: str) -> None:
        """Write <path>.j2b + <path>.manifest.json with atomic publish
        (streaming_genotypes.jl:762-770)."""
        tmp = path + ".j2b.tmp"
        self.packed.tofile(tmp)
        manifest = {
            "format": "jwas_tpu-2bit-v1",
            "n_obs": self.n_obs,
            "n_markers": self.n_markers,
            "obs_ids": self.obs_ids,
            "marker_ids": self.marker_ids,
            "means": self.means.tolist(),
            "allele_freq": self.allele_freq.tolist(),
        }
        if self.has_missing is not None:
            manifest["has_missing"] = bool(self.has_missing)
        mtmp = path + ".manifest.json.tmp"
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, path + ".j2b")
        os.replace(mtmp, path + ".manifest.json")

    @staticmethod
    def load(path: str, mmap: bool = False) -> "Packed2BitStore":
        """mmap=True memory-maps the .j2b file instead of reading it into
        RAM: downstream staging (e.g. the grouped out-of-core builder's
        numpy -> pinned-host device_put) then streams pages straight from
        disk, so stores larger than free RAM remain loadable."""
        with open(path + ".manifest.json") as f:
            man = json.load(f)
        if man.get("format") != "jwas_tpu-2bit-v1":
            raise ValueError(f"unrecognized packed-store format in {path}")
        n, p = int(man["n_obs"]), int(man["n_markers"])
        bpm = (n + 3) // 4
        if mmap:
            packed = np.memmap(path + ".j2b", dtype=np.uint8, mode="r",
                               shape=(p * bpm,))
        else:
            packed = np.fromfile(path + ".j2b", dtype=np.uint8)
        if packed.size != p * bpm:
            raise ValueError("packed store size mismatch with manifest")
        return Packed2BitStore(
            obs_ids=[str(s) for s in man["obs_ids"]],
            marker_ids=[str(s) for s in man["marker_ids"]],
            packed=packed.reshape(p, bpm),
            means=np.asarray(man["means"], dtype=np.float64),
            allele_freq=np.asarray(man["allele_freq"], dtype=np.float64),
            n_obs=n,
            n_markers=p,
            has_missing=man.get("has_missing"),
        )


def _decode_numpy(packed, n, cols, means, center):
    rows = packed[np.asarray(cols, dtype=np.int64)]       # (k, bpm)
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)
    codes = (rows[:, :, None] >> shifts[None, None, :]) & 3
    codes = codes.reshape(len(cols), -1)[:, :n].astype(np.float32)   # (k, n)
    m = np.asarray(means, dtype=np.float32)[np.asarray(cols, dtype=np.int64)]
    x = np.where(codes == 3.0, m[:, None], codes)
    if center:
        x = x - m[:, None]
    return x.T


def prepare_packed_genotypes(
    file,
    *,
    separator: str = ",",
    header: bool = True,
    missing_value: float = 9.0,
    MAF: float = 0.0,
    save_path: Optional[str] = None,
    low_memory: bool = False,
    chunk_rows: int = 8192,
    disk_guard_ratio: float = 0.95,
) -> Packed2BitStore:
    """Convert genotypes (file/DataFrame/array) into a 2-bit packed store
    (prepare_streaming_genotypes, streaming_genotypes.jl:819-877).

    Default (dense) mode: one stats pass + one packing pass over an in-memory
    matrix, both in C++ when available. MAF > 0 drops low-frequency and fixed
    loci like the dense QC path.

    low_memory=True is the out-of-core mode (the reference's :lowmem path,
    streaming_genotypes.jl:658-789): the CSV is read twice in row chunks —
    pass 1 accumulates per-marker stats, pass 2 packs each 4-row-aligned chunk
    straight into its disjoint byte range of a disk-backed marker-major store
    (no row-major spool; no dense matrix is ever materialized). Peak memory is
    O(chunk_rows x p). Requires a file path input and save_path; the returned
    store's `packed` array is a read-only memmap of the published .j2b file.
    A disk guard rejects conversions that would exceed `disk_guard_ratio` of
    the free space on save_path's filesystem (streaming_genotypes.jl:167-202).
    """
    if low_memory:
        return _prepare_packed_low_memory(
            file, separator=separator, header=header,
            missing_value=missing_value, MAF=MAF, save_path=save_path,
            chunk_rows=chunk_rows, disk_guard_ratio=disk_guard_ratio,
        )
    from jwas_tpu.io.genotypes import _read_genotype_input

    obs_ids, marker_ids, mat = _read_genotype_input(file, separator, header,
                                                    np.float32)
    mat = np.ascontiguousarray(mat, dtype=np.float32)
    n, p = mat.shape
    means = np.empty(p, dtype=np.float64)
    freqs = np.empty(p, dtype=np.float64)
    nmiss = np.empty(p, dtype=np.int64)
    lib = _native_lib()
    if lib is not None:
        lib.jwas_scan_stats(mat, n, p, np.float32(missing_value), means, freqs, nmiss)
    else:
        miss = (mat == np.float32(missing_value)) | np.isnan(mat)
        cnt = np.maximum((~miss).sum(axis=0), 1)
        means[:] = np.where(miss, 0.0, mat).sum(axis=0) / cnt
        freqs[:] = means / 2.0
        nmiss[:] = miss.sum(axis=0)

    keep = np.ones(p, dtype=bool)
    if MAF > 0:
        var_proxy = freqs * (1.0 - freqs)
        keep = (freqs > MAF) & (freqs < 1 - MAF) & (var_proxy > 0)
    if not keep.all():
        mat = np.ascontiguousarray(mat[:, keep])
        means = means[keep]
        freqs = freqs[keep]
        nmiss = nmiss[keep]
        marker_ids = [m for m, k in zip(marker_ids, keep) if k]
        n, p = mat.shape

    bpm = (n + 3) // 4
    packed = np.zeros((p, bpm), dtype=np.uint8)
    if lib is not None:
        lib.jwas_pack_2bit(mat, n, p, np.float32(missing_value), packed.reshape(-1))
    else:
        codes = np.where(
            (mat == np.float32(missing_value)) | np.isnan(mat),
            3,
            np.clip(np.rint(mat), 0, 2),
        ).astype(np.uint8)                                # (n, p)
        packed = _pack_numpy(codes)
    store = Packed2BitStore(
        obs_ids=obs_ids,
        marker_ids=[str(m) for m in marker_ids],
        packed=packed,
        means=means,
        allele_freq=freqs,
        n_obs=n,
        n_markers=p,
        has_missing=bool(nmiss.sum() > 0),
    )
    if save_path:
        store.save(save_path)
    return store


def _iter_csv_chunks(file: str, separator: str, header: bool, chunk_rows: int):
    """Yield (obs_ids_chunk, float32 matrix chunk) over a genotype CSV."""
    reader = pd.read_csv(
        file, sep=separator, header=0 if header else None, chunksize=chunk_rows
    )
    for chunk in reader:
        ids = [str(x).strip() for x in chunk.iloc[:, 0]]
        yield ids, np.ascontiguousarray(chunk.iloc[:, 1:].to_numpy(np.float32))


def _prepare_packed_low_memory(
    file, *, separator, header, missing_value, MAF, save_path,
    chunk_rows, disk_guard_ratio,
) -> Packed2BitStore:
    """Two-pass out-of-core conversion; see prepare_packed_genotypes."""
    if not isinstance(file, str):
        raise TypeError("low_memory=True requires a genotype file path")
    if not save_path:
        raise ValueError("low_memory=True requires save_path")
    chunk_rows = max(4, (int(chunk_rows) // 4) * 4)  # 4-row-aligned chunks

    # --- pass 1: header + per-marker stats (means, freqs, missing) ---
    head = pd.read_csv(file, sep=separator, header=0 if header else None, nrows=1)
    if header:
        marker_ids = [str(c) for c in head.columns[1:]]
    else:
        marker_ids = [str(i + 1) for i in range(head.shape[1] - 1)]
    p = len(marker_ids)

    lib = _native_lib()
    sums = np.zeros(p, dtype=np.float64)
    nmiss = np.zeros(p, dtype=np.int64)
    obs_ids: List[str] = []
    for ids, mat in _iter_csv_chunks(file, separator, header, chunk_rows):
        obs_ids.extend(ids)
        if lib is not None:
            lib.jwas_scan_stats_accum(
                mat, mat.shape[0], p, np.float32(missing_value), sums, nmiss
            )
        else:
            miss = (mat == np.float32(missing_value)) | np.isnan(mat)
            sums += np.where(miss, 0.0, mat).sum(axis=0, dtype=np.float64)
            nmiss += miss.sum(axis=0)
    n = len(obs_ids)
    cnt = np.maximum(n - nmiss, 1)
    means = sums / cnt
    freqs = means / 2.0

    keep = np.ones(p, dtype=bool)
    if MAF > 0:
        var_proxy = freqs * (1.0 - freqs)
        keep = (freqs > MAF) & (freqs < 1 - MAF) & (var_proxy > 0)
    kept_idx = np.flatnonzero(keep)
    p_keep = int(kept_idx.size)
    kept_marker_ids = [marker_ids[int(j)] for j in kept_idx]

    # --- disk guard (streaming_genotypes.jl:167-202) ---
    bpm = (n + 3) // 4
    need = p_keep * bpm
    free = os.statvfs(os.path.dirname(os.path.abspath(save_path)) or ".").f_bavail
    free *= os.statvfs(os.path.dirname(os.path.abspath(save_path)) or ".").f_frsize
    if need > disk_guard_ratio * free:
        raise RuntimeError(
            f"packed store needs {need/1e9:.2f} GB but only {free/1e9:.2f} GB "
            f"free (disk_guard_ratio={disk_guard_ratio}); free space or lower MAF"
        )

    # --- pass 2: pack 4-aligned row chunks into disjoint byte ranges ---
    tmp = save_path + ".j2b.tmp"
    mm = np.memmap(tmp, dtype=np.uint8, mode="w+", shape=(p_keep, bpm))
    row0 = 0
    for _, mat in _iter_csv_chunks(file, separator, header, chunk_rows):
        rows = mat.shape[0]
        if p_keep != p:
            mat = np.ascontiguousarray(mat[:, kept_idx])
        bpt = (rows + 3) // 4
        tile = np.empty((p_keep, bpt), dtype=np.uint8)
        if lib is not None:
            lib.jwas_pack_tile_transposed(
                mat, rows, p_keep, np.float32(missing_value), tile.reshape(-1)
            )
        else:
            codes = np.where(
                (mat == np.float32(missing_value)) | np.isnan(mat),
                3, np.clip(np.rint(mat), 0, 2),
            ).astype(np.uint8)
            tile = _pack_numpy(codes)
        b0 = row0 // 4
        mm[:, b0 : b0 + bpt] = tile
        row0 += rows
    mm.flush()
    del mm

    # --- atomic publish: manifest first to tmp, then both renamed ---
    manifest = {
        "format": "jwas_tpu-2bit-v1",
        "n_obs": n,
        "n_markers": p_keep,
        "obs_ids": obs_ids,
        "marker_ids": kept_marker_ids,
        "means": means[keep].tolist(),
        "allele_freq": freqs[keep].tolist(),
        "has_missing": bool(nmiss[keep].sum() > 0),
    }
    mtmp = save_path + ".manifest.json.tmp"
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, save_path + ".j2b")
    os.replace(mtmp, save_path + ".manifest.json")

    return Packed2BitStore(
        obs_ids=obs_ids,
        marker_ids=kept_marker_ids,
        packed=np.memmap(save_path + ".j2b", dtype=np.uint8, mode="r",
                         shape=(p_keep, bpm)),
        means=means[keep],
        allele_freq=freqs[keep],
        n_obs=n,
        n_markers=p_keep,
        has_missing=bool(nmiss[keep].sum() > 0),
    )


def _pack_numpy(codes: np.ndarray) -> np.ndarray:
    """Pack (n, p) uint8 codes into (p, ceil(n/4)) marker-major bytes."""
    n, p = codes.shape
    bpm = (n + 3) // 4
    padded = np.zeros((bpm * 4, p), dtype=np.uint8)
    padded[:n] = codes
    quads = padded.reshape(bpm, 4, p)
    out = (
        quads[:, 0, :]
        | (quads[:, 1, :] << np.uint8(2))
        | (quads[:, 2, :] << np.uint8(4))
        | (quads[:, 3, :] << np.uint8(6))
    )
    return np.ascontiguousarray(out.T)
