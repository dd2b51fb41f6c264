"""Device-memory guardrails for the marker path.

From-scratch equivalent of the reference memory guard (reference:
src/1.JWAS/src/tools4genotypes.jl:99-235, invoked from JWAS.jl:414-459):
estimate the marker-path bytes before compiling the chain and error/warn when
they exceed `memory_guard_ratio` of the accelerator's memory.

The budget is the memory of one device, `bytes_limit` of its
`memory_stats()` (utils/backend.device_memory_bytes; only the CPU backend,
which reports none, falls back to `JWAS_HBM_BYTES` or 16 GiB), and the
estimate covers the device-resident arrays our engines actually stage: the
dense centered genotype matrix (padded), the per-block Gram stack of the
fast-blocks sweep, the output-genotype rows, and the location design.
"""

from __future__ import annotations

from dataclasses import dataclass


def format_bytes_human(nbytes: float) -> str:
    """Human-readable byte count (format_bytes_human, tools4genotypes.jl)."""
    units = ["B", "KiB", "MiB", "GiB", "TiB"]
    x = float(nbytes)
    for u in units:
        if abs(x) < 1024.0 or u == units[-1]:
            return f"{x:.2f} {u}"
        x /= 1024.0
    return f"{x:.2f} TiB"


@dataclass(frozen=True)
class MarkerMemoryEstimate:
    bytes_genotypes: int
    bytes_grams: int
    bytes_output: int
    bytes_design: int

    @property
    def bytes_total(self) -> int:
        return (
            self.bytes_genotypes + self.bytes_grams + self.bytes_output
            + self.bytes_design
        )


def estimate_marker_memory(
    n_obs: int,
    n_markers: int,
    n_traits: int = 1,
    block_size: int = 0,
    n_out: int = 0,
    n_loc: int = 0,
    itemsize: int = 4,
    packed: bool = False,
) -> MarkerMemoryEstimate:
    """Estimate device bytes of the marker path (estimate_marker_memory,
    tools4genotypes.jl:99-160, re-derived for our engine's buffers).

    packed=True: the genotype matrix is the 2-bit store (2 bits/entry) instead
    of dense float."""
    p = n_markers
    if block_size:
        nblocks = -(-p // block_size)
        p_pad = nblocks * block_size
        bytes_grams = block_size * block_size * nblocks * itemsize
    else:
        p_pad = p
        bytes_grams = 0
    geno_bytes = (p_pad * ((n_obs + 3) // 4)) if packed else n_obs * p_pad * itemsize
    return MarkerMemoryEstimate(
        bytes_genotypes=geno_bytes,
        bytes_grams=bytes_grams,
        bytes_output=n_out * p * itemsize * n_traits,
        bytes_design=n_obs * n_traits * n_loc * itemsize,
    )


def check_marker_memory_guard(
    estimate: MarkerMemoryEstimate,
    policy: str = "warn",
    ratio: float = 0.9,
    total_bytes: int | None = None,
) -> None:
    """Enforce the guard (check_marker_memory_guard!, tools4genotypes.jl:162-235).

    policy: "error" | "warn" | "off".
    """
    if policy not in ("error", "warn", "off"):
        raise ValueError("memory_guard must be 'error', 'warn', or 'off'")
    if policy == "off":
        return
    if total_bytes is None:
        from jwas_tpu.utils.backend import device_memory_bytes

        total_bytes = device_memory_bytes()
    budget = total_bytes
    limit = ratio * budget
    if estimate.bytes_total <= limit:
        return
    msg = (
        f"estimated marker-path device memory {format_bytes_human(estimate.bytes_total)} "
        f"(genotypes {format_bytes_human(estimate.bytes_genotypes)}, "
        f"block Grams {format_bytes_human(estimate.bytes_grams)}, "
        f"output rows {format_bytes_human(estimate.bytes_output)}) exceeds "
        f"{ratio:.0%} of device memory {format_bytes_human(budget)}; "
        "reduce fast_blocks block size, use storage='int8' or '2bit', or shard over more devices"
    )
    if policy == "error":
        raise MemoryError(msg)
    import warnings

    warnings.warn(msg)
