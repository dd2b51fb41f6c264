"""Which accelerator the process runs on, and what follows from it.

One place for every decision that depends on the backend:

- `kernel_available()`: whether a compiled inner-round kernel exists for
  the default backend (the Pallas Triton kernels of ops/pallas_sweep.py run
  on NVIDIA GPUs only);
- `resolve_use_pallas(flag)`: "auto" picks the kernel where one is compiled;
  True where none is raises (the kernel never silently runs interpreted);
- `device_memory_bytes(device)`: the memory budget of one device, read from
  the runtime. An accelerator that reports no `bytes_limit` is an error; the
  CPU backend, which reports none, uses `JWAS_HBM_BYTES` or 16 GiB;
- `enable_compile_cache()`: the persistent compilation cache.
"""

from __future__ import annotations

import os

import jax

_CPU_DEFAULT_BYTES = 16 * 1024**3
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def kernel_available() -> bool:
    """True when the default backend has a compiled inner-round kernel."""
    return jax.default_backend() == "gpu"


def resolve_use_pallas(flag) -> bool:
    """Resolve the `use_pallas` option: "auto" -> the compiled kernel when
    the backend has one; True -> the kernel, or ValueError where none
    exists; False -> the XLA scan."""
    if flag == "auto":
        return kernel_available()
    if flag and not kernel_available():
        raise ValueError(
            f"use_pallas=True: no compiled inner-round kernel exists for the "
            f"{jax.default_backend()!r} backend (the Pallas kernels run on "
            f"NVIDIA GPUs); use use_pallas='auto' or False"
        )
    return bool(flag)


def device_memory_bytes(device=None) -> int:
    """Memory budget of `device` (default: the first local device)."""
    dev = device if device is not None else jax.local_devices()[0]
    stats = dev.memory_stats() or {}
    limit = int(stats.get("bytes_limit", 0) or 0)
    if limit:
        return limit
    if dev.platform == "cpu":
        return int(float(os.environ.get("JWAS_HBM_BYTES", _CPU_DEFAULT_BYTES)))
    raise RuntimeError(
        f"device {dev} ({dev.platform}) reports no memory_stats()"
        f"['bytes_limit']; cannot size the marker store for it"
    )


def enable_compile_cache() -> str | None:
    """Turn on JAX's persistent compilation cache.

    If JAX_COMPILATION_CACHE_DIR is set (or the cache directory was already
    configured), JAX's own setting stands and nothing is changed. Otherwise
    the cache lives at `<checkout>/.jax_cache`, a fixed path so that later
    processes find their entries. Returns the directory in use (None when
    the checkout is not writable)."""
    current = jax.config.jax_compilation_cache_dir
    if os.environ.get("JAX_COMPILATION_CACHE_DIR") or current:
        return os.environ.get("JAX_COMPILATION_CACHE_DIR") or current
    if not os.access(_CHECKOUT, os.W_OK):
        return None
    path = os.path.join(_CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
