import os

import pytest

# Run the test suite on a virtual 8-device CPU mesh so sharding paths are
# exercised without accelerator hardware (SURVEY.md §4: the multi-host test
# story). The platform is pinned in jax.config as well as by JAX_PLATFORMS,
# so a machine with a GPU still runs these tests on the CPU; GPU behaviour
# is checked by chip_smoke.py.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# The persistent compilation cache stays off here: the test workers (and
# the processes some tests start) would share one cache directory.
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _restore_x64():
    """runMCMC(double_precision=True) and the parity replay turn float64 on
    for the whole process; put the flag back after each test so that the
    next test in the same worker runs in float32 as written."""
    before = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", before)
