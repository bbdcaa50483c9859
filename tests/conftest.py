import os

# The suite runs on the CPU, never on an accelerator the machine may have:
# the numerics need f64, the multi-device sharding paths are validated on a
# virtual 8-device CPU mesh, and several test workers must not each reserve
# an accelerator's memory.  The platform is forced through jax.config as
# well as the environment, because jax may already have been imported by
# the time this file runs.  Only an explicit request for the GPU
# (JAX_PLATFORMS=cuda,cpu, used with `-m gpu` in one process) keeps it.
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()
_platforms = os.environ.get("JAX_PLATFORMS", "")
if "cuda" not in _platforms and "gpu" not in _platforms:
    _platforms = "cpu"
os.environ["JAX_PLATFORMS"] = _platforms

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", _platforms)
jax.config.update("jax_enable_x64", True)

# persistent compile cache: the suite is dominated by XLA compiles of the
# bucketed engine programs, whose shapes recur across runs
from dolfinx_eqlb_tpu.utils.compile_cache import (  # noqa: E402
    configure_compile_cache,
)

configure_compile_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; skipped elsewhere (chip_smoke.py runs "
        "these paths on the card)",
    )


@pytest.fixture
def gpu_device():
    """The first GPU device, or a skip.  Decided here, at run time, never
    at import: every test worker must collect the same tests.  Tests that
    use it must run in one process (not under xdist workers), because each
    JAX process reserves most of the card's memory."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("no GPU: this path is covered on the card by chip_smoke.py")
    return devices[0]
