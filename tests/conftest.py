"""Test configuration: everything runs on a virtual 8-device CPU mesh.

SURVEY.md §4: the CPU backend is our "WARP fake backend"; multi-device
tests fake a mesh with xla_force_host_platform_device_count. Must run
before jax is imported anywhere.

Tests marked `gpu` need an NVIDIA card (compiled Pallas/Triton kernels);
they skip here with a reason, and `python chip_smoke.py` runs what they
check on the card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402

from drts_tpu.utils import cache  # noqa: E402

# Persistent compile cache (JAX_COMPILATION_CACHE_DIR, else the checkout's
# .cache/jax): the suite is dominated by full-frame-graph XLA CPU compiles,
# and re-runs hit the cache.
cache.enable_compile_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (compiled Pallas/Triton "
        "kernels); skipped elsewhere")


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default device is a GPU (decided at run
    time, never at import, so every worker collects the same tests)."""
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; run python chip_smoke.py on the "
                    "card instead")
    return jax.devices()[0]
