"""Test configuration.

Tests run on the CPU backend with 8 virtual devices, so the multi-device
sharding paths (shard_map over a Mesh) are exercised without a GPU.
Tests marked ``gpu`` take the ``gpu`` fixture, which skips them where
JAX finds no GPU; on a machine with one, run them with
``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu``.
Must run before jax initializes a backend.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from btcs_pnes_optical_flow.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


@pytest.fixture()
def rng():
    # Function-scoped: every test sees the same stream regardless of
    # which other tests ran (a shared stream made borderline
    # differential cases order-dependent).
    return np.random.default_rng(0)


@pytest.fixture()
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda,cpu)")
    return devices[0]
