"""Test configuration: CPU with 8 virtual devices and float64.

Multi-device sharding is validated on a virtual CPU mesh
(``xla_force_host_platform_device_count``), which tests multi-device
behaviour without a cluster.  Float64 is enabled so golden numerics tests
can match the NumPy oracle at tight tolerances.

The tests run on the CPU unless ``JAX_PLATFORMS`` names a GPU platform: on a
machine with a GPU, ``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu``
runs the tests marked ``gpu``.  They take the ``gpu`` fixture, which skips
when JAX sees no GPU.  The platform is set as a config value, so it holds
even if jax was imported before this file.
"""

import os

import jax
import pytest

_platforms = os.environ.get("JAX_PLATFORMS", "")
if not any(p in _platforms for p in ("cuda", "gpu")):
    _platforms = "cpu"
jax.config.update("jax_platforms", _platforms)
jax.config.update("jax_enable_x64", True)

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX sees none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU visible to JAX")
