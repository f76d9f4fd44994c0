"""Test configuration: run the suite on a virtual 8-device CPU mesh.

Sharding tests need multiple devices; convergence-parity tests need f64.
Tests that need an NVIDIA GPU carry the ``gpu`` marker and the ``gpu``
fixture, which skips them when no card is present. Run them on the card
with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``: any
``JAX_PLATFORMS`` other than ``cpu`` leaves the platform to JAX.
"""

import os
import sys

import pytest

_CPU_RUN = os.environ.get("JAX_PLATFORMS", "cpu") == "cpu"

if _CPU_RUN:
    # XLA reads XLA_FLAGS at backend creation (not jax import), so this is
    # still early enough.
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if _CPU_RUN:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from skeres.utils.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()

if _CPU_RUN:
    assert jax.default_backend() == "cpu", jax.default_backend()
    assert len(jax.devices()) >= 8, jax.devices()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "distributed: spawns 2 jax.distributed CPU processes (slow)",
    )
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips without one)"
    )


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda)")
    return devices[0]
