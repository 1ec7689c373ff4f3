"""Test configuration: the CPU with an 8-device virtual mesh.

Distributed correctness (z-slab sharding, halo exchange, psum'd metrics —
SURVEY.md §4) is validated on a host-platform device mesh, so the suite
runs anywhere. The platform is JAX_PLATFORMS where it is set and the CPU
otherwise; it must be fixed before any JAX backend is initialized.

Tests marked ``gpu`` take the ``gpu`` fixture, which skips them unless
the default device is a GPU. On a GPU machine run them with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

import pytest

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")


@pytest.fixture
def gpu():
    """The first device, when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; the default device is {dev.platform}")
    return dev
