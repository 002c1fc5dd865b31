"""Test configuration.

By default the suite runs on the CPU backend with 8 virtual devices, so
the mesh paths have devices to shard over; the persistent compilation
cache is off, so no test writes one. Tests marked ``gpu`` need an NVIDIA
GPU, decide so in the ``gpu`` fixture, and skip elsewhere. On a machine
with a card, run them with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

(any JAX_PLATFORMS other than cpu leaves the backend to JAX).
"""

import os
import pathlib

import pytest

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_compilation_cache", False)

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"
DATA_DIR = pathlib.Path(__file__).parent / "data"


@pytest.fixture(scope="session")
def golden_dir():
    return GOLDEN_DIR


@pytest.fixture(scope="session")
def data_dir():
    return DATA_DIR


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/")
    return jax.devices()[0]
