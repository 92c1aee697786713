"""Test configuration: force an 8-device virtual CPU mesh before JAX loads.

Multi-chip sharding is validated on host CPU devices (SURVEY.md §4). What
only a GPU can run is marked ``gpu``: the ``gpu_device`` fixture skips it on
the CPU, and on a machine with a card it runs with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import pathlib

import jax
import pytest

# jax may already be imported by a pytest plugin, in which case the env var
# above is read too late — force the platform through the config as well
# (backends initialize lazily, so this still lands before device creation).
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

DATA = pathlib.Path(__file__).parent / "data"


@pytest.fixture(scope="session")
def data_dir() -> pathlib.Path:
    return DATA


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: decided when the test runs, never at
    import, so every xdist worker collects the same tests."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda,cpu on the card)")
    return gpus[0]
