"""Test configuration: an 8-device virtual CPU mesh, or the GPU tier.

By default the tests run on the CPU with 8 virtual devices, so the
sharding/collective paths are exercised on one machine.

GPU tier: `WASS_GPU_TESTS=1 python -m pytest tests -m gpu -q` keeps JAX's
default backend and runs only the @pytest.mark.gpu tests
(test_gpu_gates.py).  Whether a GPU is present is decided by the `gpu`
fixture when a test runs, so every process collects the same tests; without
a GPU those tests skip.
"""

import os

import jax

if os.environ.get("WASS_GPU_TESTS", "0") != "1":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when there is none."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU: WASS_GPU_TESTS=1 python -m pytest tests -m gpu")
    return devices[0]


@pytest.fixture
def rng():
    return np.random.default_rng(42)
