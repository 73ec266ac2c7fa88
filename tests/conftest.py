"""Test configuration.

Tests run on a virtual 8-device CPU mesh so sharding/collective code paths
are exercised without several cards (SURVEY.md §4). The platform comes
from `JAX_PLATFORMS` when it is set and is the CPU otherwise; the tests
marked `gpu` run on a card with `JAX_PLATFORMS=cuda pytest -m gpu tests/`
and skip where JAX finds none.
"""
import os

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_num_cpu_devices", 8)
# f64 is a first-class compute dtype (reference MAT_VAL_TYPE double)
jax.config.update("jax_enable_x64", True)

from tilespmv_tpu.utils.jax_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(scope="session")
def gpu_device():
    """The first CUDA device; skips the test where JAX finds none."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a CUDA card (run with JAX_PLATFORMS=cuda)")
    return devs[0]
