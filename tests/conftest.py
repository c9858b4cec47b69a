"""Test configuration: a virtual 8-device CPU mesh with x64 enabled.

The platform is pinned to the CPU through jax.config before the backend
initializes (it is lazy), unless ``TTNX_TEST_GPU=1`` asks for the card: then
the tests marked ``gpu`` run on it (``pytest -m gpu``) and the rest are
meant to stay on the CPU run.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if os.environ.get("TTNX_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def key():
    return jax.random.PRNGKey(1234)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none. Decided
    here, at run time, so every test worker collects the same tests."""
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs a GPU (run with TTNX_TEST_GPU=1 on the card)")
    return devices[0]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled-executable state between modules: a clean full-suite
    run segfaulted the XLA CPU compiler (twice, deterministically, at the
    same late jit-of-shard_map compile in test_tsqr) while every half of
    the suite passes in isolation — cumulative in-process compiler state,
    not memory (128 GB free) and not any single test. Clearing the jit
    caches per module keeps the accumulation bounded; cross-module cache
    reuse is minimal (modules compile distinct shapes)."""
    yield
    jax.clear_caches()
