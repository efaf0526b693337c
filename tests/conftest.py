"""Test configuration.

Tests run on a virtual 8-device CPU mesh with x64 enabled, so sharding logic,
fp64 numerics and the Pallas kernels (in interpret mode) are validated
without an accelerator.  Tests marked ``gpu`` need the card and skip here;
run them on a GPU machine with

    CGLB_TEST_PLATFORM=gpu python -m pytest -m gpu tests/
"""

import os

if os.environ.get("CGLB_TEST_PLATFORM", "cpu") == "cpu":
    # Force-overwrite — the environment may pre-set JAX_PLATFORMS.  Env vars
    # alone are not enough: pytest plugins (jaxtyping) import jax before
    # this conftest runs, freezing config defaults from the original env —
    # so also update jax.config directly below (safe as long as no backend
    # has been initialized yet).
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["JAX_PLATFORM_NAME"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if os.environ.get("CGLB_TEST_PLATFORM", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")
    assert jax.devices()[0].platform == "cpu", (
        "tests must run on CPU; got " + str(jax.devices())
    )
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The first device if it is a GPU; skips otherwise (decided here, at
    run time, never while test modules are imported)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU (run with CGLB_TEST_PLATFORM=gpu -m gpu)")
    return dev


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def make_toy_data(rng, n=64, d=3, out=1, dtype=np.float64):
    """Draw inputs and GP-ish targets for small dense-oracle tests."""
    X = rng.normal(size=(n, d)).astype(dtype)
    w = rng.normal(size=(d, out)).astype(dtype)
    Y = np.tanh(X @ w) + 0.1 * rng.normal(size=(n, out)).astype(dtype)
    return X, Y


@pytest.fixture
def toy_data(rng):
    return make_toy_data(rng)
