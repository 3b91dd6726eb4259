"""Test harness config: run everything on an 8-device virtual CPU mesh so
multi-card sharding is exercised without a GPU (SURVEY.md §4), with the
Pallas kernels in interpret mode. Tests that need the card carry the
`gpu` marker and skip here; `python chip_smoke.py` runs the card path."""

import os

# Hermetic: force the 8-device virtual CPU mesh even where a GPU is
# attached; jax.config.update below makes the choice stick in-process.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from spmm_denseblock_tpu.backend import set_interpret  # noqa: E402

set_interpret(True)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(autouse=True)
def _skip_gpu_tests_off_the_card(request):
    """Tests marked `gpu` skip unless JAX's backend is a GPU. Decided
    per test, never at import: xdist workers must collect the same
    tests."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU; run `python chip_smoke.py` on the card")
