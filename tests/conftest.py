"""Test harness setup: a pure-CPU JAX with a virtual 8-device mesh, and
the ``gpu`` marker for tests that need a CUDA card.

SURVEY.md §4(3): distributed tests run without a cluster via
``--xla_force_host_platform_device_count=8`` so pjit shardings, psum
gradient math and loader sharding are exercised in one process.

Tests marked ``gpu`` run only where JAX's default backend is a GPU
(``python -m pytest -m gpu tests/`` on the card, with ``CTC_ASR_GPU_TESTS=1``
so this file leaves the platform alone). Whether a card is present is
decided inside a fixture, never at import or collection time, so every
xdist worker collects the same tests.
"""

import os
import sys

import pytest

if not os.environ.get("CTC_ASR_GPU_TESTS"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

# Make the repo root importable regardless of pytest rootdir.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# SURVEY.md §5 "race detection/sanitizers": NaN-trap gate — run the
# whole suite with every jit raising on the first NaN it produces via
#   CTC_ASR_DEBUG_NANS=1 python -m pytest tests/ -q
# Off by default: legitimate -inf arithmetic in the log-space CTC /
# beam tests makes it a debugging mode, not a CI default.
if os.environ.get("CTC_ASR_DEBUG_NANS"):
    import jax
    jax.config.update("jax_debug_nans", True)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip a ``gpu``-marked test unless JAX's default backend is a GPU."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA card (JAX default backend is "
                    f"{jax.default_backend()!r})")
