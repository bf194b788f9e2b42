"""Test configuration: run on CPU with 8 fake devices and 64-bit floats.

Golden-value parity tests (vs Pinocchio-derived fixtures) require f64; the
fake-device mesh lets multi-device sharding be exercised without a card.

``OPTIK_TEST_DEVICE=gpu`` (set by chip_smoke.py, which runs the
``gpu``-marked tests in its own process on the card) keeps JAX's default
backend and float32 instead.  Whether a card is present is decided by the
``gpu`` fixture in tests/test_gpu.py, never here.
"""

import os

_ON_CARD = os.environ.get("OPTIK_TEST_DEVICE") == "gpu"

if not _ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not _ON_CARD:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

# The unrolled SoA solver bodies take O(30 s) to compile; cache compiled
# executables on disk so repeat test runs don't pay it again.
from optik_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: runs compiled kernels on the card (python "
        "chip_smoke.py runs them; they skip without a GPU)")
    config.addinivalue_line(
        "markers", "slow: multi-process / long-running tests")
