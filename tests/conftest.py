"""Test harness config: force the CPU platform with 8 virtual devices so
that multi-device sharding paths are exercised without GPUs, and enable
x64 so float64 oracle cross-checks work.

With BS_CALL_TEST_GPU=1 (chip_smoke.py's gpu-tests phase) the platform is
left to JAX, so the `gpu`-marked tests run on the card; everywhere else
their `gpu` fixture skips them."""

import os

import pytest

_ON_GPU = bool(os.environ.get("BS_CALL_TEST_GPU"))
if not _ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The first GPU JAX sees; skips the test when there is none."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs it there)")
    return devs[0]
