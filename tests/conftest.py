"""Test configuration.

The suite runs on the CPU backend (`JAX_PLATFORMS=cpu`) with 8 virtual
devices, so multi-device sharding layouts execute without a GPU.  Tests
marked `gpu` need a CUDA device; they decide inside a fixture whether one
exists and skip with a reason where JAX finds none.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()


def pytest_configure(config):
    try:
        import jax
    except ImportError:
        return
    # unmarked tests run on the CPU backend even where a GPU is visible
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
