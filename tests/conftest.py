"""Test configuration: run the suite on a virtual 8-device CPU mesh.

The suite runs on the CPU; sharding tests use XLA's host-platform device
virtualization (the same mechanism as the multi-device dryrun).  Tests
marked `gpu` need an NVIDIA GPU: they skip here, and chip_smoke.py runs
their checks on the card.  CPU runs use no persistent compilation cache
(see orb_slam2_annotate_tpu.enable_compile_cache).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere")
