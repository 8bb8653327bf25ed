"""Test harness: force the CPU backend with 8 virtual devices so the
multi-device sharding paths compile and execute without a GPU, and pin
float32 matmuls to full precision. Tests of code that runs only on the
card are marked `gpu` (tests/test_gpu.py) and run there through
chip_smoke.py, without this file.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
