"""Test configuration: CPU backend with 8 virtual devices, f64 enabled.

The suite runs on the CPU, whatever accelerator the machine has:
multi-device sharding is validated on a virtual CPU mesh, and f64 is
required for reference-parity tolerances. Must run before jax initializes
its backends; jax.config is set directly so it also holds when the
environment names another platform.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
