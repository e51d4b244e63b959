"""Test configuration: the CPU platform with an 8-device virtual mesh.

Multi-device sharding is validated on a virtual CPU mesh
(xla_force_host_platform_device_count). The platform is forced through
jax.config as well as JAX_PLATFORMS, so the suite never reaches a GPU;
what only the GPU can run is covered by chip_smoke.py (tests marked
`gpu` skip here).
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
