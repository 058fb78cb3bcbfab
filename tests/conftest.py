"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-chip sharding (halo-exchange overlap-save) is tested on CPU via
xla_force_host_platform_device_count, per SURVEY.md §4.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# the apps' main() point JAX at the persistent compile cache; tests compile
# in-process only, as they always have
jax.config.update("jax_enable_compilation_cache", False)
assert jax.devices()[0].platform == "cpu", jax.devices()
