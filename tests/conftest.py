"""Test configuration: run the suite on CPU with 8 fake devices and f64.

Mirrors the reference's distributed-testing strategy (SURVEY.md §6:
``mpirun -np 8`` on one node) by exposing 8 virtual XLA CPU devices so every
multi-device code path (shard_map / ppermute halo exchange) is exercised
without accelerator hardware.  f64 is enabled because convergence-order
assertions need it (SURVEY.md §9.3); the library itself stays
dtype-parametric.  XLA_FLAGS must be set before first device use; the
platform is pinned with ``jax.config`` before any backend initializes.
Tests that need a GPU carry the ``gpu`` marker and decide in a fixture.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# CPU unless the run names another platform (``JAX_PLATFORMS=cuda`` for
# the gpu-marked tests on the card)
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)
