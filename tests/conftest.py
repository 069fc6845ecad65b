"""Test configuration: CPU backend with 8 virtual devices + float64.

Multi-device tests emulate a device mesh on host CPU (the reference tests MPI
only by launching mpirun; we instead use XLA's virtual device emulation), and
float64 lets convergence-order assertions run without f32 noise.  The suite
never needs an accelerator.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# also covers a jax imported before this file (its platform default is read
# at import time)
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
