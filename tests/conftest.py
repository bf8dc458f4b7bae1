import os

# 8 virtual CPU devices for sharding tests (must be set before backend init)
xla_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# Unit tests run on the CPU in float64, whatever accelerator the host
# has: pytest-xdist starts several workers, and a worker that opened the
# GPU would reserve most of its memory and starve the others (and any
# chip_smoke.py run).  The config API pins it even where JAX_PLATFORMS
# is set to something else.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
