"""Test configuration: 8 virtual CPU devices + float64.

Multi-device sharding/halo logic is tested on a virtual CPU mesh so no
multi-GPU host is needed — an improvement over the reference, whose
distributed paths are only exercised by real Slurm cluster runs
(SURVEY.md §4.5). The platform is set through jax.config before any
backend initializes. Measurements on the GPU live outside pytest
(chip_smoke.py, bench.py).
"""

import os

import jax

# Route everything to CPU and fan it out to 8 virtual devices. Must happen
# before the first backend initialization (i.e. before any jnp op runs).
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

# Belt and braces for any subprocess the tests may spawn.
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()
