"""Distributed solve on an N-device mesh (virtual CPU devices by default).

Run: python examples/multichip_solve.py [ndev]
"""

import sys

import jax

n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
try:
    # must run before any backend initializes; no-op failure otherwise
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", n)
except RuntimeError:
    pass

import jax.numpy as jnp  # noqa: E402

from wave_fenics_tpu.models.planar3d import planar3d_case  # noqa: E402
from wave_fenics_tpu.parallel.partition import decompose3d  # noqa: E402
from wave_fenics_tpu.parallel.sharded_wave import ShardedLinearWave  # noqa: E402

parts = decompose3d(n)
case = planar3d_case(
    ncells=tuple(4 * m for m in parts), domain_length=0.01, dtype=jnp.float32
)
sw = ShardedLinearWave(case.model, parts)
u, v, nsteps = sw.solve(case.t0, case.t0 + 10 * case.dt, case.dt)
print(f"mesh={parts} steps={nsteps} |v|max={float(jnp.abs(v).max()):.3e}")
