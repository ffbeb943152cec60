"""Distributed solve on an IMPORTED (unstructured) hex mesh.

The complete reference workflow (demo/cpu_planar3d/main.cpp:39-45 +
gpu_scatter_mpi's VectorUpdater): a perturbed hex mesh with tagged
source/absorbing facets, RCB-partitioned over N devices, solved with the
indexed operator per device and one interface-assembly exchange per RK
stage. Compares against the single-device solve.

Run: python examples/unstructured_distributed_solve.py [ndev]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
try:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", n)
    jax.config.update("jax_enable_x64", True)
except RuntimeError:
    pass

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from wave_fenics_tpu.core.mesh import HexMesh, box_mesh  # noqa: E402
from wave_fenics_tpu.models.general_wave import GeneralLinearWave  # noqa: E402
from wave_fenics_tpu.parallel.sharded_general import (  # noqa: E402
    ShardedGeneralWave,
)

_FACES = [(0, 1, 2, 3), (0, 1, 4, 5), (0, 2, 4, 6), (1, 3, 5, 7),
          (2, 3, 6, 7), (4, 5, 6, 7)]

ext = np.array([0.012, 0.008, 0.008])
rng = np.random.default_rng(0)
hm = box_mesh((6, 4, 4), tuple(ext)).to_hex_mesh()
pts = hm.points.copy()
inner = np.all((pts > 1e-12) & (pts < ext - 1e-12), axis=1)
pts[inner] += 4e-4 * rng.standard_normal(pts[inner].shape)
hm = HexMesh(points=pts, cells=hm.cells)


def xface_quads(x0):
    ids = set(np.where(np.abs(hm.points[:, 0] - x0) < 1e-12)[0].tolist())
    return np.asarray([[c[v] for v in f] for c in hm.cells for f in _FACES
                       if all(c[v] in ids for v in f)])


md = GeneralLinearWave(
    mesh=hm, p=4,
    facet_tags={1: xface_quads(0.0), 2: xface_quads(ext[0])},
    dtype=jnp.float64,
)
dt = 1e-9
sw = ShardedGeneralWave(md, n)
u, v, nsteps = sw.solve_n(0.0, dt, 10)
u1, v1 = md.solve_n(0.0, dt, 10)
err = np.abs(sw.to_global(v) - np.asarray(v1)).max() / np.abs(
    np.asarray(v1)).max()
print(f"ndev={n} ndofs={md.ndofs} steps={nsteps} "
      f"|v|max={float(np.abs(sw.to_global(v)).max()):.3e} "
      f"rel_err_vs_single={err:.2e}")
assert err < 1e-12
