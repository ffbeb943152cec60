"""The COMPLETE imported-mesh workflow in one script — what a
wave-fenics user's planar3d run becomes here (docs/MIGRATING.md):

1. write a demo XDMF mesh + facet meshtags (stand-in for your DOLFINx
   export; tag 1 = source plane, tag 2 = absorbing, forms.ufl:21-24)
2. ``from_xdmf`` -> GeneralLinearWave (explicit dofmap; indexed
   gather/scatter operators)
3. solve with probe recording (hydrophone time series)
4. write the final field as a p-refined sub-hex XDMF for ParaView

Run: python examples/imported_mesh_hifu.py [outdir]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from wave_fenics_tpu.core.mesh import box_mesh  # noqa: E402

outdir = sys.argv[1] if len(sys.argv) > 1 else "imported_demo_out"
os.makedirs(outdir, exist_ok=True)

# -- 1. a demo "imported" mesh: box + mild distortion, HDF5-free XDMF --
mesh = box_mesh((8, 3, 3), (0.02, 0.0075, 0.0075))
hm = mesh.to_hex_mesh()
rng = np.random.default_rng(0)
pts = hm.points.copy()
inner = ((pts > 1e-12) & (pts < pts.max(axis=0) - 1e-12)).all(axis=1)
pts[inner] += 2e-4 * rng.standard_normal(pts[inner].shape)

nx, ny, nz = mesh.shape


def vid(i, j, k):
    return (i * (ny + 1) + j) * (nz + 1) + k


def face(i):
    return np.array(
        [[vid(i, j, k), vid(i, j + 1, k), vid(i, j, k + 1),
          vid(i, j + 1, k + 1)]
         for j in range(ny) for k in range(nz)]
    )


f_src, f_abc = face(0), face(nx)
inv = np.argsort(np.array([0, 1, 3, 2, 4, 5, 7, 6]))  # basix -> VTK


def _xml(a, fmt):
    return "\n".join(" ".join(fmt % x for x in row) for row in a)


mesh_path = os.path.join(outdir, "mesh.xdmf")
with open(mesh_path, "w") as f:
    f.write(f"""<?xml version="1.0"?>
<Xdmf Version="3.0"><Domain><Grid Name="demo">
<Topology TopologyType="Hexahedron" NumberOfElements="{hm.ncells}">
<DataItem Dimensions="{hm.ncells} 8" Format="XML">
{_xml(hm.cells[:, inv], "%d")}
</DataItem></Topology>
<Geometry GeometryType="XYZ">
<DataItem Dimensions="{len(pts)} 3" Format="XML">
{_xml(pts, "%.17g")}
</DataItem></Geometry>
</Grid></Domain></Xdmf>""")

facets = np.concatenate([f_src, f_abc])[:, [0, 1, 3, 2]]
vals = np.array([1] * len(f_src) + [2] * len(f_abc))
tags_path = os.path.join(outdir, "meshtags.xdmf")
with open(tags_path, "w") as f:
    f.write(f"""<?xml version="1.0"?>
<Xdmf Version="3.0"><Domain><Grid Name="boundaries">
<Topology TopologyType="Quadrilateral" NumberOfElements="{len(facets)}">
<DataItem Dimensions="{len(facets)} 4" Format="XML">
{_xml(facets, "%d")}
</DataItem></Topology>
<Geometry GeometryType="XYZ">
<DataItem Dimensions="{len(pts)} 3" Format="XML">
{_xml(pts, "%.17g")}
</DataItem></Geometry>
<Attribute Name="tags" Center="Cell">
<DataItem Dimensions="{len(vals)}" Format="XML">
{" ".join(str(v) for v in vals)}
</DataItem></Attribute>
</Grid></Domain></Xdmf>""")

# -- 2-3. model + solve with probes ------------------------------------
from wave_fenics_tpu.models.general_wave import (  # noqa: E402
    from_xdmf,
    solve_recording,
)

model = from_xdmf(mesh_path, tags_path, p=4, dtype=jnp.float64)
h = model.mesh.hmin()
dt = 0.25 * h / (model.c0 * model.p**2)
nsteps = 200
probes = np.array([[0.005, 0.0037, 0.0037], [0.015, 0.0037, 0.0037]])
# long production runs: integrator="leapfrog" costs ONE stiffness apply
# per step instead of RK4's four (2nd order; scale dt by ~0.71)
u, v, series = solve_recording(model, 0.0, dt, nsteps, probes,
                               integrator="rk4")
series = np.asarray(series)
np.savetxt(
    os.path.join(outdir, "probes.csv"),
    np.column_stack([np.arange(nsteps) * dt, series]),
    delimiter=",", header="t,p1,p2", comments="",
)

# -- 4. ParaView output --------------------------------------------------
from wave_fenics_tpu.core.io import write_xdmf_unstructured  # noqa: E402

write_xdmf_unstructured(
    os.path.join(outdir, "solution.xdmf"), model.dofs,
    {"u": np.asarray(u), "v": np.asarray(v)}, time=nsteps * dt,
)
print(
    f"ndofs={model.ndofs} nsteps={nsteps} "
    f"|u|max={float(np.abs(np.asarray(u)).max()):.4g} "
    f"probe_pk={np.abs(series).max(axis=0)} -> {outdir}/"
)
