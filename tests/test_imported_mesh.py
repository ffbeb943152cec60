"""End-to-end on an imported (XDMF) mesh: io -> dofmap -> operators -> CG.

Exercises the full unstructured/imported code path the reference drives via
DOLFINx XDMF ingest (demo/cpu_planar3d/main.cpp:40-45), including a
geometrically distorted mesh that the structured fast path cannot handle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from wave_fenics_tpu.core import io as mio
from wave_fenics_tpu.core.dofmap import build_dofmap
from wave_fenics_tpu.core.mesh import box_mesh
from wave_fenics_tpu.ops.operators import GeneralOperators
from wave_fenics_tpu.solvers.cg import cg

_VTK_ORDER = np.array([0, 1, 3, 2, 4, 5, 7, 6])


@pytest.fixture()
def imported_mesh(tmp_path):
    h5py = pytest.importorskip("h5py")
    m = box_mesh((3, 2, 2), (1.0, 0.8, 0.9)).to_hex_mesh()
    rng = np.random.default_rng(0)
    pts = m.points + 0.02 * rng.standard_normal(m.points.shape)
    inv = np.argsort(_VTK_ORDER)
    with h5py.File(tmp_path / "m.h5", "w") as f:
        f["/geom"] = pts
        f["/topo"] = m.cells[:, inv]
    (tmp_path / "m.xdmf").write_text(f"""<?xml version="1.0"?>
<Xdmf Version="3.0"><Domain>
<Grid Name="imported">
<Topology TopologyType="Hexahedron" NumberOfElements="{m.ncells}">
<DataItem Dimensions="{m.ncells} 8" Format="HDF">m.h5:/topo</DataItem>
</Topology>
<Geometry GeometryType="XYZ">
<DataItem Dimensions="{len(pts)} 3" Format="HDF">m.h5:/geom</DataItem>
</Geometry>
</Grid>
</Domain></Xdmf>""")
    return mio.read_xdmf(str(tmp_path / "m.xdmf"))


def test_imported_mesh_operators_and_cg(imported_mesh):
    p = 3
    dofs = build_dofmap(imported_mesh, p)
    ops = GeneralOperators(imported_mesh, dofs, dtype=jnp.float64)

    # mass solve by CG (BP1 shape on an imported distorted mesh)
    rng = np.random.default_rng(1)
    b = jnp.asarray(rng.standard_normal(ops.ndofs))
    solve = jax.jit(lambda bb: cg(ops.spectral_mass, bb, kmax=400, rtol=1e-9))
    x, k, _ = solve(b)
    res = np.asarray(ops.spectral_mass(x) - b)
    assert np.linalg.norm(res) / np.linalg.norm(np.asarray(b)) < 1e-7

    # stiffness annihilates constants on the imported mesh too
    ones = jnp.ones((ops.ndofs,), dtype=jnp.float64)
    y = np.asarray(ops.stiffness(ones, 1500.0))
    assert np.abs(y).max() < 1e-5 * 1500.0**2


def _write_xdmf_mesh_and_tags(tmp_path, hm, tag_quads):
    """Export a HexMesh + tagged boundary quads as DOLFINx-flavor XDMF
    (VTK vertex winding), the format the reference consumes
    (demo/cpu_planar3d/main.cpp:40-45)."""
    import h5py

    inv = np.argsort(_VTK_ORDER)
    with h5py.File(tmp_path / "mesh.h5", "w") as f:
        f["/geom"] = hm.points
        f["/topo"] = hm.cells[:, inv]
    (tmp_path / "mesh.xdmf").write_text(f"""<?xml version="1.0"?>
<Xdmf Version="3.0"><Domain>
<Grid Name="planar3d">
<Topology TopologyType="Hexahedron" NumberOfElements="{hm.ncells}">
<DataItem Dimensions="{hm.ncells} 8" Format="HDF">mesh.h5:/topo</DataItem>
</Topology>
<Geometry GeometryType="XYZ">
<DataItem Dimensions="{len(hm.points)} 3" Format="HDF">mesh.h5:/geom</DataItem>
</Geometry>
</Grid>
</Domain></Xdmf>""")
    # facet tags: XDMF quads are perimeter-wound; our tensor-order quads
    # (v0, v1, v2, v3) map to perimeter (v0, v1, v3, v2)
    quads = np.concatenate([q for q, _ in tag_quads])[:, [0, 1, 3, 2]]
    vals = np.concatenate(
        [np.full(len(q), t, np.int32) for q, t in tag_quads]
    )
    with h5py.File(tmp_path / "tags.h5", "w") as f:
        f["/quads"] = quads
        f["/vals"] = vals
    (tmp_path / "tags.xdmf").write_text(f"""<?xml version="1.0"?>
<Xdmf Version="3.0"><Domain>
<Grid Name="facet_tags">
<Topology TopologyType="Quadrilateral" NumberOfElements="{len(quads)}">
<DataItem Dimensions="{len(quads)} 4" Format="HDF">tags.h5:/quads</DataItem>
</Topology>
<Geometry GeometryType="XYZ">
<DataItem Dimensions="{len(hm.points)} 3" Format="HDF">mesh.h5:/geom</DataItem>
</Geometry>
<Attribute Name="tags" Center="Cell">
<DataItem Dimensions="{len(quads)}" Format="HDF">tags.h5:/vals</DataItem>
</Attribute>
</Grid>
</Domain></Xdmf>""")
    return str(tmp_path / "mesh.xdmf"), str(tmp_path / "tags.xdmf")


def _xface_quads(hm, x0):
    """x-face boundary quads in tensor vertex order (v0, v1=+y, v2=+z)."""
    pts = hm.points
    ids = set(np.where(np.abs(pts[:, 0] - x0) < 1e-12)[0].tolist())
    lo = [[c[0], c[2], c[4], c[6]] for c in hm.cells
          if all(c[v] in ids for v in (0, 2, 4, 6))]
    hi = [[c[1], c[3], c[5], c[7]] for c in hm.cells
          if all(c[v] in ids for v in (1, 3, 5, 7))]
    return np.asarray(lo + hi)


def _solve_plane_wave_xdmf(tmp_path, hm, L, quadrature="gll"):
    """Export hm+tags to XDMF, solve via from_xdmf at f64, return the
    relative L2 error against the analytic traveling plane wave."""
    from wave_fenics_tpu.models.planar3d import (
        analytic_plane_wave, planar3d_case_xdmf,
    )

    mesh_path, tags_path = _write_xdmf_mesh_and_tags(
        tmp_path, hm,
        [(_xface_quads(hm, 0.0), 1), (_xface_quads(hm, L), 2)],
    )
    case = planar3d_case_xdmf(mesh_path, tags_path, dtype=jnp.float64,
                              quadrature=quadrature)
    m = case.model
    assert len(m.facet_tags[1]) == 4 and len(m.facet_tags[2]) == 4
    u, v = m.solve_n(case.t0, case.dt, case.nsteps)
    tf = case.t0 + case.dt * case.nsteps
    x = np.asarray(m.dofs.dof_coords)[:, 0]
    u_exact = analytic_plane_wave(x, tf, case)
    rel = (np.linalg.norm(np.asarray(u) - u_exact)
           / np.linalg.norm(u_exact))
    return rel, m


@pytest.mark.slow
def test_imported_mesh_analytic_plane_wave(tmp_path):
    """E2E physics validation on an IMPORTED non-uniform mesh: XDMF
    export -> from_xdmf -> GeneralLinearWave f64 solve must reproduce the
    analytic traveling plane wave — the imported-mesh analogue of
    test_model.test_planar3d_analytic_plane_wave, closing the loop on the
    reference's actual workflow (demo/cpu_planar3d/main.cpp:39-93).

    The mesh is a randomly GRADED box (every axis's planes moved by up to
    25% of the uniform spacing): genuinely imported/non-uniform (the
    structured fast path cannot represent it — it requires uniform h),
    with affine cells, so the GLL-collocated scheme keeps its full
    accuracy. Measured: 1.9e-6 (structured counterpart: 6.4e-7)."""
    pytest.importorskip("h5py")
    from wave_fenics_tpu.core.mesh import HexMesh

    ncells = (16, 2, 2)
    L = 6.0e-3
    W = L * ncells[1] / ncells[0]
    hm0 = box_mesh(ncells, (L, W, W)).to_hex_mesh()
    pts = hm0.points.copy()
    rng = np.random.default_rng(5)

    def grade(coords, ext, n):
        planes = np.unique(coords)
        newp = planes.copy()
        newp[1:-1] += 0.25 * (ext / n) * rng.uniform(-1, 1,
                                                     len(planes) - 2)
        return newp[np.searchsorted(planes, coords)]

    pts2 = pts.copy()
    pts2[:, 0] = grade(pts[:, 0], L, ncells[0])
    pts2[:, 1] = grade(pts[:, 1], W, ncells[1])
    pts2[:, 2] = grade(pts[:, 2], W, ncells[2])
    hm = HexMesh(points=pts2, cells=hm0.cells)

    rel, m = _solve_plane_wave_xdmf(tmp_path, hm, L)
    assert rel < 1e-5, rel


@pytest.mark.slow
def test_imported_trilinear_mesh_plane_wave_floor(tmp_path):
    """Same E2E solve on a randomly VERTEX-PERTURBED (trilinear,
    non-affine) mesh. The GLL-collocated scheme (lumped mass + p+1-point
    quadrature — the reference's scheme, LinearGLL.hpp:105-110 +
    operators.hpp:63-72) commits an O(cell-nonaffinity) quadrature crime
    on non-affine cells: the error floors at ~C*distortion independent of
    h (measured: 2.6e-4 at 3% vertex jitter, amp-saturating, uniform in
    space, steady in time — scattered-field structure, not instability).
    This is scheme-intrinsic, not a bug: geometry factors validated to
    2e-10 against finite differences, and the affine-cell test above
    passes at 1.9e-6. Documented in docs/DESIGN.md."""
    pytest.importorskip("h5py")
    from wave_fenics_tpu.core.mesh import HexMesh

    ncells = (16, 2, 2)
    L = 6.0e-3
    W = L * ncells[1] / ncells[0]
    hm0 = box_mesh(ncells, (L, W, W)).to_hex_mesh()
    pts = hm0.points.copy()
    h = L / ncells[0]
    rng = np.random.default_rng(3)
    ext = np.array([L, W, W])
    inner = np.all((pts > 1e-12) & (pts < ext - 1e-12), axis=1)
    assert inner.any()
    pts[inner] += 0.03 * h * rng.standard_normal(pts[inner].shape)
    hm = HexMesh(points=pts, cells=hm0.cells)

    rel, m = _solve_plane_wave_xdmf(tmp_path, hm, L)
    assert rel < 1e-3, rel  # measured 2.6e-4 (quadrature-crime floor)


def test_facet_weights_gauss_rule_matches_gll_on_flat_facets():
    """On flat rectangular facets |J_s| is constant, so both quadrature
    rules integrate phi_i exactly: the Gauss facet weights must equal the
    GLL ones (and sum to the face area)."""
    from wave_fenics_tpu.core.dofmap import build_dofmap
    from wave_fenics_tpu.models.general_wave import facet_lumped_weights

    hm = box_mesh((2, 2, 2), (1.0, 0.8, 0.9)).to_hex_mesh()
    dofs = build_dofmap(hm, 4)
    quads = _xface_quads(hm, 0.0)
    Wg = facet_lumped_weights(hm, dofs, quads, 4, rule="gll")
    Wq = facet_lumped_weights(hm, dofs, quads, 4, rule="gauss")
    np.testing.assert_allclose(Wq, Wg, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(Wq.sum(), 0.8 * 0.9, rtol=1e-12)


@pytest.mark.slow
def test_consistent_quadrature_mode(tmp_path):
    """The Gauss consistent-quadrature mode (quadrature='gauss': Gauss
    stiffness + row-sum-lumped Gauss mass + Gauss facet weights).

    (a) On the affine graded mesh it keeps the GLL scheme's full
    accuracy (measured 1.888e-6 — identical to gll to 4 digits).
    (b) On the 3%-jitter trilinear mesh it does NOT break the ~2.6e-4
    floor: measured 2.20e-4 (gll: 2.62e-4), and neither does full
    consistency (Gauss mass solved by CG each stage: 2.199e-4, q=12
    over-integration: 6.5e-4) nor h-refinement (32 cells: gauss 2.25e-4,
    gll 3.28e-4). The floor is NOT a quadrature crime: at fixed RELATIVE
    jitter the mesh family violates the isoparametric regularity
    condition (||d2x/dxi2||/h ~ const instead of -> 0), so the spatial
    error of ANY consistent scheme stalls — a property of the mesh
    family, shared with the reference. Refutation details:
    docs/DESIGN.md."""
    pytest.importorskip("h5py")
    from wave_fenics_tpu.core.mesh import HexMesh

    ncells = (16, 2, 2)
    L = 6.0e-3
    W = L * ncells[1] / ncells[0]
    hm0 = box_mesh(ncells, (L, W, W)).to_hex_mesh()
    rng = np.random.default_rng(5)

    def grade(coords, ext, n):
        planes = np.unique(coords)
        newp = planes.copy()
        newp[1:-1] += 0.25 * (ext / n) * rng.uniform(-1, 1,
                                                     len(planes) - 2)
        return newp[np.searchsorted(planes, coords)]

    pts2 = hm0.points.copy()
    pts2[:, 0] = grade(hm0.points[:, 0], L, ncells[0])
    pts2[:, 1] = grade(hm0.points[:, 1], W, ncells[1])
    pts2[:, 2] = grade(hm0.points[:, 2], W, ncells[2])
    rel_a, m = _solve_plane_wave_xdmf(
        tmp_path, HexMesh(points=pts2, cells=hm0.cells), L,
        quadrature="gauss",
    )
    assert not m.ops._tab.collocated  # really the Gauss operators
    assert rel_a < 1e-5, rel_a  # measured 1.888e-6, == gll

    pts = hm0.points.copy()
    h = L / ncells[0]
    rng = np.random.default_rng(3)
    ext = np.array([L, W, W])
    inner = np.all((pts > 1e-12) & (pts < ext - 1e-12), axis=1)
    pts[inner] += 0.03 * h * rng.standard_normal(pts[inner].shape)
    rel_b, _ = _solve_plane_wave_xdmf(
        tmp_path, HexMesh(points=pts, cells=hm0.cells), L,
        quadrature="gauss",
    )
    # the documented shared floor (if a future change drops this below
    # 5e-5, the refutation recorded in docs/DESIGN.md needs revisiting)
    assert 5e-5 < rel_b < 1e-3, rel_b  # measured 2.20e-4


def test_imported_mesh_distributed_solve(imported_mesh):
    """Complete imported-mesh workflow, distributed: XDMF mesh -> tagged
    facets -> GeneralLinearWave -> ShardedGeneralWave over 4 virtual
    devices == single-device solve (the reference's mesh-agnostic MPI
    driver, demo/cpu_planar3d/main.cpp:39-45 + VectorUpdater)."""
    from wave_fenics_tpu.models.general_wave import GeneralLinearWave
    from wave_fenics_tpu.parallel.sharded_general import ShardedGeneralWave

    hm = imported_mesh
    # tagged facets by TOPOLOGY (vertex ids survive the perturbation):
    # basix hex face (0,2,4,6) is the -x face, (1,3,5,7) the +x face
    xlo, xhi = [], []
    # cells on the box faces: original box (3,2,2), x-slowest C-order
    for c in range(hm.ncells):
        cx = c // 4
        cell = hm.cells[c]
        if cx == 0:
            xlo.append([cell[v] for v in (0, 2, 4, 6)])
        if cx == 2:
            xhi.append([cell[v] for v in (1, 3, 5, 7)])
    md = GeneralLinearWave(
        mesh=hm, p=3,
        facet_tags={1: np.asarray(xlo), 2: np.asarray(xhi)},
        dtype=jnp.float64,
    )
    dt = 1e-9
    u1, v1 = md.solve_n(0.0, dt, 5)
    sw = ShardedGeneralWave(md, 4)
    u4, v4, _ = sw.solve_n(0.0, dt, 5)
    v1n = np.asarray(v1)
    np.testing.assert_allclose(sw.to_global(v4), v1n, rtol=1e-13,
                               atol=1e-14 * np.abs(v1n).max())
