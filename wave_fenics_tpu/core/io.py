"""Mesh I/O: XDMF/HDF5 import (DOLFINx-exported meshes) + native formats.

Replaces the reference's mesh ingest path
(``io::XDMFFile.read_mesh`` / ``read_meshtags``,
demo/cpu_planar3d/main.cpp:40-45) so meshes produced for the reference
(e.g. the planar3d HIFU mesh) can be loaded directly:

- ``read_xdmf(path, grid_name)``: parses the XDMF XML, reads heavy data
  from the referenced HDF5 (h5py) or inline XML, converts VTK/XDMF
  hexahedron vertex ordering to basix ordering, returns a HexMesh.
- ``read_xdmf_meshtags``: facet tags (exterior boundary facets + values).
- ``write_xdmf_mesh`` / ``write_xdmf_meshtags``: their inverses, with
  inline XML data.
- ``save_npz`` / ``load_npz``: native lightweight format.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from .mesh import HexMesh

__all__ = [
    "read_xdmf",
    "read_xdmf_meshtags",
    "write_xdmf_mesh",
    "write_xdmf_meshtags",
    "save_npz",
    "load_npz",
    "write_xdmf_rectilinear",
    "write_xdmf_time_series",
]

# XDMF/VTK hexahedron vertex order -> basix order (see core.basis)
_VTK_TO_BASIX = np.array([0, 1, 3, 2, 4, 5, 7, 6])


def _read_data_item(item: ET.Element, xdmf_dir: str) -> np.ndarray:
    fmt = item.get("Format", "XML")
    dims = [int(d) for d in item.get("Dimensions", "").split()]
    if fmt == "HDF":
        import h5py

        ref = item.text.strip()
        fname, dset = ref.split(":")
        with h5py.File(os.path.join(xdmf_dir, fname), "r") as f:
            data = np.asarray(f[dset])
    elif fmt == "XML":
        data = np.fromstring(item.text.replace("\n", " "), sep=" ")
    else:
        raise ValueError(f"unsupported XDMF data format {fmt!r}")
    return data.reshape(dims) if dims else data


def _find_grid(root: ET.Element, name: str | None) -> ET.Element:
    grids = root.findall(".//Grid")
    if not grids:
        raise ValueError("no <Grid> in XDMF file")
    if name is None:
        return grids[0]
    for g in grids:
        if g.get("Name") == name:
            return g
    raise ValueError(f"grid {name!r} not found; have {[g.get('Name') for g in grids]}")


def read_xdmf(path: str, grid_name: str | None = None) -> HexMesh:
    """Read a hexahedral mesh from an XDMF file (DOLFINx/meshio flavor)."""
    tree = ET.parse(path)
    root = tree.getroot()
    xdmf_dir = os.path.dirname(os.path.abspath(path))
    grid = _find_grid(root, grid_name)

    topo = grid.find("Topology")
    geom = grid.find("Geometry")
    if topo is None or geom is None:
        raise ValueError("grid missing Topology/Geometry")
    ttype = (topo.get("TopologyType") or topo.get("Type") or "").lower()
    if "hexahedron" not in ttype:
        raise ValueError(f"only hexahedron meshes supported, got {ttype!r}")

    cells = _read_data_item(topo.find("DataItem"), xdmf_dir).astype(np.int64)
    cells = cells.reshape(-1, 8)[:, _VTK_TO_BASIX]
    points = _read_data_item(geom.find("DataItem"), xdmf_dir).astype(np.float64)
    if points.shape[1] == 2:
        points = np.concatenate([points, np.zeros((len(points), 1))], axis=1)
    return HexMesh(points=points, cells=cells)


def read_xdmf_meshtags(
    path: str, grid_name: str | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """(facets[n, 4] vertex ids, values[n]) of a quadrilateral facet-tag grid
    (the read_meshtags analogue for exterior boundary facets)."""
    tree = ET.parse(path)
    root = tree.getroot()
    xdmf_dir = os.path.dirname(os.path.abspath(path))
    grid = _find_grid(root, grid_name)
    topo = grid.find("Topology")
    facets = _read_data_item(topo.find("DataItem"), xdmf_dir).astype(np.int64)
    facets = facets.reshape(-1, 4)
    vals = None
    for attr in grid.findall("Attribute"):
        vals = _read_data_item(attr.find("DataItem"), xdmf_dir).astype(np.int32)
        break
    if vals is None:
        raise ValueError("no Attribute (tag values) in meshtags grid")
    return facets, vals.ravel()


def _xml_data_item(a: np.ndarray, fmt: str) -> str:
    """An inline (Format="XML") DataItem holding ``a``."""
    import io

    buf = io.StringIO()
    np.savetxt(buf, a.reshape(a.shape[0], -1), fmt=fmt)
    dims = " ".join(str(d) for d in a.shape)
    return (f'<DataItem Dimensions="{dims}" Format="XML">\n'
            f"{buf.getvalue()}</DataItem>")


def write_xdmf_mesh(path: str, mesh: HexMesh) -> None:
    """Write a hexahedral mesh as XDMF with inline XML data — the inverse
    of :func:`read_xdmf`, needing no HDF5. Coordinates keep 17
    significant digits, so they read back exactly."""
    cells = np.asarray(mesh.cells)[:, np.argsort(_VTK_TO_BASIX)]
    with open(path, "w") as f:
        f.write(f"""<?xml version="1.0"?>
<Xdmf Version="3.0"><Domain>
<Grid Name="mesh">
<Topology TopologyType="Hexahedron" NumberOfElements="{len(cells)}">
{_xml_data_item(cells, "%d")}
</Topology>
<Geometry GeometryType="XYZ">
{_xml_data_item(np.asarray(mesh.points, np.float64), "%.17g")}
</Geometry>
</Grid>
</Domain></Xdmf>
""")


def write_xdmf_meshtags(path: str, facets: np.ndarray,
                        values: np.ndarray) -> None:
    """Write facet tags as an XDMF quadrilateral grid with inline XML data
    — the inverse of :func:`read_xdmf_meshtags`. ``facets`` [n, 4] are
    in tensor (basix) vertex order and are written perimeter-wound, as
    XDMF/VTK quads are."""
    quads = np.asarray(facets)[:, [0, 1, 3, 2]]
    vals = np.asarray(values).reshape(-1, 1)
    with open(path, "w") as f:
        f.write(f"""<?xml version="1.0"?>
<Xdmf Version="3.0"><Domain>
<Grid Name="facet_tags">
<Topology TopologyType="Quadrilateral" NumberOfElements="{len(quads)}">
{_xml_data_item(quads, "%d")}
</Topology>
<Attribute Name="tags" Center="Cell">
{_xml_data_item(vals, "%d")}
</Attribute>
</Grid>
</Domain></Xdmf>
""")


def write_xdmf_rectilinear(
    path: str,
    axis_coords: tuple[np.ndarray, np.ndarray, np.ndarray],
    fields: dict[str, np.ndarray],
    time: float | None = None,
) -> None:
    """Write dof-grid fields as an XDMF 3DRectMesh (ParaView-readable).

    The reference never writes solution fields (SURVEY.md §5 I/O is
    read-only); this provides visualization output for structured solves:
    ``axis_coords`` are the GLL node lines (core.dofmap.axis_coords),
    ``fields`` maps name -> [Nx, Ny, Nz] array.
    """
    import h5py

    base = os.path.splitext(path)[0]
    h5name = base + ".h5"
    x, y, z = [np.asarray(c, dtype=np.float64) for c in axis_coords]
    shape = (x.size, y.size, z.size)
    with h5py.File(h5name, "w") as f:
        f["/x"], f["/y"], f["/z"] = x, y, z
        for name, arr in fields.items():
            assert arr.shape == shape, (name, arr.shape, shape)
            f["/" + name] = np.asarray(arr, dtype=np.float64)

    h5base = os.path.basename(h5name)
    # XDMF VXVYVZ order is (z, y, x)-fastest; our arrays are x-major.
    dims = f"{shape[0]} {shape[1]} {shape[2]}"
    attrs = "\n".join(
        f"""<Attribute Name="{n}" Center="Node">
<DataItem Dimensions="{dims}" Format="HDF">{h5base}:/{n}</DataItem>
</Attribute>"""
        for n in fields
    )
    tval = f'<Time Value="{time}"/>' if time is not None else ""
    with open(base + ".xdmf", "w") as f:
        f.write(f"""<?xml version="1.0"?>
<Xdmf Version="3.0"><Domain>
<Grid Name="grid">{tval}
<Topology TopologyType="3DRectMesh" Dimensions="{dims}"/>
<Geometry GeometryType="VXVYVZ">
<DataItem Dimensions="{z.size}" Format="HDF">{h5base}:/z</DataItem>
<DataItem Dimensions="{y.size}" Format="HDF">{h5base}:/y</DataItem>
<DataItem Dimensions="{x.size}" Format="HDF">{h5base}:/x</DataItem>
</Geometry>
{attrs}
</Grid>
</Domain></Xdmf>""")


def write_xdmf_unstructured(
    path: str,
    dofs,
    fields: dict[str, np.ndarray],
    time: float | None = None,
) -> None:
    """Write flat dof-vector fields of a GENERAL (imported/unstructured)
    solve as an XDMF hexahedral grid (ParaView-readable).

    Each degree-p spectral cell is emitted as its p^3 linear sub-hexes
    over the GLL nodes (the standard high-order visualization
    refinement), so nodal values appear exactly at the dof points.
    ``dofs``: core.dofmap.GeneralDofMap; ``fields``: name -> [ndofs].
    The reference writes no solution output at all (SURVEY.md §5);
    this completes the imported-mesh IO loop read_xdmf opens.
    """
    import h5py

    p = dofs.p
    m = p + 1
    idx = np.arange(m**3).reshape(m, m, m)  # (x, y, z)-nodes, z fastest
    corners = [
        idx[di : di + p, dj : dj + p, dk : dk + p].reshape(-1)
        for di, dj, dk in (
            # VTK hexahedron winding: bottom quad CCW, then top
            (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
            (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1),
        )
    ]
    sub = np.stack(corners, axis=1)  # [p^3, 8] local node ids
    topo = np.asarray(dofs.dofmap, np.int64)[:, sub].reshape(-1, 8)

    base = os.path.splitext(path)[0]
    h5name = base + ".h5"
    with h5py.File(h5name, "w") as f:
        f["/geom"] = np.asarray(dofs.dof_coords, np.float64)
        f["/topo"] = topo
        for name, arr in fields.items():
            arr = np.asarray(arr, np.float64).reshape(-1)
            assert arr.shape == (dofs.ndofs,), (name, arr.shape)
            f["/" + name] = arr

    h5base = os.path.basename(h5name)
    attrs = "\n".join(
        f"""<Attribute Name="{n}" Center="Node">
<DataItem Dimensions="{dofs.ndofs}" Format="HDF">{h5base}:/{n}</DataItem>
</Attribute>"""
        for n in fields
    )
    tval = f'<Time Value="{time}"/>' if time is not None else ""
    with open(base + ".xdmf", "w") as f:
        f.write(f"""<?xml version="1.0"?>
<Xdmf Version="3.0"><Domain>
<Grid Name="grid">{tval}
<Topology TopologyType="Hexahedron" NumberOfElements="{topo.shape[0]}">
<DataItem Dimensions="{topo.shape[0]} 8" Format="HDF">{h5base}:/topo</DataItem>
</Topology>
<Geometry GeometryType="XYZ">
<DataItem Dimensions="{dofs.ndofs} 3" Format="HDF">{h5base}:/geom</DataItem>
</Geometry>
{attrs}
</Grid>
</Domain></Xdmf>""")


def save_npz(path: str, mesh: HexMesh) -> None:
    np.savez(
        path,
        points=mesh.points,
        cells=mesh.cells,
        facets=mesh.facets if mesh.facets is not None else np.zeros((0, 4), np.int64),
        facet_tag_values=(
            mesh.facet_tag_values
            if mesh.facet_tag_values is not None
            else np.zeros((0,), np.int32)
        ),
    )


def load_npz(path: str) -> HexMesh:
    d = np.load(path)
    facets = d["facets"] if d["facets"].size else None
    vals = d["facet_tag_values"] if d["facet_tag_values"].size else None
    return HexMesh(
        points=d["points"], cells=d["cells"], facets=facets, facet_tag_values=vals
    )


def write_xdmf_time_series(
    path: str,
    axis_coords: tuple[np.ndarray, np.ndarray, np.ndarray],
    snapshots: list[tuple[float, dict[str, np.ndarray]]],
) -> None:
    """Write a temporal collection of dof-grid fields (ParaView-readable).

    ``snapshots``: list of (time, {name: [Nx, Ny, Nz]}). All heavy data in
    one HDF5 file; one XDMF temporal grid references it.
    """
    import h5py

    base = os.path.splitext(path)[0]
    h5name = base + ".h5"
    x, y, z = [np.asarray(c, dtype=np.float64) for c in axis_coords]
    shape = (x.size, y.size, z.size)
    dims = f"{shape[0]} {shape[1]} {shape[2]}"
    h5base = os.path.basename(h5name)

    with h5py.File(h5name, "w") as f:
        f["/x"], f["/y"], f["/z"] = x, y, z
        for s, (t, fields) in enumerate(snapshots):
            for name, arr in fields.items():
                assert arr.shape == shape, (name, arr.shape, shape)
                f[f"/step{s:06d}/{name}"] = np.asarray(arr, dtype=np.float64)

    geom = f"""<Geometry GeometryType="VXVYVZ">
<DataItem Dimensions="{z.size}" Format="HDF">{h5base}:/z</DataItem>
<DataItem Dimensions="{y.size}" Format="HDF">{h5base}:/y</DataItem>
<DataItem Dimensions="{x.size}" Format="HDF">{h5base}:/x</DataItem>
</Geometry>"""
    grids = []
    for s, (t, fields) in enumerate(snapshots):
        attrs = "\n".join(
            f"""<Attribute Name="{n}" Center="Node">
<DataItem Dimensions="{dims}" Format="HDF">{h5base}:/step{s:06d}/{n}</DataItem>
</Attribute>"""
            for n in fields
        )
        grids.append(f"""<Grid Name="t{s}"><Time Value="{t}"/>
<Topology TopologyType="3DRectMesh" Dimensions="{dims}"/>
{geom}
{attrs}
</Grid>""")
    body = "\n".join(grids)
    with open(base + ".xdmf", "w") as f:
        f.write(f"""<?xml version="1.0"?>
<Xdmf Version="3.0"><Domain>
<Grid Name="series" GridType="Collection" CollectionType="Temporal">
{body}
</Grid>
</Domain></Xdmf>""")
