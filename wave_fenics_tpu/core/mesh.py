"""Hexahedral meshes: structured boxes (the fast path) and general hex meshes.

Replaces the DOLFINx mesh layer consumed by the reference:
- ``mesh::create_box`` (demo/gpu_operator/main.cpp:60-72, etc.)
- the Cartesian hex mesh generator/partitioner ``benchmark::create_hex_mesh``
  (demo/gpu_cg/mesh.hpp:21-328)
- XDMF mesh+tags ingest for planar3d (demo/cpu_planar3d/main.cpp:39-45) — see
  :mod:`wave_fenics_tpu.core.io` for the import path.
- cell-size query ``mesh::h`` (demo/cpu_planar3d/main.cpp:52-58)

Design note: the solver's hot path never touches mesh topology —
for structured boxes, dof gather/scatter is pure reshape/overlap-add (see
ops.gather_scatter) and geometry factors are closed-form. The general
``HexMesh`` path supports imported/unstructured hex meshes via an explicit
vertex/cell representation and geometric dof dedup.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["StructuredBoxMesh", "HexMesh", "box_mesh", "FacetTags"]

# Basix/DOLFINx hexahedron vertex order (see basis._HEX_VERTICES): the local
# vertex v has reference coordinates (v&1, (v>>1)&1, (v>>2)&1).
_VERTEX_COORDS = np.array(
    [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
     [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]],
    dtype=np.float64,
)

# Facet id convention for structured boxes: (axis, side) pairs.
# 0: x=lo, 1: x=hi, 2: y=lo, 3: y=hi, 4: z=lo, 5: z=hi
BOX_FACETS = [(0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (2, 1)]


@dataclass(frozen=True)
class FacetTags:
    """Boundary tags: maps tag id -> tuple of box facet ids.

    Analogue of DOLFINx ``MeshTags`` over exterior facets
    (demo/cpu_planar3d/main.cpp:44-45). For structured boxes a tag selects
    whole box faces; general meshes carry per-facet tags on HexMesh.
    """

    tags: dict[int, tuple[int, ...]] = field(default_factory=dict)

    def facets_of(self, tag: int) -> tuple[int, ...]:
        return self.tags.get(tag, ())


@dataclass(frozen=True)
class StructuredBoxMesh:
    """Axis-aligned box of uniform hex cells — the fast-path mesh.

    shape:  number of cells per axis (nx, ny, nz)
    extent: physical lengths (Lx, Ly, Lz)
    origin: lower corner
    facet_tags: boundary tags over the 6 box faces
    """

    shape: tuple[int, int, int]
    extent: tuple[float, float, float]
    origin: tuple[float, float, float] = (0.0, 0.0, 0.0)
    facet_tags: FacetTags = field(default_factory=FacetTags)

    @property
    def ncells(self) -> int:
        nx, ny, nz = self.shape
        return nx * ny * nz

    @property
    def h(self) -> tuple[float, float, float]:
        """Cell edge lengths (hx, hy, hz)."""
        return tuple(L / n for L, n in zip(self.extent, self.shape))

    def hmin(self) -> float:
        """Smallest cell diameter (max inter-vertex distance), matching
        DOLFINx ``mesh::h`` used for the CFL timestep
        (demo/cpu_planar3d/main.cpp:52-58). Uniform cells -> all equal."""
        return float(np.sqrt(sum(h * h for h in self.h)))

    def vertices_grid(self) -> np.ndarray:
        """Vertex coordinates as a grid [nx+1, ny+1, nz+1, 3]."""
        nx, ny, nz = self.shape
        hx, hy, hz = self.h
        ox, oy, oz = self.origin
        x = ox + hx * np.arange(nx + 1)
        y = oy + hy * np.arange(ny + 1)
        z = oz + hz * np.arange(nz + 1)
        X, Y, Z = np.meshgrid(x, y, z, indexing="ij")
        return np.stack([X, Y, Z], axis=-1)

    def cell_midpoints(self) -> np.ndarray:
        nx, ny, nz = self.shape
        hx, hy, hz = self.h
        ox, oy, oz = self.origin
        x = ox + hx * (np.arange(nx) + 0.5)
        y = oy + hy * (np.arange(ny) + 0.5)
        z = oz + hz * (np.arange(nz) + 0.5)
        X, Y, Z = np.meshgrid(x, y, z, indexing="ij")
        return np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1)

    def to_hex_mesh(self) -> "HexMesh":
        """Explicit vertex/cell representation (for oracle tests and the
        general-geometry code path)."""
        nx, ny, nz = self.shape
        V = self.vertices_grid().reshape(-1, 3)  # lex, x slowest? see below

        def vid(i, j, k):
            return (i * (ny + 1) + j) * (nz + 1) + k

        cells = np.empty((self.ncells, 8), dtype=np.int64)
        c = 0
        for i in range(nx):
            for j in range(ny):
                for k in range(nz):
                    cells[c] = [
                        vid(i + vx, j + vy, k + vz)
                        for (vx, vy, vz) in _VERTEX_COORDS.astype(int)
                    ]
                    c += 1
        return HexMesh(points=V, cells=cells)


def box_mesh(
    shape: tuple[int, int, int],
    extent: tuple[float, float, float],
    origin: tuple[float, float, float] = (0.0, 0.0, 0.0),
    facet_tags: FacetTags | None = None,
) -> StructuredBoxMesh:
    """Convenience constructor mirroring ``mesh::create_box``."""
    return StructuredBoxMesh(
        shape=tuple(shape),
        extent=tuple(extent),
        origin=tuple(origin),
        facet_tags=facet_tags or FacetTags(),
    )


@dataclass(frozen=True)
class HexMesh:
    """General (possibly unstructured/curved-free trilinear) hex mesh.

    points: [n_points, 3] vertex coordinates
    cells:  [n_cells, 8] vertex ids in basix hexahedron order
    facets: optional [n_tagged_facets, 4] vertex ids of tagged exterior facets
    facet_tag_values: optional [n_tagged_facets] integer tags
    """

    points: np.ndarray
    cells: np.ndarray
    facets: np.ndarray | None = None
    facet_tag_values: np.ndarray | None = None

    @property
    def ncells(self) -> int:
        return self.cells.shape[0]

    def cell_coords(self) -> np.ndarray:
        """Per-cell vertex coordinates, [n_cells, 8, 3]."""
        return self.points[self.cells]

    def hmin(self) -> float:
        """Smallest cell diameter (max pairwise vertex distance per cell)."""
        cc = self.cell_coords()  # [nc, 8, 3]
        d = np.linalg.norm(cc[:, :, None, :] - cc[:, None, :, :], axis=-1)
        return float(d.max(axis=(1, 2)).min())
