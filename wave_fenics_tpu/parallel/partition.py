"""Domain decomposition over a logical device mesh.

Replaces the reference's MPI-rank Cartesian partitioner
(``decompose3d`` + process-grid setup, demo/gpu_cg/mesh.hpp:37-112) and the
owned+ghost IndexMap representation (DOLFINx ``common::IndexMap``).

Representation: the global dof grid is stored in **blocked**
form ``[mx, my, mz, gxl, gyl, gzl]`` where (mx, my, mz) is the device-mesh
shape and each block is the local dof grid of one device *including the
shared interface planes* (duplicated with the neighbor and kept consistent
by halo-add exchanges — see parallel.halo). Shard the first three axes over
the mesh and every block lives on exactly one device; all shapes static.

This collapses the reference's owned/ghost bookkeeping (variable-size
per-neighbor index lists + pack/unpack kernels, VectorUpdater.hpp:34-63)
into fixed-shape face slabs.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "decompose3d",
    "make_device_mesh",
    "block_grid",
    "unblock_grid",
    "blocked_sharding",
]


def decompose3d(n: int) -> tuple[int, int, int]:
    """Factor n devices into a near-cubic (mx, my, mz) process grid.

    Generalizes the reference's power-of-two split 2^x -> 2^x0 2^x1 2^x2
    (demo/gpu_cg/mesh.hpp:37-48) to arbitrary n via greedy prime assignment.
    """
    dims = [1, 1, 1]
    for f in _prime_factors(n)[::-1]:
        dims[int(np.argmin(dims))] *= f
    dims.sort(reverse=True)
    return tuple(dims)


def _prime_factors(n: int) -> list[int]:
    out, d = [], 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return sorted(out)


def make_device_mesh(
    parts: tuple[int, int, int], devices=None
) -> Mesh:
    """Create a 3D jax device mesh with axes ('x', 'y', 'z')."""
    if devices is None:
        devices = jax.devices()
    mx, my, mz = parts
    n = mx * my * mz
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    arr = np.array(devices[:n]).reshape(mx, my, mz)
    return Mesh(arr, axis_names=("x", "y", "z"))


def blocked_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for blocked arrays [mx, my, mz, gxl, gyl, gzl]."""
    return NamedSharding(mesh, P("x", "y", "z", None, None, None))


def block_grid(grid: np.ndarray, parts: tuple[int, int, int], p: int) -> np.ndarray:
    """Global dof grid [Nx, Ny, Nz] -> blocked [mx, my, mz, gxl, gyl, gzl].

    Block b along an axis with nl local cells covers dofs
    [b*nl*p, b*nl*p + nl*p] inclusive — consecutive blocks duplicate exactly
    one interface plane.
    """
    mx, my, mz = parts
    Nx, Ny, Nz = grid.shape
    nxl = (Nx - 1) // (mx * p) * p  # dofs-per-block minus shared plane
    nyl = (Ny - 1) // (my * p) * p
    nzl = (Nz - 1) // (mz * p) * p
    gxl, gyl, gzl = nxl + 1, nyl + 1, nzl + 1
    blocked = np.empty((mx, my, mz, gxl, gyl, gzl), dtype=grid.dtype)
    for bx in range(mx):
        for by in range(my):
            for bz in range(mz):
                blocked[bx, by, bz] = grid[
                    bx * nxl : bx * nxl + gxl,
                    by * nyl : by * nyl + gyl,
                    bz * nzl : bz * nzl + gzl,
                ]
    return blocked


def unblock_grid(blocked: np.ndarray, p: int) -> np.ndarray:
    """Inverse of :func:`block_grid` (takes the first copy of shared planes)."""
    mx, my, mz, gxl, gyl, gzl = blocked.shape
    nxl, nyl, nzl = gxl - 1, gyl - 1, gzl - 1
    Nx, Ny, Nz = mx * nxl + 1, my * nyl + 1, mz * nzl + 1
    grid = np.empty((Nx, Ny, Nz), dtype=blocked.dtype)
    for bx in range(mx):
        for by in range(my):
            for bz in range(mz):
                sx = slice(bx * nxl, bx * nxl + gxl)
                sy = slice(by * nyl, by * nyl + gyl)
                sz = slice(bz * nzl, bz * nzl + gzl)
                grid[sx, sy, sz] = blocked[bx, by, bz]
    return grid
