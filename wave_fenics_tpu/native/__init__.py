"""Native (C++) host-precompute kernels with ctypes bindings.

``available()`` reports whether the shared library could be built/loaded;
all callers fall back to NumPy when it is unavailable, so the package works
on compiler-less systems. See wavecore.cpp for the kernel docs.
"""

from __future__ import annotations

import ctypes

import numpy as np

__all__ = ["available", "geometry_factors", "dedup_dofs", "box_cells"]

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    from .build import build

    path = build()
    if path is None:
        _lib = False
        return _lib
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        _lib = False
        return _lib

    lib.geometry_factors.restype = ctypes.c_int
    lib.geometry_factors.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ]
    lib.dedup_dofs.restype = ctypes.c_int64
    lib.dedup_dofs.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.box_cells.restype = None
    lib.box_cells.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return bool(_load())


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def geometry_factors(
    cell_coords: np.ndarray, dphi: np.ndarray, weights: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """(G[nc, nq, 3, 3], detJw[nc, nq]) — native path of
    core.geometry.precompute_geometric_data."""
    lib = _load()
    assert lib, "native library unavailable"
    cc = np.ascontiguousarray(cell_coords, dtype=np.float64)
    dp = np.ascontiguousarray(dphi, dtype=np.float64)
    w = np.ascontiguousarray(weights, dtype=np.float64)
    nc, nq = cc.shape[0], w.shape[0]
    G = np.empty((nc, nq, 9))
    detJw = np.empty((nc, nq))
    rc = lib.geometry_factors(
        _ptr(cc, ctypes.c_double), _ptr(dp, ctypes.c_double),
        _ptr(w, ctypes.c_double), nc, nq,
        _ptr(G, ctypes.c_double), _ptr(detJw, ctypes.c_double),
    )
    if rc != 0:
        raise ValueError("singular Jacobian in mesh")
    return G.reshape(nc, nq, 3, 3), detJw


def dedup_dofs(keys: np.ndarray) -> tuple[np.ndarray, int]:
    """(ids[n] int32, ndofs) — hash dedup of quantized node coordinates
    (native path of core.dofmap.build_dofmap)."""
    lib = _load()
    assert lib, "native library unavailable"
    k = np.ascontiguousarray(keys, dtype=np.int64)
    ids = np.empty(k.shape[0], dtype=np.int32)
    n = lib.dedup_dofs(_ptr(k, ctypes.c_int64), k.shape[0], _ptr(ids, ctypes.c_int32))
    return ids, int(n)


def box_cells(nx: int, ny: int, nz: int) -> np.ndarray:
    """[nx*ny*nz, 8] basix-ordered vertex ids of a structured box."""
    lib = _load()
    assert lib, "native library unavailable"
    out = np.empty((nx * ny * nz, 8), dtype=np.int64)
    lib.box_cells(nx, ny, nz, _ptr(out, ctypes.c_int64))
    return out
