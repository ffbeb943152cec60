"""Dof gather/scatter between global vectors and element-local tensors.

Replacement for the reference's CUDA data-movement kernels:
- ``gather``  kernel: ``out[i] = in[indices[i]]``        (common/cuda/scatter.cu:4-11,47-55)
- ``scatter`` kernel: ``atomicAdd(&out[idx[i]], in[i])`` (common/cuda/scatter.cu:38-45,57-65)

Two paths:

1. **Structured overlap path** (the fast one): on a structured GLL dof grid
   ``[Nx, Ny, Nz]`` (Nd = n_d*p + 1), element tensors overlap the grid in a
   regular stride-p pattern, so gather is m strided slices per axis and
   scatter-add is a separable 1D overlap-add — pure slice/reshape/pad/add,
   no indexed scatter, fully deterministic (the reference needs atomics to
   resolve write races; here the races are designed away).

2. **General indexed path**: ``jnp.take`` / ``.at[].add`` over an explicit
   dofmap, for imported/unstructured meshes. XLA lowers the scatter-add to a
   sorted deterministic scatter.

Element tensors: ``[ncells, m, m, m]`` with m = p+1, axes (x, y, z)-nodes,
cells in C-order over (cx, cy, cz) — see core.dofmap.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = [
    "gather_1d",
    "scatter_1d",
    "gather_grid",
    "scatter_grid",
    "gather_indexed",
    "scatter_indexed",
    "EllScatter",
    "build_ell_scatter",
    "scatter_ell",
]


def gather_1d(arr: jax.Array, p: int, axis: int) -> jax.Array:
    """Split one grid axis of size n*p+1 into (n, p+1) overlapping cell axes.

    out[..., c, i, ...] = arr[..., c*p + i, ...]; the new cell axis replaces
    ``axis`` and the local-node axis is ``axis+1``.
    """
    N = arr.shape[axis]
    if (N - 1) % p != 0:
        raise ValueError(
            f"grid axis {axis} has size {N}, not n*p+1 for degree p={p}"
        )
    n = (N - 1) // p
    m = p + 1
    parts = [
        lax.slice_in_dim(arr, i, i + (n - 1) * p + 1, stride=p, axis=axis)
        for i in range(m)
    ]
    return jnp.stack(parts, axis=axis + 1)


def scatter_1d(ye: jax.Array, p: int, axis: int) -> jax.Array:
    """Overlap-add the (cell, node) axis pair back onto one grid axis.

    Inverse-transpose of :func:`gather_1d`:
    out[..., g, ...] = sum_{c*p+i == g} ye[..., c, i, ...].
    Pure reshape/pad/add — no indexed scatter.
    """
    n = ye.shape[axis]
    m = ye.shape[axis + 1]
    p_ = m - 1
    assert p_ == p, (m, p)
    N = n * p + 1

    # Interior part: nodes i in [0, p) tile the grid positions [0, n*p).
    lo = lax.slice_in_dim(ye, 0, p, axis=axis + 1)  # [..., n, p, ...]
    new_shape = lo.shape[:axis] + (n * p,) + lo.shape[axis + 2 :]
    lo = lo.reshape(new_shape)
    pad = [(0, 0)] * lo.ndim
    pad[axis] = (0, 1)
    out = jnp.pad(lo, pad)  # [..., N, ...]

    # Last-node part: i = p lands at grid positions (c+1)*p = 1 + c*p + (p-1).
    hi = lax.slice_in_dim(ye, p, p + 1, axis=axis + 1)  # [..., n, 1, ...]
    pad = [(0, 0)] * hi.ndim
    pad[axis + 1] = (p - 1, 0)
    hi = jnp.pad(hi, pad)  # [..., n, p, ...] value in last column
    hi = hi.reshape(new_shape)
    pad = [(0, 0)] * hi.ndim
    pad[axis] = (1, 0)
    return out + jnp.pad(hi, pad)


def gather_grid(grid: jax.Array, p: int) -> jax.Array:
    """Grid [Nx, Ny, Nz] -> element tensors [ncells, m, m, m].

    Replaces the dofmap gather kernel (common/cuda/scatter.cu:47-55) for
    structured meshes.
    """
    a = gather_1d(grid, p, 0)  # [nx, m, Ny, Nz]
    a = gather_1d(a, p, 2)  # [nx, m, ny, m, Nz]
    a = gather_1d(a, p, 4)  # [nx, m, ny, m, nz, m]
    a = a.transpose(0, 2, 4, 1, 3, 5)  # [nx, ny, nz, m, m, m]
    nx, ny, nz, m, _, _ = a.shape
    return a.reshape(nx * ny * nz, m, m, m)


def scatter_grid(
    ye: jax.Array, p: int, cells_shape: tuple[int, int, int]
) -> jax.Array:
    """Element tensors [ncells, m, m, m] -> grid [Nx, Ny, Nz] with overlap-add.

    Replaces the atomicAdd scatter kernel (common/cuda/scatter.cu:57-65);
    deterministic by construction.
    """
    nx, ny, nz = cells_shape
    m = ye.shape[-1]
    p_ = m - 1
    assert p_ == p
    a = ye.reshape(nx, ny, nz, m, m, m).transpose(0, 3, 1, 4, 2, 5)
    # [nx, m, ny, m, nz, m]
    a = scatter_1d(a, p, 4)  # [nx, m, ny, m, Nz]
    a = scatter_1d(a, p, 2)  # [nx, m, Ny, Nz]
    return scatter_1d(a, p, 0)  # [Nx, Ny, Nz]


def gather_indexed(x: jax.Array, dofmap: jax.Array) -> jax.Array:
    """General path: xe[c, n] = x[dofmap[c, n]] (jnp.take on a flat vector).

    Dofmaps are valid by construction, so bounds clamping is skipped."""
    return x.at[dofmap].get(mode="promise_in_bounds")


def scatter_indexed(ye: jax.Array, dofmap: jax.Array, ndofs: int) -> jax.Array:
    """General path: y[dofmap[c, n]] += ye[c, n], deterministic sorted scatter."""
    return (
        jnp.zeros((ndofs,), dtype=ye.dtype)
        .at[dofmap.ravel()]
        .add(ye.ravel(), mode="promise_in_bounds")
    )


# ---------------------------------------------------------------------------
# ELL transpose-gather scatter: scatter-add re-expressed as gathers
# ---------------------------------------------------------------------------
#
# The scatter operator S (y[d] = sum over element entries e with
# dofmap[e] == d of ye[e]) is a fixed sparse matrix whose row d has
# mult(d) entries — the number of cells sharing dof d (<= 8 interior on
# conforming hex meshes; arbitrary at unstructured vertices). Transposing
# the access turns the indexed scatter-add (common/cuda/scatter.cu:57-65
# solves this with atomicAdd) into multiplicity-bucketed fixed-width
# GATHERS + row sums: for each dof, read its mult source entries from the
# flat element tensor and add them. Gathers need no atomics; write-side
# indexing reduces to one unique-index set per bucket. Deterministic by
# construction (fixed summation order), like everything else here.


@dataclass(frozen=True)
class EllScatter:
    """Precomputed transpose tables: per multiplicity bucket ``(dofs, src)``.

    ``src[n, w]`` indexes the flat element vector (value ``nsrc`` = the
    zero-pad slot); ``dofs[n]`` are the (unique, sorted) destination dofs.
    """

    buckets: tuple[tuple[np.ndarray, np.ndarray], ...]
    ndofs: int
    nsrc: int


def build_ell_scatter(dofmap: np.ndarray, ndofs: int) -> EllScatter:
    """Build transpose-gather tables from an explicit dofmap (host, once)."""
    flat = np.asarray(dofmap).ravel()
    nsrc = flat.size
    order = np.argsort(flat, kind="stable").astype(np.int32)
    counts = np.bincount(flat, minlength=ndofs)
    assert counts.min() >= 1, "every dof must appear in the dofmap"
    starts = np.zeros(ndofs + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])

    # bucket widths: next power of two >= multiplicity
    buckets = []
    logc = np.ceil(np.log2(np.maximum(counts, 1))).astype(np.int64)
    for lw in np.unique(logc):
        w = int(1 << lw)
        dofs = np.where(logc == lw)[0].astype(np.int32)
        idx = starts[dofs][:, None] + np.arange(w)[None, :]
        valid = np.arange(w)[None, :] < counts[dofs][:, None]
        src = np.where(
            valid, order[np.minimum(idx, nsrc - 1)], nsrc
        ).astype(np.int32)
        buckets.append((dofs, src))
    return EllScatter(buckets=tuple(buckets), ndofs=ndofs, nsrc=nsrc)


def scatter_ell(ye: jax.Array, ell: EllScatter) -> jax.Array:
    """y[d] = sum of ye.ravel()[src[d]] — the gather-formulated scatter-add."""
    yp = jnp.concatenate(
        [ye.ravel(), jnp.zeros((1,), dtype=ye.dtype)]
    )
    out = jnp.zeros((ell.ndofs,), dtype=ye.dtype)
    for dofs, src in ell.buckets:
        vals = yp.at[src].get(mode="promise_in_bounds").sum(axis=1)
        out = out.at[dofs].set(
            vals, mode="promise_in_bounds", unique_indices=True
        )
    return out
