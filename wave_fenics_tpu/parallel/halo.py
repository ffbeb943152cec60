"""Halo exchange over the device mesh: ppermute face-slab add.

Replacement for the reference's CUDA-aware-MPI ``VectorUpdater``
(demo/gpu_scatter_mpi/VectorUpdater.hpp:21-230):

- variable-size per-neighbor pack/unpack index lists  ->  fixed-shape face
  slabs of the local dof grid (interface planes are *duplicated* on both
  neighboring devices, see parallel.partition)
- MPI_Irecv/MPI_Send on device pointers              ->  ``lax.ppermute``
  (NCCL on GPUs), one shift per direction per axis
- update_rev (ghost -> owner add) followed by update_fwd (owner -> ghost)
  ->  a single **halo-add**: after each side adds the neighbor's partial
  plane, both duplicated copies hold the full sum, so no second
  (forward) exchange is ever needed — one exchange where the reference
  does two.

Edge/corner contributions propagate correctly because the three axis
exchanges run sequentially on full planes (standard structured halo
sweep).

These functions must run inside ``shard_map`` over a mesh with the given
axis names; outside shard_map they are identity (single-device fallback).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["halo_add_axis", "halo_add", "halo_sync_axis", "halo_sync"]


def halo_add_axis(
    local: jax.Array, grid_axis: int, axis_name: str, axis_size: int
) -> jax.Array:
    """Halo-add along one blocked axis.

    local: the device-local dof block (shared interface planes included).
    After this call, the first and last plane along ``grid_axis`` hold the
    full (both-sides) sum on both neighboring devices.
    """
    if axis_size == 1:
        return local

    lo = lax.slice_in_dim(local, 0, 1, axis=grid_axis)
    hi = lax.slice_in_dim(
        local, local.shape[grid_axis] - 1, local.shape[grid_axis], axis=grid_axis
    )
    # Send my low plane to the left neighbor (their high plane partner):
    # perm pairs are (source, destination).
    left_perm = [(i, i - 1) for i in range(1, axis_size)]
    right_perm = [(i, i + 1) for i in range(axis_size - 1)]
    from_right = lax.ppermute(lo, axis_name, left_perm)  # right nbr's low
    from_left = lax.ppermute(hi, axis_name, right_perm)  # left nbr's high
    # Devices with no neighbor receive zeros (ppermute semantics).
    new_lo = lo + from_left
    new_hi = hi + from_right
    mid = lax.slice_in_dim(local, 1, local.shape[grid_axis] - 1, axis=grid_axis)
    return jnp.concatenate([new_lo, mid, new_hi], axis=grid_axis)


def halo_add(
    local: jax.Array,
    mesh_shape: tuple[int, int, int],
    axis_names: tuple[str, str, str] = ("x", "y", "z"),
    grid_axes: tuple[int, int, int] = (0, 1, 2),
) -> jax.Array:
    """Full 3D halo-add sweep (x, then y, then z)."""
    for ga, an, sz in zip(grid_axes, axis_names, mesh_shape):
        local = halo_add_axis(local, ga, an, sz)
    return local


def halo_sync_axis(
    local: jax.Array, grid_axis: int, axis_name: str, axis_size: int
) -> jax.Array:
    """Owner -> duplicate copy along one axis (the ``update_fwd`` analogue,
    VectorUpdater.hpp:106-152): the lower-indexed block owns each shared
    plane; its high plane overwrites the right neighbor's low plane.

    Only needed to re-establish the duplicated-plane invariant after an
    operation that broke it (e.g. external per-block writes); solver-internal
    ops preserve it via halo_add."""
    if axis_size == 1:
        return local
    hi = lax.slice_in_dim(
        local, local.shape[grid_axis] - 1, local.shape[grid_axis], axis=grid_axis
    )
    from_left = lax.ppermute(
        hi, axis_name, [(i, i + 1) for i in range(axis_size - 1)]
    )
    lo = lax.slice_in_dim(local, 0, 1, axis=grid_axis)
    idx = jax.lax.axis_index(axis_name)
    new_lo = jnp.where(idx > 0, from_left, lo)
    mid_hi = lax.slice_in_dim(local, 1, local.shape[grid_axis], axis=grid_axis)
    return jnp.concatenate([new_lo, mid_hi], axis=grid_axis)


def halo_sync(
    local: jax.Array,
    mesh_shape: tuple[int, int, int],
    axis_names: tuple[str, str, str] = ("x", "y", "z"),
    grid_axes: tuple[int, int, int] = (0, 1, 2),
) -> jax.Array:
    """Full 3D owner->duplicate sweep."""
    for ga, an, sz in zip(grid_axes, axis_names, mesh_shape):
        local = halo_sync_axis(local, ga, an, sz)
    return local
