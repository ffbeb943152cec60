"""Multi-chip wave solver: the full model under ``shard_map``.

The distributed-solve analogue of the reference's MPI deployment
(LinearGLL over DOLFINx-partitioned meshes + VectorUpdater halo exchange,
SURVEY.md §3.1/§3.5) — re-designed SPMD:

- each device owns a block of cells and the corresponding dof-grid block
  (interface planes duplicated, parallel.partition)
- the ENTIRE time loop (lax.scan; RK4 or leapfrog) runs inside one
  shard_map: per force evaluation, a local sum-factorized stiffness apply +
  one 3-axis ppermute halo-add. No host round-trips, no per-step dispatch.
- global reductions (CG dots, norms) use ownership-weighted inner products
  (duplicated planes down-weighted by 1/multiplicity) — the IndexMap
  owned/ghost distinction reduced to a static weight mask.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.mesh import StructuredBoxMesh
from ..models.linear_wave import LinearWave, lumped_boundary_weights
from ..ops.operators import StructuredOperators
from ..solvers.leapfrog import leapfrog_solve_n
from ..solvers.rk4 import rk4_solve_n
from .halo import halo_add
from .partition import block_grid, make_device_mesh, unblock_grid

__all__ = ["ShardedLinearWave", "ownership_weights"]

_BLOCK_SPEC = P("x", "y", "z", None, None, None)


def ownership_weights(
    parts: tuple[int, int, int], block_shape: tuple[int, int, int]
) -> np.ndarray:
    """Blocked weight array: 1/multiplicity for each dof copy.

    Interface planes duplicated along one axis get 1/2, edges 1/4, corners
    1/8 — so a weighted sum over all blocks counts every global dof once.
    """
    mx, my, mz = parts
    gxl, gyl, gzl = block_shape
    out = np.ones((mx, my, mz, gxl, gyl, gzl))
    for b_axis, (m, g) in enumerate(zip(parts, block_shape)):
        for b in range(m):
            w = np.ones(g)
            if b > 0:
                w[0] = 0.5
            if b < m - 1:
                w[-1] = 0.5
            shape = [1] * 6
            shape[3 + b_axis] = g
            idx = [slice(None)] * 6
            idx[b_axis] = b
            out[tuple(idx)] *= w.reshape(shape[3:])
    return out


@dataclass(frozen=True)
class ShardedLinearWave:
    """LinearWave distributed over a (mx, my, mz) device mesh.

    The physics/semantics are identical to :class:`LinearWave`; tests assert
    bit-level-tight agreement with the single-device solve.
    """

    model: LinearWave
    parts: tuple[int, int, int]
    devices: tuple | None = None

    def __post_init__(self):
        for n, m in zip(self.model.mesh.shape, self.parts):
            if n % m != 0:
                raise ValueError(
                    f"cells {self.model.mesh.shape} not divisible by mesh {self.parts}"
                )

    @cached_property
    def mesh(self) -> Mesh:
        return make_device_mesh(self.parts, self.devices)

    @cached_property
    def local_cells(self) -> tuple[int, int, int]:
        return tuple(n // m for n, m in zip(self.model.mesh.shape, self.parts))

    @cached_property
    def block_shape(self) -> tuple[int, int, int]:
        return tuple(n * self.model.p + 1 for n in self.local_cells)

    @cached_property
    def local_ops(self) -> StructuredOperators:
        """Per-device operators: a local box mesh with the same cell sizes.

        Geometry tables depend only on (h, p), so every device closes over
        identical constants — no per-device precompute arrays to ship.
        """
        gm = self.model.mesh
        local_extent = tuple(
            h * n for h, n in zip(gm.h, self.local_cells)
        )
        local_mesh = StructuredBoxMesh(
            shape=self.local_cells, extent=local_extent, origin=gm.origin
        )
        return StructuredOperators(local_mesh, self.model.p, dtype=self.model.dtype)

    # -- blocked constant fields ---------------------------------------
    def _blocked(self, grid_np: np.ndarray) -> jax.Array:
        b = block_grid(grid_np, self.parts, self.model.p)
        return jax.device_put(
            jnp.asarray(b, dtype=self.model.dtype),
            NamedSharding(self.mesh, _BLOCK_SPEC),
        )

    @cached_property
    def W1(self) -> jax.Array:
        facets = self.model.mesh.facet_tags.facets_of(self.model.source_tag)
        return self._blocked(
            lumped_boundary_weights(self.model.mesh, self.model.p, facets)
        )

    @cached_property
    def W2(self) -> jax.Array:
        facets = self.model.mesh.facet_tags.facets_of(self.model.abc_tag)
        return self._blocked(
            lumped_boundary_weights(self.model.mesh, self.model.p, facets)
        )

    @cached_property
    def inv_m(self) -> jax.Array:
        from ..core.basis import lumped_weight_line

        gm = self.model.mesh
        p = self.model.p
        lines = [lumped_weight_line(gm.shape[d], p, gm.h[d]) for d in range(3)]
        m = np.einsum("i,j,k->ijk", *lines)
        return self._blocked(1.0 / m)

    @cached_property
    def own_w(self) -> np.ndarray:
        """Ownership weights as a NumPy constant: kept OFF-device so the
        cached value can never be a leaked tracer when ``dot`` is first
        called inside a jit trace and later retraced (jnp ops treat the
        NumPy array as a compile-time constant; GSPMD shards it to match
        the blocked operand)."""
        w = ownership_weights(self.parts, self.block_shape)
        return np.asarray(w, dtype=np.dtype(self.model.dtype))

    # -- state ----------------------------------------------------------
    def zero_state(self):
        mx, my, mz = self.parts
        shape = (mx, my, mz) + self.block_shape
        z = jax.device_put(
            jnp.zeros(shape, dtype=self.model.dtype),
            NamedSharding(self.mesh, _BLOCK_SPEC),
        )
        return z, z

    def to_global(self, blocked: jax.Array) -> np.ndarray:
        return unblock_grid(np.asarray(blocked), self.model.p)

    def from_global(self, grid: np.ndarray) -> jax.Array:
        return self._blocked(grid)

    # -- distributed operators ------------------------------------------
    def _f1_local(self, t, u, v, W1, W2, inv_m):
        """Local f1: stiffness + halo-add + boundary/mass pointwise.

        Runs on un-squeezed blocks [1,1,1,gxl,gyl,gzl]; grid axes are 3..5.
        """
        md = self.model
        sq = lambda a: a.reshape(a.shape[3:])
        u3, v3 = sq(u), sq(v)
        b = self.local_ops.stiffness(u3, md.c0)
        b = halo_add(b, self.parts)
        b = b + (md.c0**2 * md.g_amplitude(t)) * sq(W1) - md.c0 * (sq(W2) * v3)
        out = b * sq(inv_m)
        return out.reshape(u.shape)

    def _force_local(self, t, u, W1, inv_m):
        """v-independent part of :meth:`_f1_local` — the leapfrog force
        (solvers/leapfrog.py); the ABC damping splits off as the diagonal
        c0 * W2 * inv_m."""
        md = self.model
        sq = lambda a: a.reshape(a.shape[3:])
        b = self.local_ops.stiffness(sq(u), md.c0)
        b = halo_add(b, self.parts)
        b = b + (md.c0**2 * md.g_amplitude(t)) * sq(W1)
        return (b * sq(inv_m)).reshape(u.shape)

    def solve(self, t0: float, tf: float, dt: float, u0=None, v0=None):
        """Distributed RK4: one shard_map around the whole time loop."""
        return self.solve_n(t0, dt, int(round((tf - t0) / dt)), u0, v0)

    def solve_n(self, t0: float, dt: float, nsteps: int, u0=None, v0=None,
                integrator: str = "rk4"):
        """``integrator``: 'rk4' (reference parity) or 'leapfrog' (ONE
        stiffness apply + halo-add per step; 2nd order, dt <= ~0.71x the
        RK4 CFL step — solvers/leapfrog.py)."""
        if integrator not in ("rk4", "leapfrog"):
            raise ValueError(f"unknown integrator: {integrator!r}")
        if u0 is None:
            u0, v0 = self.zero_state()

        def local_solve(u, v, W1, W2, inv_m):
            if integrator == "leapfrog":
                damp = self.model.c0 * W2 * inv_m
                force = lambda t, uu: self._force_local(t, uu, W1, inv_m)
                return leapfrog_solve_n(force, damp, u, v, t0, dt, nsteps)
            f0 = lambda t, uu, vv: vv
            f1 = lambda t, uu, vv: self._f1_local(t, uu, vv, W1, W2, inv_m)
            return rk4_solve_n(f0, f1, u, v, t0, dt, nsteps)

        sm = shard_map(
            local_solve,
            mesh=self.mesh,
            in_specs=(_BLOCK_SPEC,) * 5,
            out_specs=(_BLOCK_SPEC, _BLOCK_SPEC),
        )
        u, v = jax.jit(sm)(u0, v0, self.W1, self.W2, self.inv_m)
        return u, v, nsteps

    # -- distributed linear algebra --------------------------------------
    def dot(self, a: jax.Array, b: jax.Array) -> jax.Array:
        """Ownership-weighted global inner product (the MPI_Allreduce-of-
        cublasDdot analogue, cg.hpp:88-91)."""
        return jnp.vdot(self.own_w * a, b)

    def stiffness(self, x: jax.Array, c0: float) -> jax.Array:
        """Distributed matrix-free stiffness matvec on blocked arrays."""

        def local(xb):
            sq = xb.reshape(xb.shape[3:])
            y = self.local_ops.stiffness(sq, c0)
            y = halo_add(y, self.parts)
            return y.reshape(xb.shape)

        return shard_map(
            local, mesh=self.mesh, in_specs=(_BLOCK_SPEC,), out_specs=_BLOCK_SPEC
        )(x)

    def spectral_mass(self, x: jax.Array) -> jax.Array:
        def local(xb):
            sq = xb.reshape(xb.shape[3:])
            y = self.local_ops.spectral_mass(sq)
            y = halo_add(y, self.parts)
            return y.reshape(xb.shape)

        return shard_map(
            local, mesh=self.mesh, in_specs=(_BLOCK_SPEC,), out_specs=_BLOCK_SPEC
        )(x)
