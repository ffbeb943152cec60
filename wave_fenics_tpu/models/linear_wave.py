"""Linear second-order wave equation with source and absorbing boundaries.

Re-design of the reference model layer:
- ``LinearGLLOpt``     (common/LinearGLL.hpp:37-288): lumped mass, source
  windowing, RK4 driver
- the UFL boundary form (demo/cpu_planar3d/forms.ufl:21-24):
    L(v) = c0^2 * [ <g, v>_ds(1)  -  (1/c0) <v_n, v>_ds(2) ]
  with GLL facet quadrature.

Key representational shift: because facet quadrature is GLL-collocated, the
two boundary integrals are *diagonal* in the dof basis — they reduce to
precomputed lumped facet-weight grids W1/W2, so the per-stage "boundary
assembly" (fem::assemble_vector over ffcx facet kernels,
LinearGLL.hpp:175) becomes two pointwise AXPYs. No facet loop, no assembly,
nothing dynamic in the hot path.

Physics/time-stepping semantics match LinearGLL.hpp:
  du/dt = v
  dv/dt = ( -c0^2 K u + c0^2 g(t) W1 - c0 W2 v ) / m
  g(t)  = window(t) * p0 * w0 / c0 * cos(w0 t)        (:162)
  window(t) = 0.5 (1 - cos(f0 pi t / alpha)), t < alpha T; else 1  (:154-159)
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import jax
import jax.numpy as jnp
import numpy as np

from ..core.basis import lumped_weight_line
from ..core.mesh import StructuredBoxMesh
from ..ops.operators import StructuredOperators
from ..solvers.rk4 import rk4_solve

__all__ = ["LinearWave", "lumped_boundary_weights"]


def lumped_boundary_weights(
    mesh: StructuredBoxMesh, p: int, facets: tuple[int, ...]
) -> np.ndarray:
    """Lumped facet-mass grid: W[dof] = sum over tagged facets of
    integral of the dof's basis function over the facet (GLL-collocated
    facet quadrature => diagonal). Shape = dof grid; nonzero only on the
    selected box faces.

    Replaces the ffcx-generated exterior-facet kernels of the reference
    boundary form (forms.ufl:19-24) for structured boxes.
    """
    from ..core.mesh import BOX_FACETS

    shape = tuple(n * p + 1 for n in mesh.shape)
    W = np.zeros(shape)
    for fid in facets:
        axis, side = BOX_FACETS[fid]
        tang = [d for d in range(3) if d != axis]
        lines = [
            lumped_weight_line(mesh.shape[d], p, mesh.h[d]) for d in tang
        ]
        face = np.multiply.outer(lines[0], lines[1])
        idx = [slice(None)] * 3
        idx[axis] = 0 if side == 0 else -1
        W[tuple(idx)] += face
    return W


@dataclass(frozen=True)
class LinearWave:
    """The wave model on a structured box: operators + physics + integrator.

    Parameters mirror LinearGLLOpt's constructor
    (common/LinearGLL.hpp:69-128): basis degree, speed of sound, source
    frequency, pressure amplitude; plus boundary tags resolved through the
    mesh's facet_tags (source tag 1, absorbing tag 2, forms.ufl:21-24).
    """

    mesh: StructuredBoxMesh
    p: int
    c0: float = 1500.0
    freq0: float = 0.5e6
    p0: float = 60000.0
    alpha: float = 4.0
    source_tag: int = 1
    abc_tag: int = 2
    dtype: type = jnp.float32
    #: optional per-cell sound speed (heterogeneous media); c0 remains the
    #: reference speed used by the source/ABC boundary terms
    c0_cells: object = None

    @cached_property
    def ops(self) -> StructuredOperators:
        coeff = None
        if self.c0_cells is not None:
            coeff = (np.asarray(self.c0_cells) / self.c0) ** 2
        return StructuredOperators(
            self.mesh, self.p, dtype=self.dtype, coeff_cells=coeff
        )

    @property
    def w0(self) -> float:
        return 2.0 * np.pi * self.freq0

    @property
    def period(self) -> float:
        return 1.0 / self.freq0

    @cached_property
    def m(self) -> np.ndarray:
        """Lumped mass grid m = M @ 1 (LinearGLL.hpp:105-110)."""
        return self.ops.lumped_mass

    @cached_property
    def inv_m(self) -> np.ndarray:
        """1/m precomputed — the optimization the reference left as a TODO
        (LinearGLL.hpp:179-181). NumPy constant; trace-safe."""
        return (1.0 / self.m).astype(np.dtype(self.dtype))

    @cached_property
    def W1(self) -> np.ndarray:
        facets = self.mesh.facet_tags.facets_of(self.source_tag)
        return lumped_boundary_weights(self.mesh, self.p, facets).astype(
            np.dtype(self.dtype)
        )

    @cached_property
    def W2(self) -> np.ndarray:
        facets = self.mesh.facet_tags.facets_of(self.abc_tag)
        return lumped_boundary_weights(self.mesh, self.p, facets).astype(
            np.dtype(self.dtype)
        )

    # -- physics --------------------------------------------------------
    def window(self, t: jax.Array) -> jax.Array:
        """Source ramp over the first alpha periods (LinearGLL.hpp:154-159)."""
        Talpha = self.period * self.alpha
        ramp = 0.5 * (1.0 - jnp.cos(self.freq0 * jnp.pi * t / self.alpha))
        return jnp.where(t < Talpha, ramp, 1.0)

    def g_amplitude(self, t: jax.Array) -> jax.Array:
        """Uniform source value g(t) (LinearGLL.hpp:162)."""
        return self.window(t) * self.p0 * self.w0 / self.c0 * jnp.cos(self.w0 * t)

    def f0(self, t, u, v):
        """du/dt = v (LinearGLL.hpp:141-144)."""
        return v

    def f1(self, t, u, v):
        """dv/dt = (stiffness + boundary) / m (LinearGLL.hpp:151-192)."""
        b = self.ops.stiffness(u, self.c0)
        # keep the traced g(t) scalar in the state dtype (bf16 states would
        # otherwise promote the whole pipeline to the time dtype)
        g = (self.c0**2 * self.g_amplitude(t)).astype(self.dtype)
        b = b + g * self.W1 - self.c0 * (self.W2 * v)
        return b * self.inv_m

    # -- leapfrog decomposition: f1 = force(t, u) - damping * v ---------
    def force(self, t, u):
        """Mass-normalized v-independent acceleration (stiffness +
        source) for the leapfrog integrator (solvers/leapfrog.py)."""
        b = self.ops.stiffness(u, self.c0)
        g = (self.c0**2 * self.g_amplitude(t)).astype(self.dtype)
        return (b + g * self.W1) * self.inv_m

    @cached_property
    def damping(self) -> "np.ndarray":
        """Diagonal ABC damping grid D = c0 W2 / m."""
        return (self.c0 * self.W2 * np.asarray(self.inv_m)).astype(
            np.dtype(self.dtype)
        )

    # -- driver -----------------------------------------------------------
    def zero_state(self) -> tuple[jax.Array, jax.Array]:
        """u_0 = v_0 = 0 (LinearGLL.hpp:131-134)."""
        z = jnp.zeros(self.ops.grid_shape, dtype=self.dtype)
        return z, z

    def solve(
        self,
        t0: float,
        tf: float,
        dt: float,
        u0: jax.Array | None = None,
        v0: jax.Array | None = None,
    ):
        """RK4 from t0 to tf; returns (u, v, nsteps). Jit the closure once
        per (shape, dt) — the scan compiles to a single device program."""
        if u0 is None:
            u0, v0 = self.zero_state()
        return rk4_solve(self.f0, self.f1, u0, v0, t0, tf, dt)


def probe_indices(
    model: LinearWave, points: "np.ndarray"
) -> tuple["np.ndarray", "np.ndarray", "np.ndarray"]:
    """Grid indices of the dofs nearest to the given physical points
    (probe/"hydrophone" placement)."""
    from ..core.dofmap import StructuredDofGrid

    dg = StructuredDofGrid(model.mesh, model.p)
    pts = np.atleast_2d(points)
    idx = []
    for d in range(3):
        coords = dg.axis_coords(d)
        idx.append(np.abs(coords[None, :] - pts[:, d : d + 1]).argmin(axis=1))
    return tuple(np.asarray(i) for i in idx)


def solve_recording(
    model: LinearWave,
    t0: float,
    dt: float,
    nsteps: int,
    points: "np.ndarray",
    u0=None,
    v0=None,
):
    """RK4 solve recording the pressure time series at probe points.

    Returns (u, v, series[nsteps, npoints]) — fully on-device; the series
    is the only per-step output (tiny), so recording is ~free.
    """
    from ..solvers.rk4 import rk4_solve_n_recording

    if u0 is None:
        u0, v0 = model.zero_state()
    ii, jj, kk = probe_indices(model, points)

    def sample(t, u, v):
        return u[ii, jj, kk]

    return rk4_solve_n_recording(
        model.f0, model.f1, u0, v0, t0, dt, nsteps, sample
    )
