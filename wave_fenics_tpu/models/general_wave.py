"""Linear wave model on general (imported/unstructured) hex meshes.

Completes parity with the reference's mesh-agnostic driver
(demo/cpu_planar3d/main.cpp reads an arbitrary XDMF hex mesh + facet tags):
:class:`GeneralLinearWave` runs the LinearGLL physics on any
``core.mesh.HexMesh`` with tagged exterior quad facets, using the indexed
operator family (ops.operators.GeneralOperators).

Boundary facet integrals are assembled once at setup by GLL facet
quadrature on each tagged bilinear facet: with collocation the integral is
diagonal, so each facet contributes ``w_i w_j |J_s(x_ij)|`` to the dof at
its (i, j) facet node, where |J_s| = |d x/du x d x/dv| is the surface
element. Facet nodes are matched to volume dofs by the same quantized
geometric keying used for the dofmap (exact for trilinear cells, since a
face restriction depends only on the face's vertices).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import jax.numpy as jnp
import numpy as np

from ..core.basis import gll_points_weights
from ..core.dofmap import GeneralDofMap, build_dofmap
from ..core.mesh import HexMesh
from ..ops.operators import GeneralOperators
from ..solvers.rk4 import rk4_solve, rk4_solve_n

__all__ = ["GeneralLinearWave", "facet_lumped_weights"]


def facet_lumped_weights(
    mesh: HexMesh,
    dofs: GeneralDofMap,
    facets: np.ndarray,
    p: int,
    tol: float = 1e-9,
    rule: str = "gll",
    qdeg: int | None = None,
) -> np.ndarray:
    """Lumped facet-mass vector W[ndofs]: sum over the given facets of
    W_i = integral of phi_i |J_s| over the facet, accumulated at the
    matching volume dofs.

    ``rule='gll'`` (default, reference parity): diagonal GLL facet
    quadrature — W at facet node (i, j) is w_i w_j |J_s(x_ij)|.
    ``rule='gauss'``: the consistent-quadrature companion of the
    Gauss-rule volume operators — |J_s| evaluated at tensor Gauss points
    and row-sum lumped, W[i, j] = sum_ab qw_a qw_b B[a,i] B[b,j]
    |J_s(u_a, v_b)| (|J_s| is non-polynomial on bilinear facets, so the
    GLL rule underintegrates it on distorted meshes — the same
    quadrature crime as the volume terms)."""
    nodes, w1d = gll_points_weights(p + 1)
    U, V = np.meshgrid(nodes, nodes, indexing="ij")
    u = U.ravel()
    v = V.ravel()

    # dof lookup by the same quantized key as build_dofmap —
    # vectorized (a Python dict over ndofs entries costs
    # gigabytes/minutes at 64^3+)
    scale = max(np.abs(mesh.points).max(), 1.0)
    q = scale * tol
    keys = np.round(dofs.dof_coords / q).astype(np.int64)

    fa = np.asarray(facets)
    fc = mesh.points[fa]  # [nf, 4, 3]
    v0, v1, v2, v3 = (fc[:, i, None, :] for i in range(4))

    def surf(uu, vv):
        """Bilinear facet map + surface element at param points."""
        x = ((1 - uu) * (1 - vv) * v0 + uu * (1 - vv) * v1
             + (1 - uu) * vv * v2 + uu * vv * v3)  # [nf, npt, 3]
        xu = (1 - vv) * (v1 - v0) + vv * (v3 - v2)
        xv = (1 - uu) * (v2 - v0) + uu * (v3 - v1)
        return x, np.linalg.norm(np.cross(xu, xv), axis=-1)

    x, Js = surf(u[None, :, None], v[None, :, None])
    if rule == "gll":
        Wf = np.outer(w1d, w1d).ravel()[None, :] * Js  # [nf, nd2]
    elif rule == "gauss":
        from ..core.basis import tabulate_1d

        tab = tabulate_1d(p, qdeg, "gauss")
        Uq, Vq = np.meshgrid(tab.qpts, tab.qpts, indexing="ij")
        _, Jg = surf(Uq.ravel()[None, :, None],
                     Vq.ravel()[None, :, None])
        Jg = Jg.reshape(len(fa), tab.nq, tab.nq)
        Wf = np.einsum(
            "ai,bj,a,b,fab->fij", tab.B, tab.B, tab.qwts, tab.qwts, Jg
        ).reshape(len(fa), -1)
    else:
        raise ValueError(f"unknown quadrature rule {rule!r}")
    fkeys = np.round(x.reshape(-1, 3) / q).astype(np.int64)
    from .. import native

    if native.available():
        # one hash pass over [dof keys; facet keys]: dof keys are
        # unique, so the first-appearance group ids of the dof section
        # are the identity and facet entries resolve directly to dof
        # ids (a fresh id >= ndofs means an unmatched facet node)
        ids_all, _ = native.dedup_dofs(
            np.concatenate([keys, fkeys], axis=0)
        )
        ids = ids_all[len(keys):].astype(np.int64)
        ok = ids < dofs.ndofs
    else:
        kv = np.ascontiguousarray(keys).view(
            [("", np.int64)] * 3
        ).reshape(-1)
        order = np.argsort(kv)
        sk = kv[order]
        fv = np.ascontiguousarray(fkeys).view(
            [("", np.int64)] * 3
        ).reshape(-1)
        pos = np.searchsorted(sk, fv)
        ok = (pos < len(sk)) & (sk[np.minimum(pos, len(sk) - 1)] == fv)
        ids = order[np.minimum(pos, len(sk) - 1)]
    if not ok.all():
        raise ValueError(
            "facet node does not coincide with a volume dof — "
            "facet vertex ordering or mesh/tag mismatch"
        )
    W = np.zeros(dofs.ndofs)
    np.add.at(W, ids, Wf.ravel())
    return W


@dataclass(frozen=True)
class GeneralLinearWave:
    """LinearGLL physics on a general hex mesh (flat dof vectors).

    ``facet_tags``: dict tag -> facet vertex array [n, 4]; tag 1 = source,
    tag 2 = absorbing (forms.ufl:21-24 convention), overridable.
    """

    mesh: HexMesh
    p: int
    facet_tags: dict
    c0: float = 1500.0
    freq0: float = 0.5e6
    p0: float = 60000.0
    alpha: float = 4.0
    source_tag: int = 1
    abc_tag: int = 2
    dtype: type = jnp.float64
    #: optional per-cell sound speed for heterogeneous media (e.g. tissue
    #: layers); ``c0`` stays the reference speed used by the source/ABC
    #: boundary terms. Shape [ncells].
    c0_cells: object = None
    #: 'gll' (reference parity: collocated p+1-point quadrature + lumped
    #: mass, common/operators.hpp:63-72 + LinearGLL.hpp:105-110) or
    #: 'gauss' — the CONSISTENT-quadrature mode: Gauss-rule stiffness,
    #: row-sum-lumped Gauss mass, and matching Gauss facet weights. On
    #: non-affine (trilinear) cells the GLL scheme's underintegrated
    #: geometric factor floors the plane-wave error at ~O(distortion)
    #: (~2.6e-4 at 3% vertex jitter, h-independent — the reference shares
    #: this floor); 'gauss' integrates the rational G accurately and
    #: breaks the floor (an exceeds-parity accuracy mode; the reference
    #: has no GPU Gauss operators at all). On affine meshes the two modes
    #: agree to quadrature exactness. Explicit integrators work
    #: unchanged: the Gauss mass is row-sum lumped, so it stays diagonal.
    quadrature: str = "gll"
    #: quadrature exactness degree for 'gauss' (None -> 2p: p+1 points)
    quadrature_degree: int | None = None

    @cached_property
    def dofs(self) -> GeneralDofMap:
        return build_dofmap(self.mesh, self.p)

    @cached_property
    def ops(self) -> GeneralOperators:
        coeff = None
        if self.c0_cells is not None:
            coeff = (np.asarray(self.c0_cells) / self.c0) ** 2
        return GeneralOperators(
            self.mesh, self.dofs, dtype=self.dtype, coeff_cells=coeff,
            rule=self.quadrature, q=self.quadrature_degree,
        )

    @property
    def ndofs(self) -> int:
        return self.dofs.ndofs

    @property
    def w0(self) -> float:
        return 2.0 * np.pi * self.freq0

    @property
    def period(self) -> float:
        return 1.0 / self.freq0

    @cached_property
    def m(self) -> np.ndarray:
        return self.ops.lumped_mass

    @cached_property
    def inv_m(self) -> np.ndarray:
        return (1.0 / self.m).astype(np.dtype(self.dtype))

    def _tag_weights(self, tag: int) -> np.ndarray:
        facets = self.facet_tags.get(tag)
        if facets is None or len(facets) == 0:
            return np.zeros(self.ndofs, dtype=np.dtype(self.dtype))
        return facet_lumped_weights(
            self.mesh, self.dofs, facets, self.p,
            rule=self.quadrature, qdeg=self.quadrature_degree,
        ).astype(np.dtype(self.dtype))

    @cached_property
    def W1(self) -> np.ndarray:
        return self._tag_weights(self.source_tag)

    @cached_property
    def W2(self) -> np.ndarray:
        return self._tag_weights(self.abc_tag)

    # -- physics (LinearGLL.hpp:141-192 semantics) -----------------------
    def window(self, t):
        Talpha = self.period * self.alpha
        ramp = 0.5 * (1.0 - jnp.cos(self.freq0 * jnp.pi * t / self.alpha))
        return jnp.where(t < Talpha, ramp, 1.0)

    def g_amplitude(self, t):
        return self.window(t) * self.p0 * self.w0 / self.c0 * jnp.cos(self.w0 * t)

    def f0(self, t, u, v):
        return v

    def f1(self, t, u, v):
        b = self.ops.stiffness(u, self.c0)
        g = (self.c0**2 * self.g_amplitude(t)).astype(self.dtype)
        b = b + g * self.W1 - self.c0 * (self.W2 * v)
        return b * self.inv_m

    # -- leapfrog decomposition: f1 = force(t, u) - damping * v ---------
    def force(self, t, u):
        """Mass-normalized v-independent acceleration (stiffness +
        source); the damping splits off diagonally for the semi-implicit
        leapfrog half-kicks (solvers/leapfrog.py)."""
        b = self.ops.stiffness(u, self.c0)
        g = (self.c0**2 * self.g_amplitude(t)).astype(self.dtype)
        return (b + g * self.W1) * self.inv_m

    @cached_property
    def damping(self) -> np.ndarray:
        """Diagonal ABC damping vector D = c0 W2 / m (zero off the
        absorbing boundary)."""
        return (self.c0 * self.W2 * np.asarray(self.inv_m)).astype(
            np.dtype(self.dtype)
        )

    # -- driver ------------------------------------------------------------
    def zero_state(self):
        z = jnp.zeros((self.ndofs,), dtype=self.dtype)
        return z, z

    def solve(self, t0, tf, dt, u0=None, v0=None):
        """End-to-end solve, compiled with operator tables hoisted to
        runtime arguments (utils.closure.hoisted_jit) rather than closed
        into the scan as HLO literals (hundreds of MB at production mesh
        sizes)."""
        from ..utils.closure import hoisted_jit

        if u0 is None:
            u0, v0 = self.zero_state()
        fn = hoisted_jit(
            lambda u, v: rk4_solve(self.f0, self.f1, u, v, t0, tf, dt),
            u0, v0,
        )
        return fn(u0, v0)

    def solve_n(self, t0, dt, nsteps, u0=None, v0=None,
                integrator: str = "rk4"):
        """``integrator``: 'rk4' (reference parity, 4 stiffness applies
        per step) or 'leapfrog' (2nd-order, ONE apply per step; needs
        dt <= ~0.71x the RK4 CFL step — solvers/leapfrog.py)."""
        from ..utils.closure import hoisted_jit

        if u0 is None:
            u0, v0 = self.zero_state()
        if integrator == "leapfrog":
            from ..solvers.leapfrog import leapfrog_solve_n

            damp = jnp.asarray(self.damping)
            fn = hoisted_jit(
                lambda u, v: leapfrog_solve_n(
                    self.force, damp, u, v, t0, dt, nsteps),
                u0, v0,
            )
        elif integrator == "rk4":
            fn = hoisted_jit(
                lambda u, v: rk4_solve_n(self.f0, self.f1, u, v, t0, dt,
                                         nsteps),
                u0, v0,
            )
        else:
            raise ValueError(f"unknown integrator: {integrator!r}")
        return fn(u0, v0)


def probe_dofs(model: GeneralLinearWave, points) -> np.ndarray:
    """Dof ids nearest to the given physical points — hydrophone
    placement on an imported mesh (the general-mesh analogue of
    ``linear_wave.probe_indices``; same nearest-GLL-node fidelity)."""
    pts = np.atleast_2d(np.asarray(points, np.float64))
    dc = np.asarray(model.dofs.dof_coords, np.float64)
    ids = np.empty(len(pts), np.int64)
    for i, q in enumerate(pts):  # npoints is tiny; O(npts * ndofs)
        ids[i] = int(((dc - q) ** 2).sum(axis=1).argmin())
    return ids


def solve_recording(
    model: GeneralLinearWave,
    t0: float,
    dt: float,
    nsteps: int,
    points,
    u0=None,
    v0=None,
    integrator: str = "rk4",
):
    """Solve recording the pressure time series at probe points on a
    general mesh. Returns (u, v, series[nsteps, npoints]); the series is
    the only per-step output, so recording is ~free (mirrors
    ``linear_wave.solve_recording``). ``integrator`` as in
    :meth:`GeneralLinearWave.solve_n`."""
    from ..utils.closure import hoisted_jit

    if u0 is None:
        u0, v0 = model.zero_state()
    ids = jnp.asarray(probe_dofs(model, points))

    def sample(t, u, v):
        return u[ids]

    if integrator == "leapfrog":
        from ..solvers.leapfrog import leapfrog_solve_n_recording

        damp = jnp.asarray(model.damping)
        fn = hoisted_jit(
            lambda uu, vv: leapfrog_solve_n_recording(
                model.force, damp, uu, vv, t0, dt, nsteps, sample
            ),
            u0, v0,
        )
    elif integrator == "rk4":
        from ..solvers.rk4 import rk4_solve_n_recording

        fn = hoisted_jit(
            lambda uu, vv: rk4_solve_n_recording(
                model.f0, model.f1, uu, vv, t0, dt, nsteps, sample
            ),
            u0, v0,
        )
    else:
        raise ValueError(f"unknown integrator: {integrator!r}")
    return fn(u0, v0)


def from_xdmf(
    mesh_path: str,
    meshtags_path: str | None = None,
    mesh_grid: str | None = None,
    tags_grid: str | None = None,
    p: int = 4,
    **physics,
) -> GeneralLinearWave:
    """Build the wave model from DOLFINx-exported XDMF files — the complete
    reference workflow (demo/cpu_planar3d/main.cpp:40-45): mesh + boundary
    meshtags in, ready-to-solve model out."""
    from ..core.io import read_xdmf, read_xdmf_meshtags

    mesh = read_xdmf(mesh_path, mesh_grid)
    facet_tags: dict = {}
    if meshtags_path is not None:
        facets, values = read_xdmf_meshtags(meshtags_path, tags_grid)
        # XDMF/VTK quads are perimeter-wound (v0,v1,v2,v3); basix order is
        # (v0,v1,v3,v2) — swap the last two for the bilinear facet map.
        facets = facets[:, [0, 1, 3, 2]]
        for tag in np.unique(values):
            facet_tags[int(tag)] = facets[values == tag]
    return GeneralLinearWave(mesh=mesh, p=p, facet_tags=facet_tags, **physics)
