"""Matrix-free global operators: gather -> element kernel -> scatter.

Grid-level equivalents of the reference operator layer (SURVEY.md §1 L3):
- ``MassOperator`` (GPU fused)          common/cuda/mass.hpp:17-107
- ``SpectralMassOperator`` (diagonal)   common/cuda/spectral_mass.hpp:23-100
- ``MassOperatorCPU``                   common/operators.hpp:43-109
- ``StiffnessOperator``                 common/operators.hpp:136-201
  (with c0 as a runtime parameter, fixing the reference's hardcoded
   c0=1500 wart at common/operators.hpp:114)

Two families:

- ``StructuredOperators``: structured-box fast path — overlap gather/scatter,
  diagonal geometric factor, everything closed over as jnp constants. Apply
  functions are pure ``grid -> grid`` maps, jit/vmap/shard_map-safe.
- ``GeneralOperators``: explicit-dofmap path (imported meshes), full 3x3 G,
  jnp.take / sorted-scatter data movement on flat dof vectors.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import jax
import jax.numpy as jnp
import numpy as np

from ..core import geometry
from ..core.basis import tabulate_1d
from ..core.dofmap import GeneralDofMap
from ..core.mesh import HexMesh, StructuredBoxMesh
from . import element_kernels as ek
from . import gather_scatter as gs

__all__ = ["StructuredOperators", "GeneralOperators"]


@dataclass(frozen=True)
class StructuredOperators:
    """Matrix-free operators on a structured GLL dof grid.

    Built once per (mesh, p, dtype); all tables are tiny jnp constants that
    jit folds into the compiled program.
    """

    mesh: StructuredBoxMesh
    p: int
    dtype: type = jnp.float32
    #: optional per-cell stiffness coefficient (heterogeneous media); when
    #: set, stiffness() uses the per-cell kernel (the separable path
    #: requires a uniform coefficient). Shape [ncells].
    coeff_cells: object = None

    def __post_init__(self):
        tab = tabulate_1d(self.p)
        assert tab.collocated, "structured operators assume GLL collocation"
        m = self.p + 1
        Gdiag, detJw = geometry.structured_geometric_factors(self.mesh, self.p)
        # Tables are kept as NumPy: jnp ops treat them as compile-time
        # constants, and (unlike jnp arrays created lazily) they can never
        # leak tracers when an operator is first built inside a jit trace.
        npdt = np.dtype(self.dtype)
        object.__setattr__(self, "_D", tab.D.astype(npdt))
        object.__setattr__(self, "_detJw", detJw.reshape(1, m, m, m).astype(npdt))
        Gd = Gdiag.reshape(1, m, m, m, 3).astype(npdt)
        if self.coeff_cells is not None:
            cc = np.asarray(self.coeff_cells, dtype=npdt)
            Gd = Gd * cc[:, None, None, None, None]
        object.__setattr__(self, "_Gdiag", Gd)
        from .separable import grid_lines, separable_stiffness_tables

        A, _ = separable_stiffness_tables(self.p, self.mesh.h, self.dtype)
        object.__setattr__(self, "_sepA", A)
        object.__setattr__(
            self, "_seplines", grid_lines(self.mesh.shape, self.p, self.dtype)
        )

    @property
    def grid_shape(self) -> tuple[int, int, int]:
        return tuple(n * self.p + 1 for n in self.mesh.shape)

    @property
    def ndofs(self) -> int:
        gx, gy, gz = self.grid_shape
        return gx * gy * gz

    # -- data movement -------------------------------------------------
    def gather(self, x: jax.Array) -> jax.Array:
        return gs.gather_grid(x, self.p)

    def scatter(self, ye: jax.Array) -> jax.Array:
        return gs.scatter_grid(ye, self.p, self.mesh.shape)

    # -- operators ------------------------------------------------------
    def spectral_mass(self, x: jax.Array) -> jax.Array:
        """y = M x for the GLL-collocated (spectral) mass.

        The reference implements this as gather -> pointwise detJw ->
        atomic scatter (common/cuda/spectral_mass.hpp:84-89) because its
        dofs are indirection-mapped. On a structured grid the globally
        assembled M is diagonal, so the whole apply is one fused
        elementwise multiply by the precomputed diagonal — pure HBM
        bandwidth, no data movement. The reference-shaped 3-pass route is
        kept as :meth:`spectral_mass_roundtrip` (same values to fp
        roundoff; exercised by the oracle/determinism tests and the
        scatter benchmark)."""
        return self.lumped_mass * x

    def spectral_mass_roundtrip(self, x: jax.Array) -> jax.Array:
        """y = M x via gather -> pointwise detJw -> scatter — the
        reference's data-movement shape (spectral_mass.hpp:84-89)."""
        return self.scatter(ek.spectral_mass_element(self.gather(x), self._detJw))

    @cached_property
    def lumped_mass(self) -> np.ndarray:
        """m = M @ 1 as a grid — the diagonal of M under GLL collocation
        (LinearGLL.hpp:105-110). Mass matvec == pointwise m*x.

        Closed form on structured boxes: the separable overlap-add of 1D
        GLL weight lines (NumPy constant; trace-safe)."""
        from ..core.basis import lumped_weight_line

        lines = [
            lumped_weight_line(self.mesh.shape[d], self.p, self.mesh.h[d])
            for d in range(3)
        ]
        return np.einsum("i,j,k->ijk", *lines).astype(np.dtype(self.dtype))

    def mass(self, x: jax.Array) -> jax.Array:
        """Collocated mass matvec via the lumped vector (pointwise)."""
        return self.lumped_mass * x

    def mass_gauss(self, x: jax.Array, q: int | None = None) -> jax.Array:
        """Consistent (non-lumped) mass matvec with Gauss quadrature — the
        CEED BP1 operator (demo/gpu_cg/bp1.ufl:20-21, quadrature p+2).

        On a uniform box the operator is an exact Kronecker product of 1D
        assembled mass matrices, so the matvec is three sequential banded
        contractions (ops.separable.mass_separable).
        """
        from .separable import mass_separable, separable_mass_tables

        M1 = separable_mass_tables(self.p, self.mesh.h, self.dtype, q=q)
        return mass_separable(x, M1, self.p)

    def stiffness(self, x: jax.Array, c0: float | jax.Array = 1.0) -> jax.Array:
        """y = -c0^2 * K x (sign convention of the reference skernel,
        common/operators.hpp:114-133), by the separable grid-space
        formulation (ops.separable); a per-cell coefficient takes the
        per-cell kernel."""
        if self.coeff_cells is not None:
            # heterogeneous coefficient: only the per-cell kernel applies
            return self.stiffness_percell(x, c0)
        from .separable import stiffness_separable

        coeff = -jnp.asarray(c0, dtype=self.dtype) ** 2
        return stiffness_separable(x, self._sepA, self._seplines, self.p, coeff)

    def stiffness_percell(
        self, x: jax.Array, c0: float | jax.Array = 1.0
    ) -> jax.Array:
        """Generic per-cell path (gather -> element contraction -> scatter);
        kept as the cross-implementation oracle and for benchmarks."""
        coeff = -jnp.asarray(c0, dtype=self.dtype) ** 2
        ye = ek.stiffness_element_diag(self.gather(x), self._D, self._Gdiag, coeff)
        return self.scatter(ye)


@dataclass(frozen=True)
class GeneralOperators:
    """Matrix-free operators over an explicit dofmap (imported hex meshes).

    Supports non-collocated quadrature (``rule='gauss'`` — the decomposed
    B^T D B pipeline of demo/gpu_operator) and full 3x3 geometric factors.
    Vectors are flat ``[ndofs]`` arrays.
    """

    mesh: HexMesh
    dofs: GeneralDofMap
    dtype: type = jnp.float32
    q: int | None = None
    rule: str = "gll"
    #: optional per-cell stiffness coefficient (e.g. (c0(x)/c0_ref)^2 for
    #: heterogeneous media); folded into G at setup. Shape [ncells].
    coeff_cells: object = None
    #: 'ell' (transpose-gather, default) or 'sorted' (XLA sorted scatter)
    scatter_mode: str = "ell"

    def __post_init__(self):
        p = self.dofs.p
        tab = tabulate_1d(p, self.q, self.rule)
        G, detJw = geometry.precompute_geometric_data(
            self.mesh, p, self.q, self.rule
        )
        if self.coeff_cells is not None:
            cc = np.asarray(self.coeff_cells, dtype=G.dtype)
            G = G * cc[:, None, None, None]
        nq1 = tab.nq
        nc = self.mesh.ncells
        npdt = np.dtype(self.dtype)
        object.__setattr__(self, "_tab", tab)
        object.__setattr__(self, "_B", tab.B.astype(npdt))
        object.__setattr__(self, "_D", tab.D.astype(npdt))
        object.__setattr__(
            self, "_detJw", detJw.reshape(nc, nq1, nq1, nq1).astype(npdt)
        )
        object.__setattr__(
            self, "_G", G.reshape(nc, nq1, nq1, nq1, 3, 3).astype(npdt)
        )
        object.__setattr__(self, "_dofmap", self.dofs.dofmap)

    @property
    def ndofs(self) -> int:
        return self.dofs.ndofs

    def gather(self, x: jax.Array) -> jax.Array:
        m = self.dofs.p + 1
        xe = gs.gather_indexed(x, self._dofmap)
        return xe.reshape(-1, m, m, m)

    @cached_property
    def _ell(self) -> gs.EllScatter:
        return gs.build_ell_scatter(self._dofmap, self.ndofs)

    def scatter(self, ye: jax.Array) -> jax.Array:
        """Element->dof scatter-add. Default: the ELL transpose-gather
        formulation (no indexed scatter-add on the hot path);
        ``scatter_mode='sorted'`` keeps the XLA sorted-scatter baseline."""
        if self.scatter_mode == "sorted":
            nc = ye.shape[0]
            return gs.scatter_indexed(
                ye.reshape(nc, -1), self._dofmap, self.ndofs
            )
        return gs.scatter_ell(ye, self._ell)

    def mass(self, x: jax.Array) -> jax.Array:
        """y = M x — gather -> per-element B^T diag(detJw) B -> scatter,
        any quadrature rule (mass_apply semantics,
        common/cuda/mass_kernel.cu:4-46)."""
        return self.scatter(ek.mass_element(self.gather(x), self._B, self._detJw))

    def spectral_mass(self, x: jax.Array) -> jax.Array:
        """y = M x for the collocated (diagonal) mass: one multiply by the
        assembled diagonal (see StructuredOperators.spectral_mass)."""
        assert self._tab.collocated
        return jnp.asarray(self.lumped_mass) * x

    def spectral_mass_roundtrip(self, x: jax.Array) -> jax.Array:
        """Reference-shaped gather -> detJw -> scatter path
        (spectral_mass.hpp:84-89); requires collocated quadrature."""
        assert self._tab.collocated
        return self.scatter(ek.spectral_mass_element(self.gather(x), self._detJw))

    @cached_property
    def lumped_mass(self) -> np.ndarray:
        """m = M @ 1 via NumPy (host precompute; trace-safe constant)."""
        m1 = self.dofs.p + 1
        nc = self.mesh.ncells
        ones = np.ones((nc, m1, m1, m1), dtype=np.dtype(self.dtype))
        uq = np.einsum("qi,cijk->cqjk", self._B, ones)
        uq = np.einsum("qj,cijk->ciqk", self._B, uq)
        uq = np.einsum("qk,cijk->cijq", self._B, uq) * self._detJw
        ye = np.einsum("qi,cqjk->cijk", self._B, uq)
        ye = np.einsum("qj,ciqk->cijk", self._B, ye)
        ye = np.einsum("qk,cijq->cijk", self._B, ye)
        out = np.zeros((self.ndofs,), dtype=np.dtype(self.dtype))
        np.add.at(out, self._dofmap.ravel(), ye.reshape(nc, -1).ravel())
        return out

    def stiffness(self, x: jax.Array, c0: float | jax.Array = 1.0) -> jax.Array:
        """y = -c0^2 K x with full G (skernel semantics,
        common/operators.hpp:112-133): gather -> element contraction ->
        scatter."""
        coeff = -jnp.asarray(c0, dtype=self.dtype) ** 2
        ye = ek.stiffness_element_full(
            self.gather(x), self._B, self._D, self._G, coeff
        )
        return self.scatter(ye)
