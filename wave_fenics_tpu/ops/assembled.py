"""Element-assembled and globally-assembled operator baselines.

The reference's alternative operator family (demo/gpu_cg/operators.hpp):
- ``assemble_element_tensor``: dense per-element matrices A_e
  (common/precompute.hpp:202-232)
- ``EAOperator``: stored-A_e matvec, gather -> A_e x_e -> scatter, with an
  optional libxsmm JIT batched gemm (operators.hpp:127-201). Here the
  batched [nc, nd, nd] x [nc, nd] gemm is one XLA batched matmul — no JIT
  library needed.
- ``PETScOperator``: assembled-sparse baseline (operators.hpp:72-124).
  Here: a SciPy CSR global matrix (host oracle / comparison baseline) and
  a jax BCOO matvec for on-device use.
- ``MatFreeOperator`` (operators.hpp:29-69) — the reference's
  "assemble_vector with x as coefficient" trick — is subsumed by the
  native matrix-free operators (ops.operators); the EA path here provides
  the independent cross-check it was used for.
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
from ..core.mesh import HexMesh
from . import gather_scatter as gs

__all__ = ["assemble_element_tensors", "EAOperator", "assemble_csr"]


def _tables_3d(p: int, q: int | None, rule: str):
    tab = tabulate_1d(p, q, rule)
    B, D = tab.B, tab.D
    Phi = np.einsum("qi,rj,sk->qrsijk", B, B, B).reshape(tab.nq**3, tab.nd**3)
    dx = np.einsum("qi,rj,sk->qrsijk", D, B, B).reshape(tab.nq**3, tab.nd**3)
    dy = np.einsum("qi,rj,sk->qrsijk", B, D, B).reshape(tab.nq**3, tab.nd**3)
    dz = np.einsum("qi,rj,sk->qrsijk", B, B, D).reshape(tab.nq**3, tab.nd**3)
    return Phi, np.stack([dx, dy, dz])


def assemble_element_tensors(
    mesh: HexMesh,
    p: int,
    q: int | None = None,
    rule: str = "gll",
    kind: str = "mass",
    coeff: float = 1.0,
) -> np.ndarray:
    """Dense per-element matrices A_e[nc, nd, nd]
    (assemble_element_tensor semantics, common/precompute.hpp:202-232)."""
    Phi, dPhi = _tables_3d(p, q, rule)
    G, detJw = geometry.precompute_geometric_data(mesh, p, q, rule, clamp=False)
    if kind == "mass":
        A = np.einsum("qa,cq,qb->cab", Phi, detJw, Phi, optimize=True)
    elif kind == "stiffness":
        A = np.einsum("dqa,cqde,eqb->cab", dPhi, G, dPhi, optimize=True)
    else:
        raise ValueError(kind)
    return coeff * A


@dataclass(frozen=True)
class EAOperator:
    """Element-assembly matvec: y = scatter(A_e @ gather(x)).

    The stored-dense-element-matrix operator (operators.hpp:127-201); the
    per-cell gemm runs as ONE batched matmul over all cells.
    """

    dofs: GeneralDofMap
    A_e: np.ndarray  # [nc, nd, nd]
    dtype: type = jnp.float32

    @cached_property
    def _A(self) -> np.ndarray:
        return self.A_e.astype(np.dtype(self.dtype))

    def __call__(self, x: jax.Array) -> jax.Array:
        xe = gs.gather_indexed(x, self.dofs.dofmap)  # [nc, nd]
        ye = jnp.einsum(
            "cab,cb->ca", self._A, xe,
            preferred_element_type=(
                jnp.float32 if self.dtype != jnp.float64 else jnp.float64
            ),
            precision=jax.lax.Precision.HIGHEST,
        ).astype(x.dtype)
        return gs.scatter_indexed(ye, self.dofs.dofmap, self.dofs.ndofs)


def assemble_csr(
    dofs: GeneralDofMap, A_e: np.ndarray
):
    """Globally-assembled SciPy CSR matrix (the PETScOperator baseline,
    operators.hpp:72-124): host-side oracle and scipy-ecosystem bridge."""
    import scipy.sparse as sp

    nc, nd, _ = A_e.shape
    rows = np.repeat(dofs.dofmap, nd, axis=1).ravel()
    cols = np.tile(dofs.dofmap, (1, nd)).ravel()
    M = sp.coo_matrix(
        (A_e.ravel(), (rows, cols)), shape=(dofs.ndofs, dofs.ndofs)
    )
    return M.tocsr()
