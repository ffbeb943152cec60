"""Separable grid-space stiffness for uniform structured meshes.

On a uniform axis-aligned box the diagonal geometric factor makes the GLL
stiffness operator *separable*:

    K u = sum_d  (L_{d'} (x) L_{d''})  .*  B_d(A_d) u

where, for axis d with 1D differentiation matrix D and GLL weights w:

    A_d = (h_{d'} h_{d''} / h_d) * D^T diag(w) D      (a constant m x m block)
    B_d(A) = cell-blockwise application of A along axis d with overlap-add
    L_d    = overlap-added lumped GLL weight line of axis d (dimensionless
             here; the h scalings are folded into A_d)

Derivation: the element kernel ye[c,ijk] = sum_{i'} D[i',i] G_x[c,i'jk]
sum_{i''} D[i',i''] ue[c,i''jk] with G_x = vol/h_x^2 * (w (x) w (x) w)
factorizes into (A_x ue) * w_j w_k; scattering over cells turns the w_j/w_k
factors into the overlap-added lines L_y/L_z.

Versus the generic per-cell path (ops.element_kernels.stiffness_element_diag
+ 3D gather/scatter), this does 3 one-axis passes with no 3D cell tensors —
~5x less HBM traffic, which is what the operator is bound by.
Used automatically by StructuredOperators; the per-cell path remains for
distorted/imported meshes and as the oracle.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.basis import gll_points_weights, lumped_weight_line, tabulate_1d
from .gather_scatter import gather_1d, scatter_1d

__all__ = [
    "separable_stiffness_tables",
    "separable_mass_tables",
    "apply_block_axis",
    "stiffness_separable",
    "mass_separable",
]


def separable_stiffness_tables(
    p: int, h: tuple[float, float, float], dtype
) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """(A, L): per-axis m x m cell blocks and lumped weight lines (NumPy)."""
    tab = tabulate_1d(p)
    _, w = gll_points_weights(p + 1)
    DtWD = tab.D.T @ (w[:, None] * tab.D)
    npdt = np.dtype(dtype)
    A = []
    for d in range(3):
        others = [h[e] for e in range(3) if e != d]
        A.append((others[0] * others[1] / h[d] * DtWD).astype(npdt))
    # dimensionless lines (h folded into A); length set per axis by caller
    return A, [w.astype(npdt) for _ in range(3)]


# Contraction specs per gathered axis: contract the node dim (axis+1) with
# A[i, m] in place, leaving the other dims untouched.
_AXIS_EINSUM = {0: "im,nmbc->nibc", 1: "im,anmc->anic", 2: "im,abnm->abni"}


def apply_block_axis(x: jax.Array, A: np.ndarray, p: int, axis: int) -> jax.Array:
    """Cell-blockwise 1D operator along ``axis`` with overlap-add:
    out[c*p + i] += sum_j A[i, j] x[c*p + j] per cell c."""
    xe = gather_1d(x, p, axis)  # [..., n, m, ...] node dim at axis+1
    ye = jnp.einsum(
        _AXIS_EINSUM[axis], A, xe, preferred_element_type=x.dtype,
        precision=jax.lax.Precision.HIGHEST
    )
    return scatter_1d(ye.astype(x.dtype), p, axis)


def stiffness_separable(
    x: jax.Array,
    A: list[np.ndarray],
    lines: list[np.ndarray],
    p: int,
    coeff,
) -> jax.Array:
    """y = coeff * sum_d (L_d' x L_d'') .* B_d(A_d) x on the dof grid."""
    Lx, Ly, Lz = lines
    tx = apply_block_axis(x, A[0], p, 0) * (Ly[None, :, None] * Lz[None, None, :])
    ty = apply_block_axis(x, A[1], p, 1) * (Lx[:, None, None] * Lz[None, None, :])
    tz = apply_block_axis(x, A[2], p, 2) * (Lx[:, None, None] * Ly[None, :, None])
    return coeff * (tx + ty + tz)


def separable_mass_tables(
    p: int, h: tuple[float, float, float], dtype, q: int | None = None,
    rule: str = "gauss",
) -> list[np.ndarray]:
    """Per-axis 1D cell mass blocks ``M1_d = h_d * B^T diag(w_q) B``.

    On a uniform axis-aligned box the consistent (non-lumped) mass matrix is
    an exact Kronecker product of three assembled 1D mass matrices, so the
    global matvec is three sequential banded contractions — the structured
    fast path for the CEED BP1 operator (reference forms
    demo/gpu_cg/bp1.ufl:20-21; kernel semantics
    common/cuda/mass_kernel.cu:4-46).

    Default quadrature: the CEED BP1 spec of p+2 Gauss POINTS per direction
    (exactness degree 2p+3). NOTE: a literal reading of ``dx(degree=p+2)``
    gives ceil((p+3)/2) points — fewer than p+1 nodes for p >= 3, i.e. a
    rank-deficient (singular) mass operator on which CG diverges for
    general right-hand sides; p+2 points is both the CEED definition and
    exact for the degree-2p integrand.
    """
    if q is None:
        q = 2 * p + 3  # p+2 Gauss points per direction (CEED BP1)
    tab = tabulate_1d(p, q, rule)
    M1 = tab.B.T @ (tab.qwts[:, None] * tab.B)
    npdt = np.dtype(dtype)
    return [(h[d] * M1).astype(npdt) for d in range(3)]


def mass_separable(x: jax.Array, M1: list[np.ndarray], p: int) -> jax.Array:
    """y = (Mx (x) My (x) Mz) x: sequential per-axis banded applications."""
    for d in range(3):
        x = apply_block_axis(x, M1[d], p, d)
    return x


def grid_lines(
    shape: tuple[int, int, int], p: int, dtype
) -> list[np.ndarray]:
    """Dimensionless overlap-added GLL weight lines per axis."""
    return [
        lumped_weight_line(n, p, 1.0).astype(np.dtype(dtype)) for n in shape
    ]
