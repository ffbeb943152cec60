"""Sum-factorized element kernels: batched 1D tensor contractions.

This is the representational shift at the core of the solver
(SURVEY.md §7): the reference tabulates the 1D building block
(``tabulate_1d``, common/precompute.hpp:179-189) but its kernels contract the
full nd x nq table per element (common/cuda/mass_kernel.cu:22-32,
common/operators.hpp:112-133). Here every operator is expressed as three
batched 1D contractions per tensor direction — O(m^4) per cell instead of
O(m^6), and each contraction is one big batched matmul for XLA (the ``gpu_tsmm``/``gpu_operator`` Dgemm pipeline, generalized).

Element tensors: ``u[c, i, j, k]`` with i->x, j->y, k->z (C-order, z fastest).
Tables: ``B[q, i]`` (values), ``D[q, i]`` (derivatives) from core.basis.

All kernels are shape-polymorphic in the batch (cell) axis and jit-safe.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "apply_axis",
    "interp3",
    "interp3_t",
    "grad3",
    "grad3_t",
    "mass_element",
    "spectral_mass_element",
    "stiffness_element_diag",
    "stiffness_element_full",
]


def _pet(dtype):
    # Accumulate small contractions in f32 at least; f64 path keeps f64.
    return jnp.float64 if dtype == jnp.float64 else jnp.float32


def apply_axis(u: jax.Array, M: jax.Array, axis: int) -> jax.Array:
    """Contract table M[q, n] against element axis ``axis`` (1, 2, or 3).

    out[c, ..., q, ...] = sum_n M[q, n] * u[c, ..., n, ...]
    """
    specs = {1: "qi,cijk->cqjk", 2: "qj,cijk->ciqk", 3: "qk,cijk->cijq"}
    return jnp.einsum(
        specs[axis], M, u, preferred_element_type=_pet(u.dtype),
        precision=jax.lax.Precision.HIGHEST
    ).astype(u.dtype)


def interp3(u: jax.Array, B: jax.Array) -> jax.Array:
    """Interpolate nodal tensor to quadrature tensor: B applied on all axes.

    The two back-to-back Dgemms of the reference decomposed pipeline
    (demo/gpu_operator/main.cpp:149-155, demo/gpu_tsmm/main.cpp:49-52),
    sum-factorized into 3 batched contractions.
    """
    u = apply_axis(u, B, 1)
    u = apply_axis(u, B, 2)
    return apply_axis(u, B, 3)


def interp3_t(u: jax.Array, B: jax.Array) -> jax.Array:
    """Transpose (projection) of :func:`interp3`: B^T on all axes."""
    Bt = B.T
    u = apply_axis(u, Bt, 1)
    u = apply_axis(u, Bt, 2)
    return apply_axis(u, Bt, 3)


def grad3(u: jax.Array, B: jax.Array, D: jax.Array) -> jax.Array:
    """Reference-space gradient at quadrature points.

    Returns g[3, c, qx, qy, qz]: derivative along axis d uses D on axis d
    and B on the others.
    """
    gx = apply_axis(apply_axis(apply_axis(u, D, 1), B, 2), B, 3)
    gy = apply_axis(apply_axis(apply_axis(u, B, 1), D, 2), B, 3)
    gz = apply_axis(apply_axis(apply_axis(u, B, 1), B, 2), D, 3)
    return jnp.stack([gx, gy, gz])


def grad3_t(fw: jax.Array, B: jax.Array, D: jax.Array) -> jax.Array:
    """Transpose of :func:`grad3`: y = sum_d (grad_d)^T fw[d]."""
    Bt, Dt = B.T, D.T
    yx = apply_axis(apply_axis(apply_axis(fw[0], Dt, 1), Bt, 2), Bt, 3)
    yy = apply_axis(apply_axis(apply_axis(fw[1], Bt, 1), Dt, 2), Bt, 3)
    yz = apply_axis(apply_axis(apply_axis(fw[2], Bt, 1), Bt, 2), Dt, 3)
    return yx + yy + yz


def spectral_mass_element(u: jax.Array, detJw: jax.Array) -> jax.Array:
    """Collocated (diagonal) mass: y_e = detJw .* x_e.

    The reference SpectralMassOperator's ``transform1`` kernel
    (common/cuda/transform.cu:5-20, common/cuda/spectral_mass.hpp:84-89):
    with GLL collocation the mass matrix is diagonal and the "matvec" is one
    pointwise multiply.
    """
    return u * detJw


def mass_element(u: jax.Array, B: jax.Array, detJw: jax.Array) -> jax.Array:
    """General mass matvec: y_e = B^T diag(detJw) B x_e, sum-factorized.

    Semantics of the reference ``mass_apply`` kernel
    (common/cuda/mass_kernel.cu:4-46) and of the decomposed
    gather->gemm->transform->gemm->scatter pipeline
    (demo/gpu_operator/main.cpp:144-160). ``detJw`` broadcasts over cells
    ([1, q, q, q] for uniform meshes, [nc, q, q, q] otherwise).
    """
    uq = interp3(u, B)
    return interp3_t(uq * detJw, B)


def stiffness_element_diag(
    u: jax.Array, D: jax.Array, Gdiag: jax.Array, coeff: jax.Array | float
) -> jax.Array:
    """Collocated stiffness with diagonal geometric factor (axis-aligned cells).

    y_e = coeff * sum_d D_d^T diag(Gdiag[..., d]) D_d x_e
    with D_d the 1D GLL differentiation matrix on axis d, coeff = -c0^2
    (sign convention of the reference skernel, common/operators.hpp:112-133).
    ``Gdiag`` broadcasts: [1, m, m, m, 3] or [nc, m, m, m, 3].
    """
    yx = apply_axis(Gdiag[..., 0] * apply_axis(u, D, 1), D.T, 1)
    yy = apply_axis(Gdiag[..., 1] * apply_axis(u, D, 2), D.T, 2)
    yz = apply_axis(Gdiag[..., 2] * apply_axis(u, D, 3), D.T, 3)
    return coeff * (yx + yy + yz)


def stiffness_element_full(
    u: jax.Array,
    B: jax.Array,
    D: jax.Array,
    G: jax.Array,
    coeff: jax.Array | float,
) -> jax.Array:
    """General stiffness matvec with full 3x3 geometric factor.

    Exactly the reference ``skernel`` contraction
    (common/operators.hpp:112-133): w_d = grad_d u at qpoints,
    fw = coeff * G w, y = grad^T fw — but sum-factorized and batched.
    ``G`` broadcasts: [1 or nc, q, q, q, 3, 3]. With collocated GLL
    (B = I) this reduces to pure differentiation-matrix contractions.
    """
    w = grad3(u, B, D)  # [3, c, q, q, q]
    fw = coeff * jnp.einsum(
        "cqrsde,dcqrs->ecqrs", G, w, preferred_element_type=_pet(u.dtype),
        precision=jax.lax.Precision.HIGHEST
    ).astype(u.dtype)
    return grad3_t(fw, B, D)
