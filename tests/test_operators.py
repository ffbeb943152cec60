"""Matrix-free operator tests against dense-assembly oracles.

Formalizes SURVEY.md §4.2 (GPU-vs-CPU operator oracle at 1e-8) as
JAX-op-vs-NumPy-dense-matrix comparisons per operator and degree, in f64.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from wave_fenics_tpu.core.dofmap import StructuredDofGrid, build_dofmap
from wave_fenics_tpu.core.mesh import box_mesh
from wave_fenics_tpu.ops.operators import GeneralOperators, StructuredOperators

from oracles import assemble_dense


def _random_distorted_mesh(seed=0, shape=(2, 2, 2)):
    m = box_mesh(shape, (1.0, 1.1, 0.9)).to_hex_mesh()
    rng = np.random.default_rng(seed)
    pts = m.points + 0.04 * rng.standard_normal(m.points.shape)
    return type(m)(points=pts, cells=m.cells)


@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_structured_mass_vs_dense(p):
    mesh = box_mesh((2, 2, 1), (1.0, 0.8, 1.2))
    dg = StructuredDofGrid(mesh, p)
    ops = StructuredOperators(mesh, p, dtype=jnp.float64)
    M, _ = assemble_dense(mesh.to_hex_mesh(), dg.dofmap(), p)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(dg.ndofs)
    y = np.asarray(ops.mass(jnp.asarray(x.reshape(dg.grid_shape)))).ravel()
    y2 = np.asarray(ops.spectral_mass(jnp.asarray(x.reshape(dg.grid_shape)))).ravel()
    np.testing.assert_allclose(y, M @ x, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(y2, M @ x, rtol=1e-10, atol=1e-12)
    # diagonal mass: dense M must itself be diagonal (GLL collocation)
    np.testing.assert_allclose(M, np.diag(np.diag(M)), atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(ops.lumped_mass).ravel(), np.diag(M), rtol=1e-10
    )


@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 6])
def test_structured_stiffness_vs_dense(p):
    mesh = box_mesh((2, 1, 2), (1.0, 0.7, 1.3))
    dg = StructuredDofGrid(mesh, p)
    c0 = 1500.0
    ops = StructuredOperators(mesh, p, dtype=jnp.float64)
    _, K = assemble_dense(mesh.to_hex_mesh(), dg.dofmap(), p, coeff=-(c0**2))
    rng = np.random.default_rng(2)
    x = rng.standard_normal(dg.ndofs)
    y = np.asarray(ops.stiffness(jnp.asarray(x.reshape(dg.grid_shape)), c0)).ravel()
    np.testing.assert_allclose(y, K @ x, rtol=1e-8, atol=1e-6)
    # K annihilates constants and is symmetric
    ones = jnp.ones(dg.grid_shape, dtype=jnp.float64)
    np.testing.assert_allclose(
        np.asarray(ops.stiffness(ones, c0)), 0.0, atol=1e-6
    )
    z = rng.standard_normal(dg.ndofs)
    yx = np.asarray(ops.stiffness(jnp.asarray(x.reshape(dg.grid_shape)), c0)).ravel()
    yz = np.asarray(ops.stiffness(jnp.asarray(z.reshape(dg.grid_shape)), c0)).ravel()
    np.testing.assert_allclose(np.dot(yx, z), np.dot(x, yz), rtol=1e-9)


@pytest.mark.parametrize("p", [2, 3])
def test_general_operators_vs_dense_distorted(p):
    mesh = _random_distorted_mesh(seed=3)
    dofs = build_dofmap(mesh, p)
    ops = GeneralOperators(mesh, dofs, dtype=jnp.float64)
    M, K = assemble_dense(mesh, dofs.dofmap, p, coeff=-1.0)
    rng = np.random.default_rng(4)
    x = rng.standard_normal(dofs.ndofs)
    np.testing.assert_allclose(
        np.asarray(ops.mass(jnp.asarray(x))), M @ x, rtol=1e-10, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(ops.stiffness(jnp.asarray(x), 1.0)), K @ x, rtol=1e-9, atol=1e-10
    )


@pytest.mark.parametrize("p", [2, 4])
def test_general_gauss_rule_mass(p):
    """Non-collocated (Gauss) quadrature: the decomposed B^T D B pipeline of
    demo/gpu_operator — mass is no longer diagonal but must match dense."""
    mesh = _random_distorted_mesh(seed=5, shape=(2, 1, 1))
    dofs = build_dofmap(mesh, p)
    ops = GeneralOperators(mesh, dofs, dtype=jnp.float64, rule="gauss")
    M, _ = assemble_dense(mesh, dofs.dofmap, p, rule="gauss")
    rng = np.random.default_rng(6)
    x = rng.standard_normal(dofs.ndofs)
    np.testing.assert_allclose(
        np.asarray(ops.mass(jnp.asarray(x))), M @ x, rtol=1e-10, atol=1e-12
    )
    assert not np.allclose(M, np.diag(np.diag(M)))  # really non-diagonal


@pytest.mark.parametrize("p", [2, 3])
def test_structured_equals_general_on_box(p):
    """The two code paths must agree on the same box mesh (same dof order)."""
    mesh = box_mesh((2, 2, 2), (1.0, 1.0, 1.0))
    dg = StructuredDofGrid(mesh, p)
    s_ops = StructuredOperators(mesh, p, dtype=jnp.float64)
    g_dofs = build_dofmap(mesh.to_hex_mesh(), p)
    g_ops = GeneralOperators(mesh.to_hex_mesh(), g_dofs, dtype=jnp.float64)
    # map structured ids -> general ids via the dofmaps
    mapping = np.full(dg.ndofs, -1, dtype=np.int64)
    mapping[dg.dofmap().ravel()] = g_dofs.dofmap.ravel()
    rng = np.random.default_rng(7)
    x = rng.standard_normal(dg.ndofs)
    xg = np.zeros(g_dofs.ndofs)
    xg[mapping] = x
    ys = np.asarray(s_ops.stiffness(jnp.asarray(x.reshape(dg.grid_shape)), 2.0)).ravel()
    yg = np.asarray(g_ops.stiffness(jnp.asarray(xg), 2.0))
    np.testing.assert_allclose(ys, yg[mapping], rtol=1e-9, atol=1e-10)


def test_stiffness_vmaps_over_batch():
    """Operators are pure grid->grid maps: vmap gives batched/ensemble
    solves for free (a serving-style capability the reference lacks)."""
    mesh = box_mesh((2, 2, 2), (1.0, 1.0, 1.0))
    ops = StructuredOperators(mesh, 3, dtype=jnp.float64)
    rng = np.random.default_rng(11)
    xs = jnp.asarray(rng.standard_normal((4,) + ops.grid_shape))
    import jax

    ys = jax.vmap(lambda x: ops.stiffness(x, 1500.0))(xs)
    for i in range(4):
        np.testing.assert_allclose(
            np.asarray(ys[i]), np.asarray(ops.stiffness(xs[i], 1500.0)),
            rtol=1e-12,
        )


def test_stiffness_grad_is_symmetric_quadratic():
    """jax.grad of the quadratic form x -> 1/2 <x, K x> recovers K x
    (operators are differentiable — adjoint/optimization workflows)."""
    import jax

    mesh = box_mesh((2, 2, 1), (1.0, 1.0, 1.0))
    ops = StructuredOperators(mesh, 2, dtype=jnp.float64)
    rng = np.random.default_rng(12)
    x = jnp.asarray(rng.standard_normal(ops.grid_shape))
    energy = lambda u: 0.5 * jnp.vdot(u, ops.stiffness(u, 2.0))
    g = jax.grad(energy)(x)
    np.testing.assert_allclose(
        np.asarray(g), np.asarray(ops.stiffness(x, 2.0)), rtol=1e-11
    )


def test_structured_heterogeneous_c0():
    """Per-cell coefficient on the structured path == dense oracle."""
    mesh = box_mesh((3, 2, 2), (1.0, 0.8, 0.9))
    p = 3
    dg = StructuredDofGrid(mesh, p)
    rng = np.random.default_rng(13)
    cc = 1.0 + 0.3 * rng.random(mesh.ncells)
    ops = StructuredOperators(mesh, p, dtype=jnp.float64, coeff_cells=cc)
    # dense oracle with per-cell coefficient
    from wave_fenics_tpu.core import geometry
    from oracles import tables_3d

    Phi, dPhi = tables_3d(p)
    G, _ = geometry.precompute_geometric_data(mesh.to_hex_mesh(), p,
                                              clamp=False)
    dm = dg.dofmap()
    K = np.zeros((dg.ndofs, dg.ndofs))
    c0 = 2.0
    for c in range(mesh.ncells):
        Ke = np.einsum("dqa,qde,eqb->ab", dPhi, G[c], dPhi, optimize=True)
        K[np.ix_(dm[c], dm[c])] += -(c0**2) * cc[c] * Ke
    x = rng.standard_normal(dg.ndofs)
    y = np.asarray(ops.stiffness(jnp.asarray(x.reshape(dg.grid_shape)), c0))
    np.testing.assert_allclose(y.ravel(), K @ x, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("p", [1, 2, 4])
def test_separable_and_fused_bp1_mass(p):
    """The structured BP1 (Gauss-quadrature consistent mass) separable
    Kronecker application matches the dense Gauss-mass oracle and the
    general explicit-dofmap Gauss mass."""
    from wave_fenics_tpu.ops.separable import (
        mass_separable,
        separable_mass_tables,
    )

    mesh = box_mesh((3, 2, 2), (1.0, 0.8, 0.7))
    dg = StructuredDofGrid(mesh, p)
    g_dofs = build_dofmap(mesh.to_hex_mesh(), p)
    # q = 2p+3 exactness = p+2 Gauss points per direction (the CEED BP1
    # rule; see separable_mass_tables — degree p+2 would under-integrate)
    g_ops = GeneralOperators(
        mesh.to_hex_mesh(), g_dofs, dtype=jnp.float64, rule="gauss",
        q=2 * p + 3,
    )
    mapping = np.full(dg.ndofs, -1, dtype=np.int64)
    mapping[dg.dofmap().ravel()] = g_dofs.dofmap.ravel()
    rng = np.random.default_rng(7)
    x = rng.standard_normal(dg.ndofs)
    xg = np.zeros(g_dofs.ndofs)
    xg[mapping] = x

    M1 = separable_mass_tables(p, mesh.h, jnp.float64)
    xs = jnp.asarray(x.reshape(dg.grid_shape))
    ys = np.asarray(mass_separable(xs, M1, p)).ravel()
    yg = np.asarray(g_ops.mass(jnp.asarray(xg)))
    np.testing.assert_allclose(ys, yg[mapping], rtol=1e-12, atol=1e-14)
    M, _ = assemble_dense(mesh.to_hex_mesh(), dg.dofmap(), p, q=2 * p + 3,
                          rule="gauss")
    np.testing.assert_allclose(ys, M @ x, rtol=1e-11, atol=1e-13)


def test_mass_gauss_dispatch():
    """StructuredOperators.mass_gauss == the separable reference path."""
    from wave_fenics_tpu.ops.separable import (
        mass_separable,
        separable_mass_tables,
    )

    p = 3
    mesh = box_mesh((2, 2, 2), (1.0, 1.0, 1.0))
    ops = StructuredOperators(mesh, p, dtype=jnp.float64)
    rng = np.random.default_rng(9)
    x = jnp.asarray(rng.standard_normal(ops.grid_shape))
    M1 = separable_mass_tables(p, mesh.h, jnp.float64)
    np.testing.assert_allclose(
        np.asarray(ops.mass_gauss(x)),
        np.asarray(mass_separable(x, M1, p)),
        rtol=1e-12,
    )
