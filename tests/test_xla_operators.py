"""The XLA operator paths against the f64 dense oracles (tests/oracles.py):
structured stiffness, lumped mass and BP1 Gauss mass at p=1..8, the
general (indexed) operators with both scatter formulations, and a
heterogeneous medium."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from wave_fenics_tpu.core.dofmap import StructuredDofGrid, build_dofmap
from wave_fenics_tpu.core.mesh import FacetTags, box_mesh
from wave_fenics_tpu.models.linear_wave import LinearWave
from wave_fenics_tpu.ops.operators import GeneralOperators, StructuredOperators

from oracles import assemble_dense, box_facet_weights, dense_wave

_PHYS = dict(c0=1500.0, freq0=0.5e6, p0=60000.0, alpha=4.0)

# anisotropic boxes, two cells each (one interior interface per box)
BOXES = {
    "x2": ((2, 1, 1), (1.0, 0.7, 1.3)),
    "y2": ((1, 2, 1), (0.6, 1.1, 0.9)),
    "z2": ((1, 1, 2), (1.2, 0.8, 0.5)),
}


@pytest.mark.parametrize("box", sorted(BOXES))
@pytest.mark.parametrize("p", range(1, 9))
def test_structured_operators_vs_dense_oracle(p, box):
    """stiffness (separable), lumped mass and BP1 Gauss mass (separable)
    == the dense assembled matrices, in f64."""
    shape, ext = BOXES[box]
    mesh = box_mesh(shape, ext)
    dg = StructuredDofGrid(mesh, p)
    ops = StructuredOperators(mesh, p, dtype=jnp.float64)
    hm, dm = mesh.to_hex_mesh(), dg.dofmap()
    c0 = 1500.0
    M, K = assemble_dense(hm, dm, p, coeff=-(c0**2))
    Mg, _ = assemble_dense(hm, dm, p, q=2 * p + 3, rule="gauss")
    x = np.random.default_rng(p).standard_normal(dg.ndofs)
    xg = jnp.asarray(x.reshape(dg.grid_shape))
    ys, ym, yg = jax.jit(
        lambda a: (ops.stiffness(a, c0), ops.mass(a), ops.mass_gauss(a))
    )(xg)
    np.testing.assert_allclose(np.asarray(ys).ravel(), K @ x, rtol=1e-9,
                               atol=1e-11 * np.abs(K).max())
    np.testing.assert_allclose(np.asarray(ym).ravel(), M @ x, rtol=1e-11,
                               atol=1e-14)
    np.testing.assert_allclose(np.asarray(yg).ravel(), Mg @ x, rtol=1e-10,
                               atol=1e-13)


def _distorted_mesh(shape=(2, 1, 1), seed=7):
    m = box_mesh(shape, (1.0, 0.9, 1.1)).to_hex_mesh()
    rng = np.random.default_rng(seed)
    pts = m.points + 0.04 * rng.standard_normal(m.points.shape)
    return type(m)(points=pts, cells=m.cells)


@pytest.mark.parametrize("scatter_mode", ["ell", "sorted"])
@pytest.mark.parametrize("op", ["mass-gauss", "stiffness"])
@pytest.mark.parametrize("p", range(1, 7))
def test_general_operators_vs_dense_oracle(p, op, scatter_mode):
    """Indexed gather -> element contraction -> scatter (both scatter
    formulations) == the dense matrices on a distorted mesh."""
    hm = _distorted_mesh()
    dofs = build_dofmap(hm, p)
    x = np.random.default_rng(p).standard_normal(dofs.ndofs)
    if op == "mass-gauss":
        ops = GeneralOperators(hm, dofs, dtype=jnp.float64, rule="gauss",
                               scatter_mode=scatter_mode)
        A, _ = assemble_dense(hm, dofs.dofmap, p, rule="gauss")
        y = jax.jit(ops.mass)(jnp.asarray(x))
    else:
        ops = GeneralOperators(hm, dofs, dtype=jnp.float64,
                               scatter_mode=scatter_mode)
        _, A = assemble_dense(hm, dofs.dofmap, p, coeff=-4.0)
        y = jax.jit(lambda a: ops.stiffness(a, 2.0))(jnp.asarray(x))
    ref = A @ x
    np.testing.assert_allclose(np.asarray(y), ref, rtol=1e-9,
                               atol=1e-11 * np.abs(ref).max())


@pytest.mark.parametrize("p", [2, 3, 4])
def test_heterogeneous_medium_f1_vs_dense(p):
    """LinearWave with a per-cell sound speed: f1 == the dense system
    whose stiffness carries (c0_cell/c0)^2 per cell."""
    from oracles import tables_3d
    from wave_fenics_tpu.core import geometry

    tags = FacetTags({1: (0,), 2: (1,)})
    mesh = box_mesh((3, 2, 1), (3.0e-3, 2.0e-3, 1.0e-3), facet_tags=tags)
    rng = np.random.default_rng(p)
    c_cells = _PHYS["c0"] * (1.0 + 0.4 * rng.random(mesh.ncells))
    model = LinearWave(mesh, p=p, dtype=jnp.float64, c0_cells=c_cells,
                       **_PHYS)
    dg = StructuredDofGrid(mesh, p)
    _, dPhi = tables_3d(p)
    G, _ = geometry.precompute_geometric_data(mesh.to_hex_mesh(), p,
                                              clamp=False)
    K = np.zeros((dg.ndofs, dg.ndofs))
    for c, idx in enumerate(dg.dofmap()):
        Ke = sum(dPhi[d].T @ (G[c][:, d, d, None] * dPhi[d])
                 for d in range(3))
        K[np.ix_(idx, idx)] -= c_cells[c] ** 2 * Ke
    M, _ = assemble_dense(mesh.to_hex_mesh(), dg.dofmap(), p)
    W1 = box_facet_weights(mesh, p, (0,)).ravel()
    W2 = box_facet_weights(mesh, p, (1,)).ravel()
    f1, _, _ = dense_wave(K, np.diag(M), W1, W2, **_PHYS)
    u = rng.standard_normal(dg.ndofs)
    v = 1e8 * rng.standard_normal(dg.ndofs)
    t = 0.7 / _PHYS["freq0"]
    y = jax.jit(lambda a, b: model.f1(t, a, b))(
        jnp.asarray(u.reshape(dg.grid_shape)),
        jnp.asarray(v.reshape(dg.grid_shape)))
    ref = f1(t, u, v)
    np.testing.assert_allclose(np.asarray(y).ravel(), ref, rtol=1e-9,
                               atol=1e-11 * np.abs(ref).max())
