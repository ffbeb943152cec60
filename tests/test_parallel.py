"""Distributed tests on the virtual 8-device CPU mesh.

The reference only exercises its distributed paths on real clusters
(SURVEY.md §4.5); here the sharded solver is validated against the
single-device solve exactly, per partition shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from wave_fenics_tpu.core.mesh import FacetTags, box_mesh
from wave_fenics_tpu.models.linear_wave import LinearWave
from wave_fenics_tpu.ops.operators import StructuredOperators
from wave_fenics_tpu.parallel.partition import (
    block_grid,
    decompose3d,
    unblock_grid,
)
from wave_fenics_tpu.parallel.sharded_wave import ShardedLinearWave, ownership_weights
from wave_fenics_tpu.solvers.cg import cg


def _model(shape=(4, 4, 2), p=3):
    tags = FacetTags({1: (0,), 2: (1,)})
    mesh = box_mesh(shape, (1.0e-2, 1.0e-2, 0.5e-2), facet_tags=tags)
    return LinearWave(mesh, p=p, c0=1500.0, freq0=0.5e6, dtype=jnp.float64)


def test_decompose3d():
    assert decompose3d(8) == (2, 2, 2)
    assert decompose3d(4) == (2, 2, 1)
    assert decompose3d(2) == (2, 1, 1)
    assert decompose3d(1) == (1, 1, 1)
    assert decompose3d(6) == (3, 2, 1)
    assert np.prod(decompose3d(12)) == 12


def test_block_unblock_roundtrip():
    rng = np.random.default_rng(0)
    g = rng.standard_normal((9, 9, 5))  # p=2, cells (4,4,2)
    b = block_grid(g, (2, 2, 1), 2)
    assert b.shape == (2, 2, 1, 5, 5, 5)
    np.testing.assert_array_equal(unblock_grid(b, 2), g)
    # duplicated interface plane present in both blocks
    np.testing.assert_array_equal(b[0, 0, 0][-1], b[1, 0, 0][0])


def test_ownership_weights_count_once():
    w = ownership_weights((2, 2, 2), (5, 5, 5))
    # weighted count of all copies == number of global dofs (9^3)
    np.testing.assert_allclose(w.sum(), 9 * 9 * 9)


@pytest.mark.parametrize("parts", [(2, 1, 1), (2, 2, 1), (2, 2, 2), (4, 2, 1)])
def test_sharded_stiffness_matches_single(parts):
    model = _model()
    sw = ShardedLinearWave(model, parts)
    rng = np.random.default_rng(1)
    g = rng.standard_normal(model.ops.grid_shape)
    y_single = np.asarray(model.ops.stiffness(jnp.asarray(g), 1500.0))
    y_blocked = sw.stiffness(sw.from_global(g), 1500.0)
    np.testing.assert_allclose(sw.to_global(y_blocked), y_single, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("parts", [(2, 2, 2), (8, 1, 1)])
def test_sharded_solve_matches_single(parts):
    model = _model(shape=(8, 2, 2), p=3)
    dt = 2e-9
    tf = 100 * dt
    u1, v1, _ = model.solve(0.0, tf, dt)
    sw = ShardedLinearWave(model, parts)
    ub, vb, _ = sw.solve(0.0, tf, dt)
    np.testing.assert_allclose(
        sw.to_global(ub), np.asarray(u1), rtol=1e-10, atol=1e-12
    )
    np.testing.assert_allclose(
        sw.to_global(vb), np.asarray(v1), rtol=1e-10, atol=1e-12
    )
    # duplicated planes consistent across devices
    b = np.asarray(ub)
    np.testing.assert_array_equal(
        unblock_grid(b, model.p).shape,
        tuple(n * model.p + 1 for n in model.mesh.shape),
    )


def test_sharded_dot_matches_global():
    model = _model()
    sw = ShardedLinearWave(model, (2, 2, 2))
    rng = np.random.default_rng(2)
    a = rng.standard_normal(model.ops.grid_shape)
    b = rng.standard_normal(model.ops.grid_shape)
    d = float(sw.dot(sw.from_global(a), sw.from_global(b)))
    np.testing.assert_allclose(d, np.vdot(a, b), rtol=1e-12)


def test_distributed_cg_mass_solve():
    """CG at global level with sharded matvec + weighted dot — the gpu_cg
    workload distributed (cg.hpp:37-121 semantics)."""
    model = _model(shape=(4, 4, 4), p=2)
    sw = ShardedLinearWave(model, (2, 2, 2))
    rng = np.random.default_rng(3)
    b_np = rng.standard_normal(model.ops.grid_shape)
    b = sw.from_global(b_np)
    solve = jax.jit(
        lambda bb: cg(sw.spectral_mass, bb, kmax=60, rtol=1e-10, dot=sw.dot)
    )
    x, k, rnorm = solve(b)
    # residual check against the single-device operator
    xg = jnp.asarray(sw.to_global(x))
    res = np.asarray(model.ops.spectral_mass(xg)) - b_np
    assert np.linalg.norm(res) / np.linalg.norm(b_np) < 1e-8


def test_halo_sync_restores_invariant():
    """halo_sync (update_fwd analogue) repairs broken duplicated planes."""
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P
    from wave_fenics_tpu.parallel.halo import halo_sync
    from wave_fenics_tpu.parallel.partition import block_grid, make_device_mesh

    p = 2
    parts = (2, 2, 2)
    rng = np.random.default_rng(4)
    g = rng.standard_normal((9, 9, 9))
    blocked = block_grid(g, parts, p)
    # corrupt the non-owner copies (low planes of non-first blocks)
    corrupted = blocked.copy()
    corrupted[1, :, :, 0, :, :] = -999.0
    corrupted[:, 1, :, :, 0, :] = -999.0
    corrupted[:, :, 1, :, :, 0] = -999.0
    mesh = make_device_mesh(parts)
    spec = P("x", "y", "z", None, None, None)
    arr = jax.device_put(jnp.asarray(corrupted), NamedSharding(mesh, spec))

    def local(xb):
        sq = xb.reshape(xb.shape[3:])
        return halo_sync(sq, parts).reshape(xb.shape)

    out = shard_map(local, mesh=mesh, in_specs=(spec,), out_specs=spec)(arr)
    np.testing.assert_allclose(np.asarray(out), blocked, atol=1e-12)


@pytest.mark.parametrize("parts", [(2, 1, 1), (2, 2, 1), (2, 2, 2),
                                   (8, 1, 1)])
def test_sharded_leapfrog_matches_single(parts):
    """ShardedLinearWave leapfrog (one stiffness apply + halo-add per
    step) == the single-device leapfrog solve, per partition shape."""
    from wave_fenics_tpu.solvers.leapfrog import leapfrog_solve_n

    model = _model(shape=(8, 2, 2), p=3)
    dt = 1.5e-9
    u0, v0 = model.zero_state()
    u1, v1 = jax.jit(lambda u, v: leapfrog_solve_n(
        model.force, np.asarray(model.damping), u, v, 0.0, dt, 60))(u0, v0)
    sw = ShardedLinearWave(model, parts)
    ub, vb, n = sw.solve_n(0.0, dt, 60, integrator="leapfrog")
    assert n == 60
    v1 = np.asarray(v1)
    assert np.abs(v1).max() > 0
    np.testing.assert_allclose(sw.to_global(ub), np.asarray(u1), rtol=1e-10,
                               atol=1e-12 * np.abs(np.asarray(u1)).max())
    np.testing.assert_allclose(sw.to_global(vb), v1, rtol=1e-10,
                               atol=1e-12 * np.abs(v1).max())
