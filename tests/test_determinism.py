"""Determinism tests.

The reference resolves element->dof write races with atomicAdd, which makes
GPU results run-to-run nondeterministic in general (SURVEY.md §5 "race
detection"). The structured path has no races by construction — overlap-add
is pure dataflow — and the general path's default ELL scatter is a gather,
so we can assert BITWISE reproducibility, which the reference cannot.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from wave_fenics_tpu.core.dofmap import StructuredDofGrid
from wave_fenics_tpu.core.mesh import FacetTags, box_mesh
from wave_fenics_tpu.models.linear_wave import LinearWave
from wave_fenics_tpu.ops import gather_scatter as gs
from wave_fenics_tpu.ops.operators import StructuredOperators


def test_scatter_bitwise_deterministic():
    p = 3
    mesh = box_mesh((3, 3, 3), (1.0, 1.0, 1.0))
    dg = StructuredDofGrid(mesh, p)
    rng = np.random.default_rng(0)
    m = p + 1
    ye = jnp.asarray(rng.standard_normal((dg.ncells, m, m, m)), dtype=jnp.float32)
    f = jax.jit(lambda a: gs.scatter_grid(a, p, mesh.shape))
    out1 = np.asarray(f(ye))
    out2 = np.asarray(f(ye))
    np.testing.assert_array_equal(out1, out2)  # bitwise
    # indexed path deterministic too
    dm = jnp.asarray(dg.dofmap())
    g = jax.jit(lambda a: gs.scatter_indexed(a.reshape(dg.ncells, -1), dm, dg.ndofs))
    np.testing.assert_array_equal(np.asarray(g(ye)), np.asarray(g(ye)))


def test_solve_bitwise_deterministic():
    tags = FacetTags({1: (0,), 2: (1,)})
    mesh = box_mesh((4, 2, 2), (0.01, 0.005, 0.005), facet_tags=tags)
    model = LinearWave(mesh, p=3, dtype=jnp.float32)
    dt = 1e-9
    u1, v1, _ = model.solve(0.0, 20 * dt, dt)
    u2, v2, _ = model.solve(0.0, 20 * dt, dt)
    np.testing.assert_array_equal(np.asarray(u1), np.asarray(u2))
    np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))


def test_stiffness_bitwise_deterministic():
    mesh = box_mesh((3, 3, 2), (1.0, 1.0, 1.0))
    ops = StructuredOperators(mesh, 4, dtype=jnp.float32)
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal(ops.grid_shape), dtype=jnp.float32)
    f = jax.jit(lambda a: ops.stiffness(a, 1500.0))
    np.testing.assert_array_equal(np.asarray(f(x)), np.asarray(f(x)))
