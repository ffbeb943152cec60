"""The wave model's time steps against dense NumPy steps built from the
f64 oracles (tests/oracles.py): one RK4 step at p=1..6 and one leapfrog
step at p=1..4 under five boundary configurations, and dynamic against
static trip counts."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from wave_fenics_tpu.core.dofmap import StructuredDofGrid
from wave_fenics_tpu.core.mesh import FacetTags, box_mesh
from wave_fenics_tpu.models.linear_wave import LinearWave
from wave_fenics_tpu.solvers.leapfrog import (leapfrog_solve_dyn,
                                              leapfrog_solve_n, leapfrog_step)
from wave_fenics_tpu.solvers.rk4 import rk4_solve_dyn, rk4_solve_n, rk4_step

from oracles import (assemble_dense, box_facet_weights, dense_wave,
                     leapfrog_step_dense, rk4_step_dense)

# boundary configurations: (source faces, absorbing faces), BOX_FACETS ids
BCS = {
    "x-faces": ((0,), (1,)),
    "y-faces": ((2,), (3,)),
    "z-faces": ((4,), (5,)),
    "source-only": ((0,), ()),
    "none": ((), ()),
}
_PHYS = dict(c0=1500.0, freq0=0.5e6, p0=60000.0, alpha=4.0)


@functools.lru_cache(maxsize=None)
def _dense_system(p, bc):
    src, abc = BCS[bc]
    tags = FacetTags({1: src, 2: abc})
    mesh = box_mesh((2, 2, 1), (2.0e-3, 1.6e-3, 0.9e-3), facet_tags=tags)
    model = LinearWave(mesh, p=p, dtype=jnp.float64, **_PHYS)
    dg = StructuredDofGrid(mesh, p)
    M, K = assemble_dense(mesh.to_hex_mesh(), dg.dofmap(), p,
                          coeff=-(_PHYS["c0"] ** 2))
    W1 = box_facet_weights(mesh, p, src).ravel()
    W2 = box_facet_weights(mesh, p, abc).ravel()
    dense = dense_wave(K, np.diag(M), W1, W2, **_PHYS)
    h = min(mesh.h)
    dt = 0.2 * h / (_PHYS["c0"] * p * p)
    return model, dense, dt


def _random_state(model, seed):
    rng = np.random.default_rng(seed)
    shape = model.ops.grid_shape
    return rng.standard_normal(shape), 1e8 * rng.standard_normal(shape)


@pytest.mark.parametrize("bc", sorted(BCS))
@pytest.mark.parametrize("p", range(1, 7))
def test_linear_wave_rk4_step_vs_dense(p, bc):
    model, (f1, _, _), dt = _dense_system(p, bc)
    u, v = _random_state(model, p)
    t = 0.3 / _PHYS["freq0"]  # inside the source ramp: g(t) varies
    uj, vj = jax.jit(lambda a, b: rk4_step(model.f0, model.f1, a, b, t, dt))(
        jnp.asarray(u), jnp.asarray(v))
    ur, vr = rk4_step_dense(f1, u.ravel(), v.ravel(), t, dt)
    np.testing.assert_allclose(np.asarray(uj).ravel(), ur, rtol=1e-11,
                               atol=1e-12 * np.abs(ur).max())
    np.testing.assert_allclose(np.asarray(vj).ravel(), vr, rtol=1e-10,
                               atol=1e-11 * np.abs(vr).max())


@pytest.mark.parametrize("bc", sorted(BCS))
@pytest.mark.parametrize("p", range(1, 5))
def test_linear_wave_leapfrog_step_vs_dense(p, bc):
    model, (_, force, damping), dt = _dense_system(p, bc)
    u, v = _random_state(model, 10 + p)
    t = 0.3 / _PHYS["freq0"]
    damp = np.asarray(model.damping)
    np.testing.assert_allclose(damp.ravel(), damping, rtol=1e-12,
                               atol=1e-300)

    def step(a, b):
        out = leapfrog_step(model.force, damp, a, b, model.force(t, a), t,
                            dt)
        return out[0], out[1]

    uj, vj = jax.jit(step)(jnp.asarray(u), jnp.asarray(v))
    ur, vr = leapfrog_step_dense(force, damping, u.ravel(), v.ravel(), t, dt)
    np.testing.assert_allclose(np.asarray(uj).ravel(), ur, rtol=1e-11,
                               atol=1e-12 * np.abs(ur).max())
    np.testing.assert_allclose(np.asarray(vj).ravel(), vr, rtol=1e-10,
                               atol=1e-11 * np.abs(vr).max())


@pytest.mark.parametrize("integrator", ["rk4", "leapfrog"])
@pytest.mark.parametrize("n", [1, 2, 3, 7])
def test_dynamic_trip_equals_static(n, integrator):
    """A traced step count (fori_loop, one executable for every chunk
    length — the app's path) == the static-length scan."""
    model, _, dt = _dense_system(2, "x-faces")
    u, v = (jnp.asarray(a) for a in _random_state(model, 20 + n))
    t0 = 0.1 / _PHYS["freq0"]
    if integrator == "rk4":
        dyn = jax.jit(lambda a, b, k: rk4_solve_dyn(
            model.f0, model.f1, a, b, t0, dt, k))
        sta = jax.jit(lambda a, b: rk4_solve_n(
            model.f0, model.f1, a, b, t0, dt, n))
    else:
        damp = np.asarray(model.damping)
        dyn = jax.jit(lambda a, b, k: leapfrog_solve_dyn(
            model.force, damp, a, b, t0, dt, k))
        sta = jax.jit(lambda a, b: leapfrog_solve_n(
            model.force, damp, a, b, t0, dt, n))
    ud, vd = dyn(u, v, np.int32(n))
    us, vs = sta(u, v)
    np.testing.assert_allclose(np.asarray(ud), np.asarray(us), rtol=1e-13,
                               atol=1e-13 * float(jnp.abs(us).max()))
    np.testing.assert_allclose(np.asarray(vd), np.asarray(vs), rtol=1e-13,
                               atol=1e-13 * float(jnp.abs(vs).max()))
