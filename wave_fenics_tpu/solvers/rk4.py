"""Classic 4th-order Runge-Kutta time integration under ``lax.scan``.

Re-expression of the reference RK4 loop (common/LinearGLL.hpp:198-287):
the C++ while-loop with per-stage copy/axpy kernels becomes one jitted
``lax.scan`` over steps with the 4 stages unrolled — no host round-trips,
no temporaries, XLA fuses the stage updates into the operator applies.

The reference clamps the last step (``dt = min(dt, tf - t)``,
LinearGLL.hpp:242); here the partial final step is taken explicitly after
the scan so every scanned step has static shape/dt.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax

__all__ = [
    "rk4_step",
    "rk4_solve",
    "rk4_solve_n",
    "rk4_solve_dyn",
    "rk4_solve_n_recording",
]

# Butcher tableau of the reference (LinearGLL.hpp:233-236)
_A = (0.0, 0.5, 0.5, 1.0)
_B = (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)
_C = (0.0, 0.5, 0.5, 1.0)


def rk4_step(
    f0: Callable,
    f1: Callable,
    u: jax.Array,
    v: jax.Array,
    t: jax.Array,
    dt: jax.Array,
):
    """One RK4 step of the coupled system du/dt = f0(t,u,v), dv/dt = f1(t,u,v).

    Matches LinearGLL.hpp:249-266 (stage structure, update order); note the
    reference's a_0 = 0 makes the stale ku/kv it carries into stage 0
    irrelevant, so carrying no k state across steps is equivalent.
    """
    u0, v0 = u, v
    ku, kv = u, v  # values unused at stage 0 (a_0 = 0)
    for i in range(4):
        un = u0 + dt * _A[i] * ku
        vn = v0 + dt * _A[i] * kv
        tn = t + _C[i] * dt
        ku = f0(tn, un, vn)
        kv = f1(tn, un, vn)
        u = u + dt * _B[i] * ku
        v = v + dt * _B[i] * kv
    return u, v


def rk4_solve_n(
    f0: Callable,
    f1: Callable,
    u0: jax.Array,
    v0: jax.Array,
    t0,
    dt: float,
    nsteps: int,
):
    """Integrate exactly ``nsteps`` fixed steps from (possibly traced) t0."""

    def body(carry, i):
        u, v, t = carry
        u, v = rk4_step(f0, f1, u, v, t, dt)
        return (u, v, t + dt), None

    tdt = jnp.result_type(float)  # time carried at full precision
    (u, v, t), _ = lax.scan(
        body, (u0, v0, jnp.asarray(t0, dtype=tdt)), jnp.arange(nsteps)
    )
    return u, v


def rk4_solve_dyn(
    f0: Callable,
    f1: Callable,
    u0: jax.Array,
    v0: jax.Array,
    t0,
    dt: float,
    nsteps,
):
    """:func:`rk4_solve_n` with a TRACED step count (``fori_loop``) — one
    executable serves every window length, so warm-up and production
    dispatches share a single (cached) compile."""

    def body(i, carry):
        u, v, t = carry
        u, v = rk4_step(f0, f1, u, v, t, dt)
        return (u, v, t + dt)

    tdt = jnp.result_type(float)
    u, v, _ = lax.fori_loop(
        0, nsteps, body, (u0, v0, jnp.asarray(t0, dtype=tdt))
    )
    return u, v


def rk4_solve(
    f0: Callable,
    f1: Callable,
    u0: jax.Array,
    v0: jax.Array,
    t0: float,
    tf: float,
    dt: float,
):
    """Integrate from t0 to tf with fixed step dt (+ one clamped final step).

    Returns (u, v, nsteps). Fully jittable; the step count is static.
    """
    span = tf - t0
    nfull = int(span / dt)  # full steps of size dt
    rem = span - nfull * dt

    def body(carry, i):
        u, v, t = carry
        u, v = rk4_step(f0, f1, u, v, t, dt)
        return (u, v, t + dt), None

    tdt = jnp.result_type(float)  # time carried at full precision
    (u, v, t), _ = lax.scan(
        body, (u0, v0, jnp.asarray(t0, dtype=tdt)), jnp.arange(nfull)
    )
    nsteps = nfull
    if rem > 1e-12 * max(abs(span), 1.0):
        u, v = rk4_step(f0, f1, u, v, t, jnp.asarray(rem, dtype=u0.dtype))
        nsteps += 1
    return u, v, nsteps


def rk4_solve_n_recording(
    f0: Callable,
    f1: Callable,
    u0: jax.Array,
    v0: jax.Array,
    t0,
    dt: float,
    nsteps: int,
    sample: Callable,
):
    """Like :func:`rk4_solve_n` but also returns per-step observations
    ``sample(t, u, v)`` stacked over steps (probe/"hydrophone" time series —
    an observability feature the reference lacks)."""

    def body(carry, i):
        u, v, t = carry
        u, v = rk4_step(f0, f1, u, v, t, dt)
        t = t + dt
        return (u, v, t), sample(t, u, v)

    tdt = jnp.result_type(float)
    (u, v, t), samples = lax.scan(
        body, (u0, v0, jnp.asarray(t0, dtype=tdt)), jnp.arange(nsteps)
    )
    return u, v, samples
