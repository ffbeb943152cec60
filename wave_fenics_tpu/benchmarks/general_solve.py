"""Unstructured-mesh RK4 solve-rate benchmark (GDoF*steps/s).

The reference's flagship metric is a wall-clock RK4 solve on an IMPORTED
mesh (demo/cpu_planar3d/main.cpp:85-93 reads the planar3d XDMF file and
times ``Solve time``); bench.py records the structured-box counterpart.
This module records the explicit-dofmap path: a deterministically
perturbed (genuinely unstructured) hex box driven through
``GeneralLinearWave`` — indexed gather/scatter operators, one jitted
``lax.scan`` over all steps (a single dispatch per solve).

Timestep follows the app's CFL rule dt = CFL*h/(c0*p^2)
(demo/cpu_planar3d/main.cpp:61-66) on the unperturbed spacing.

Run: python -m wave_fenics_tpu.benchmarks.general_solve
       [--size N] [--degree P] [--steps S]
"""

from __future__ import annotations

import numpy as np

from ..utils.device import enable_compile_cache
from .common import cells_from_args, make_parser, report, resolve_dtype

_FACES = [(0, 1, 2, 3), (0, 1, 4, 5), (0, 2, 4, 6), (1, 3, 5, 7),
          (2, 3, 6, 7), (4, 5, 6, 7)]


def min_edge(hm) -> float:
    """Global minimum cell edge length — the reference's mesh::h min
    reduction (demo/cpu_planar3d/main.cpp:47-58) for the CFL rule."""
    edges = [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6),
             (5, 7), (0, 4), (1, 5), (2, 6), (3, 7)]
    pts = hm.points
    hmin = np.inf
    for a, b in edges:
        d = np.linalg.norm(pts[hm.cells[:, a]] - pts[hm.cells[:, b]],
                           axis=1)
        hmin = min(hmin, float(d.min()))
    return hmin


def perturbed_box(cells, h=0.002, amp_rel=0.08, seed=0):
    """Perturbed hex box: structured connectivity, unstructured geometry
    (every interior vertex jittered by ``amp_rel * h``); returns
    (HexMesh, facet_tags) with tag 1 = x-low source plane, tag 2 = x-high
    absorbing plane (forms.ufl:21-24 convention)."""
    from ..core.mesh import HexMesh, box_mesh

    ext = np.asarray(cells, np.float64) * h
    rng = np.random.default_rng(seed)
    hm = box_mesh(tuple(cells), tuple(ext)).to_hex_mesh()
    pts = hm.points.copy()
    inner = np.all((pts > 1e-12) & (pts < ext - 1e-12), axis=1)
    pts[inner] += amp_rel * h * rng.standard_normal(pts[inner].shape)
    hm = HexMesh(points=pts, cells=hm.cells)

    def xface_quads(x0):
        ids = set(np.where(np.abs(hm.points[:, 0] - x0) < 1e-12)[0]
                  .tolist())
        return np.asarray(
            [[c[v] for v in f] for c in hm.cells for f in _FACES
             if all(c[v] in ids for v in f)]
        )

    return hm, {1: xface_quads(0.0), 2: xface_quads(ext[0])}


def main():
    ap = make_parser(size=16, degree=4, reps=3)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--cfl", type=float, default=0.5)
    ap.add_argument("--integrator", choices=["rk4", "leapfrog"],
                    default="rk4",
                    help="'leapfrog' = 1 stiffness apply/step (2nd "
                         "order; CFL auto-scaled by 0.71 vs RK4's "
                         "stability interval) — the production option "
                         "for long imported-mesh runs; 'rk4' is the "
                         "reference-parity metric")
    args = ap.parse_args()
    enable_compile_cache()

    import jax
    import jax.numpy as jnp

    from ..models.general_wave import GeneralLinearWave
    from ..solvers.rk4 import rk4_solve_n
    from ..utils.closure import hoisted_jit
    from ..utils.timing import timeit

    dtype = resolve_dtype(args.dtype)
    cells = cells_from_args(args)
    p = args.degree
    hm, tags = perturbed_box(cells, h=0.002)
    md = GeneralLinearWave(mesh=hm, p=p, facet_tags=tags, dtype=dtype)
    # CFL on the ACTUAL min mesh size (main.cpp:47-58,61-66): vertex
    # jitter shrinks the stable dt with the smallest distorted cell
    dt = args.cfl * min_edge(hm) / (md.c0 * p * p)
    if args.integrator == "leapfrog":
        dt *= 0.71  # imaginary-axis stability 2 vs RK4's 2.83

    u0, v0 = md.zero_state()
    nsteps = args.steps
    if args.integrator == "leapfrog":
        from ..solvers.leapfrog import leapfrog_solve_n

        damp = jnp.asarray(md.damping)
        fn = hoisted_jit(
            lambda u, v: leapfrog_solve_n(md.force, damp, u, v, 0.0,
                                          dt, nsteps),
            u0, v0,
        )
    else:
        fn = hoisted_jit(
            lambda u, v: rk4_solve_n(md.f0, md.f1, u, v, 0.0, dt,
                                     nsteps),
            u0, v0,
        )
    jax.block_until_ready(fn(u0, v0))  # compile
    t = timeit(fn, u0, v0, reps=max(args.reps, 2), warmup=1)
    u, v = fn(u0, v0)
    vmax = float(jnp.max(jnp.abs(v)))
    label = "RK4" if args.integrator == "rk4" else "leapfrog"
    out = {
        "metric": f"general {label} solve (unstructured, GDoF*steps/s)",
        "degree": p, "ncells": hm.ncells, "ndofs": md.ndofs,
        "steps": nsteps, "dtype": args.dtype,
        "ms_per_step": round(t / nsteps * 1e3, 4),
        "gdof_steps_per_s": round(md.ndofs * nsteps / t / 1e9, 4),
        "vmax": vmax,
    }
    # physical dp/dt scale is ~p0*w0 (~2e11); divergence blows past 1e15
    # within a few steps (lower --cfl if a config trips this)
    assert 0.0 < vmax < 1e15 and np.isfinite(vmax), \
        f"solve unstable or silent (vmax={vmax:.3e})"
    report(**out)


if __name__ == "__main__":
    main()
