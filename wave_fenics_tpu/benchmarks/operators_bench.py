"""Operator matvec benchmarks (gpu_operator / gpu_operator_monolithic /
gpu_spectral_mass demos).

- ``mass``: decomposed B^T D B pipeline at Gauss points on a general-dofmap
  box (demo/gpu_operator/main.cpp:139-172 shape)
- ``spectral``: diagonal mass gather->transform->scatter
  (demo/gpu_spectral_mass/main.cpp:73-80)
- ``stiffness``: separable sum-factorized stiffness (the RK hot kernel),
  with ``--check`` against the f64 per-cell path (the 1e-8-style
  elementwise check of demo/gpu_operator_monolithic/main.cpp:102-118)
- ``bp1-mass``: the CEED BP1 consistent Gauss mass (separable)
- ``stiffness-general``/``mass-general``/``stiffness-gauss``: the
  explicit-dofmap (imported mesh) family

Run: python -m wave_fenics_tpu.benchmarks.operators_bench --op stiffness --size 32
Metric: DOF/s (size_local/t of the reference).
"""

from __future__ import annotations


import jax.numpy as jnp
import numpy as np

from ..core.dofmap import build_dofmap
from ..core.mesh import box_mesh
from ..ops.operators import GeneralOperators, StructuredOperators
from ..utils.device import enable_compile_cache
from .common import (cells_from_args, make_parser, report,
                     resolve_dtype, streaming_fields, two_point_time)

# nominal state-traffic passes per apply (a lower bound: x read + y
# write = 2; the spectral roundtrip also reads the diagonal). Geometry/
# table traffic is excluded, so effective_gbps understates real traffic.
_TRAFFIC_PASSES = {
    "spectral": 3, "spectral-roundtrip": 3,
}


def main():
    ap = make_parser(size=32, degree=4, reps=50)
    ap.add_argument(
        "--op",
        choices=["mass", "spectral", "spectral-roundtrip", "stiffness",
                 "stiffness-general", "stiffness-gauss", "mass-general",
                 "bp1-mass"],
        default="stiffness",
    )
    args = ap.parse_args()
    enable_compile_cache()
    dtype = resolve_dtype(args.dtype)
    cells = cells_from_args(args)
    mesh = box_mesh(cells, (1.0, 1.0, 1.0))
    p = args.degree
    rng = np.random.default_rng(0)

    if args.op in ("mass", "mass-general", "stiffness-general",
                   "stiffness-gauss"):
        # explicit-dofmap (imported/unstructured mesh) family. 'mass'
        # and 'stiffness-gauss' use the non-collocated Gauss rule, the
        # others collocated GLL.
        hexm = mesh.to_hex_mesh()
        dofs = build_dofmap(hexm, p)
        rule = "gauss" if args.op in ("mass", "stiffness-gauss") else "gll"
        gops = GeneralOperators(hexm, dofs, dtype=dtype, rule=rule)
        x = jnp.asarray(rng.standard_normal(gops.ndofs), dtype=dtype)
        f = {
            "mass": gops.mass,
            "mass-general": gops.mass,
            "stiffness-general": lambda a: gops.stiffness(a, 1500.0),
            "stiffness-gauss": lambda a: gops.stiffness(a, 1500.0),
        }[args.op]
        ndofs = gops.ndofs
    else:
        ops = StructuredOperators(mesh, p, dtype=dtype)
        x = jnp.asarray(rng.standard_normal(ops.grid_shape), dtype=dtype)
        ndofs = ops.ndofs
        f = {
            "bp1-mass": ops.mass_gauss,
            "spectral": ops.spectral_mass,
            "spectral-roundtrip": ops.spectral_mass_roundtrip,
            "stiffness": lambda a: ops.stiffness(a, 1500.0),
        }[args.op]

    reps = args.reps

    # two-point timing of ONE dynamic-trip executable; operator tables
    # are hoisted to runtime args inside
    t = two_point_time(lambda i, a: f(a), x, reps)

    out = {"metric": f"{args.op} matvec", "degree": p, "ndofs": ndofs,
           "dtype": args.dtype, "ms_per_apply": round(t * 1e3, 4),
           "gdofs_per_s": round(ndofs / t / 1e9, 4),
           "timing": "two-point"}
    passes = _TRAFFIC_PASSES.get(args.op, 2)
    out.update(streaming_fields(
        passes * ndofs * np.dtype(dtype).itemsize, t))

    if args.check and args.op in (
        "mass", "mass-general", "stiffness-general", "stiffness-gauss"
    ):
        # f64 oracle: a fresh f64 operator set
        ops64 = GeneralOperators(hexm, dofs, dtype=jnp.float64, rule=rule)
        x64 = jnp.asarray(np.asarray(x), dtype=jnp.float64)
        g64 = (
            ops64.spectral_mass_roundtrip if args.op == "mass-general"
            else ops64.mass if args.op == "mass"
            else (lambda a: ops64.stiffness(a, 1500.0))
        )
        y = np.asarray(f(x), dtype=np.float64)
        y64 = np.asarray(g64(x64))
        scale = np.abs(y64).max() or 1.0
        out["max_rel_err_vs_f64_oracle"] = float(
            np.abs(y - y64).max() / scale
        )
    elif args.check and args.op in (
        "spectral", "spectral-roundtrip", "stiffness"
    ):
        ops64 = StructuredOperators(mesh, p, dtype=jnp.float64)
        x64 = jnp.asarray(np.asarray(x), dtype=jnp.float64)
        g64 = {
            "spectral": ops64.spectral_mass,
            "spectral-roundtrip": ops64.spectral_mass_roundtrip,
            "stiffness": lambda a: ops64.stiffness_percell(a, 1500.0),
        }[args.op]
        y = np.asarray(f(x), dtype=np.float64)
        y64 = np.asarray(g64(x64))
        scale = np.abs(y64).max() or 1.0
        out["max_rel_err_vs_f64_oracle"] = float(
            np.abs(y - y64).max() / scale
        )
    elif args.check and args.op == "bp1-mass":
        # oracle: NumPy f64 banded Kronecker application
        from ..ops.separable import separable_mass_tables

        M1 = [np.asarray(a, np.float64)
              for a in separable_mass_tables(p, mesh.h, np.float64)]
        ref = np.asarray(x, dtype=np.float64)
        m = p + 1
        for d in range(3):
            n = mesh.shape[d]
            nxt = np.zeros_like(ref)
            for c in range(n):
                sl = [slice(None)] * 3
                sl[d] = slice(c * p, c * p + m)
                blk = np.take(ref, range(c * p, c * p + m), axis=d)
                nxt[tuple(sl)] += np.moveaxis(
                    np.einsum("im,m...->i...", M1[d],
                              np.moveaxis(blk, d, 0)), 0, d)
            ref = nxt
        y = np.asarray(f(x), dtype=np.float64)
        scale = np.abs(ref).max() or 1.0
        out["max_rel_err_vs_f64_oracle"] = float(np.abs(y - ref).max() / scale)
    report(**out)


if __name__ == "__main__":
    main()
