"""Batched tensor-contraction benchmark (the ``gpu_tsmm`` demo).

The reference times two back-to-back cublasDgemm on [ndofs x ncells]
matrices — interpolate to quadrature points and project back
(demo/gpu_tsmm/main.cpp:12-68, ncells=100000, ndofs=125, GFLOPs =
4*nc*nd^2/t). Here the same contraction pair is sum-factorized
(interp3/interp3_t) so the device sees three batched [nq x nd] matmuls per
direction instead of one [nd^3 x nq^3] gemm — 2*3*nc*nq*nd flops per pass
instead of 2*nc*nd^3*... The reported flops model keeps BOTH numbers:
``gflops_ref`` uses the reference's dense-gemm model for comparability,
``gflops`` counts the sum-factorized work actually done.

Run: python -m wave_fenics_tpu.benchmarks.tsmm [--ncells N] [--degree P]
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.basis import tabulate_1d
from ..ops.element_kernels import interp3, interp3_t
from ..utils.device import enable_compile_cache
from .common import (make_parser, report, resolve_dtype,
                     two_point_time)


def main():
    ap = make_parser(degree=4, reps=100)
    ap.add_argument("--ncells", type=int, default=100000)
    args = ap.parse_args()
    enable_compile_cache()
    dtype = resolve_dtype(args.dtype)

    p = args.degree
    tab = tabulate_1d(p, q=2 * p + 2, rule="gauss")  # non-collocated: real gemms
    B = tab.B.astype(np.float32 if dtype != jnp.float64 else np.float64)
    nc, nd1, nq1 = args.ncells, tab.nd, tab.nq
    rng = np.random.default_rng(0)
    u = jnp.asarray(
        rng.standard_normal((nc, nd1, nd1, nd1)), dtype=dtype
    )

    reps = args.reps

    # two-point timing (one dynamic-trip executable; the body
    # chains the carry so XLA cannot hoist it)
    t = two_point_time(
        lambda i, a: interp3_t(interp3(a, B), B)[:, :nd1, :nd1, :nd1],
        u, reps,
    )
    nd3, nq3 = nd1**3, nq1**3
    flops_ref = 4.0 * nc * nd3 * nd3  # reference dense model (tsmm main.cpp:58)
    # sum-factorized: interp = nq*nd^3 + nq^2*nd^2 + nq^3*nd MACs; x2 for
    # the projection pass, x2 flops per MAC
    flops_sf = (
        4.0 * nc * (nq1 * nd1**3 + nq1**2 * nd1**2 + nq1**3 * nd1)
    )
    report(
        metric="tsmm interp+project",
        ncells=nc, ndofs=nd3, nq=nq3, degree=p, dtype=args.dtype,
        ms_per_apply=round(t * 1e3, 4),
        timing="two-point",
        gflops_ref=round(flops_ref / t / 1e9, 2),
        gflops=round(flops_sf / t / 1e9, 2),
        gdofs_per_s=round(nc * nd3 / t / 1e9, 3),
    )


if __name__ == "__main__":
    main()
