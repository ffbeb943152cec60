"""Headline benchmark: planar3d HIFU throughput on one GPU.

Prints ONE JSON line: GDoF*steps/second of the 3D planar wave solve (the
reference's north-star workload, demo/cpu_planar3d — solve-time metric of
demo/cpu_planar3d/main.cpp:85-93) at p=4 on 64x32x32 cells (4,276,737
dofs), with the time per step, the bytes and flops XLA counts for one
step, that step's share of the card's published memory bandwidth, and the
device and card it ran on.

Runs in one process on the first GPU and exits non-zero when JAX finds
no GPU: a number from any other device is not this benchmark's number.

Usage: python bench.py [--cells NX NY NZ] [--degree P] [--steps N]
                       [--solver base|lf]
"""

import argparse
import json
import sys


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, nargs=3, default=(64, 32, 32))
    ap.add_argument("--degree", type=int, default=4)
    # long windows: the app runs 1,489 RK4 steps per solve at this size
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--solver", choices=["base", "lf"], default="base",
                    help="'base': RK4 (reference parity, the headline); "
                         "'lf': leapfrog at dt*0.71 — one stiffness apply "
                         "per step, 2nd order, a separate metric")
    return ap


def step_cost(fn, *args) -> dict:
    """Bytes accessed and flops of one call of ``fn``, as XLA's cost
    analysis of the compiled program counts them."""
    from wave_fenics_tpu.utils.closure import hoisted_jit

    hf = hoisted_jit(fn, *args)
    ca = hf.jitted.lower(hf.consts, *args).compile().cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    return {"xla_bytes_per_step": float(ca["bytes accessed"]),
            "xla_flops_per_step": float(ca["flops"])}


def measure(args) -> dict:
    """Time ``args.steps`` steps of the solve on the default device
    (two-point: ``steps`` and ``steps//4`` trips of one executable,
    differenced, so dispatch and synchronisation cancel)."""
    import jax.numpy as jnp
    import numpy as np

    from wave_fenics_tpu.benchmarks.common import two_point_time
    from wave_fenics_tpu.models.planar3d import planar3d_case
    from wave_fenics_tpu.solvers.leapfrog import leapfrog_step
    from wave_fenics_tpu.solvers.rk4 import rk4_step

    case = planar3d_case(
        ncells=tuple(args.cells), domain_length=0.1, degree=args.degree,
        dtype=jnp.float32,
    )
    m = case.model
    u0, v0 = m.zero_state()
    t0 = jnp.zeros((), jnp.result_type(float))
    if args.solver == "lf":
        # leapfrog's imaginary-axis stability interval is 2 vs RK4's
        # 2.83; the case's CFL dt targets RK4
        dt = case.dt * 0.71
        damp = np.asarray(m.damping)
        step = lambda u, v, F, t: leapfrog_step(m.force, damp, u, v, F, t,
                                                dt)
        carry = (u0, v0, m.force(t0, u0), t0)
        name = "leapfrog"
    else:
        dt = case.dt

        def step(u, v, t):
            u, v = rk4_step(m.f0, m.f1, u, v, t, dt)
            return u, v, t + dt

        carry = (u0, v0, t0)
        name = "RK4"
    per_step = two_point_time(lambda i, c: step(*c), carry, args.steps)
    ndofs = m.ops.ndofs
    n_lo = args.steps // 4 if args.steps >= 8 else 0
    out = {
        "metric": f"planar3d {name} GDoF*steps/s (p={args.degree}, "
                  f"{ndofs} dofs, f32)",
        "value": ndofs / per_step / 1e9,
        "unit": "GDoF*steps/s",
        "ms_per_step": per_step * 1e3,
        "timing": f"two-point ({args.steps}-{n_lo} steps)",
        **step_cost(step, *carry),
    }
    if args.solver == "lf":
        # simulated-time speedup over an RK4 record =
        # 0.71 * (rk4 ms_per_step / this ms_per_step)
        out["dt_vs_rk4"] = 0.71
    return out


def main():
    args = _parser().parse_args()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: no GPU found (JAX platform {dev.platform!r}); "
              "this benchmark measures the GPU only", file=sys.stderr)
        sys.exit(1)
    from wave_fenics_tpu.benchmarks.common import device_fields, device_peaks
    from wave_fenics_tpu.utils.device import card_info, enable_compile_cache

    enable_compile_cache()
    out = measure(args)
    peak_bw = device_peaks(dev.device_kind)["hbm_bytes_per_s"]
    out["hbm_share_of_peak"] = (
        out["xla_bytes_per_step"] / (out["ms_per_step"] * 1e-3) / peak_bw)
    out.update(device_fields())
    out["card"] = card_info()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
