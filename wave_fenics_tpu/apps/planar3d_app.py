"""The planar3d HIFU application driver.

Equivalent of demo/cpu_planar3d/main.cpp:14-98, with the production
features the reference lacks: chunked jitted stepping with progress lines,
periodic checkpoint/resume, optional multi-device execution, and a final
report (steps/period, dofs, solve time — matching the reference's stdout).

Run:
  python -m wave_fenics_tpu.apps.planar3d_app --cells 64 32 32 [--ndev N]
         [--config cfg.json] [--checkpoint-dir ckpt] [--dtype f32]
         [--integrator rk4|leapfrog]
  python -m wave_fenics_tpu.apps.planar3d_app --mesh m.xdmf \
         [--meshtags tags.xdmf]   # imported-mesh mode (main.cpp:39-45):
         # explicit-dofmap GeneralLinearWave, RCB-sharded when --ndev > 1
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.checkpoint import CheckpointManager
from ..utils.config import SimulationConfig
from ..utils.device import enable_compile_cache
from ..utils.logging import device_info, get_logger, progress
from ..utils.timing import Timer

log = get_logger("planar3d")


def solve(cfg: SimulationConfig):
    """Run the configured solve; returns (report, u, v) with the final
    state in the model's own layout (blocked for sharded runs)."""
    case = cfg.build_case()
    m = case.model
    dt = case.dt
    nstep = case.nsteps
    integrator = cfg.time.integrator
    if integrator not in ("rk4", "leapfrog"):
        raise ValueError(f"unknown integrator: {integrator!r}")
    if integrator == "leapfrog":
        # leapfrog's imaginary-axis stability interval is 2 vs RK4's
        # 2.83; the case's CFL dt targets RK4
        dt *= 0.71
        nstep = int(np.ceil(nstep / 0.71))
        log.info("integrator: leapfrog (1 stiffness apply/step, dt*0.71)")
    tm = Timer()

    log.info("devices:\n%s", device_info())
    log.info("Number of steps per period: %d", case.steps_per_period)
    log.info("dt = %.8e", dt)
    log.info("Number of steps: %d", nstep)
    log.info("Degrees of freedom: %d", m.ops.ndofs)

    from ..models.general_wave import GeneralLinearWave

    is_general = isinstance(m, GeneralLinearWave)
    ndev = cfg.run.ndev
    sharded = ndev > 1
    if sharded and is_general:
        from ..parallel.sharded_general import ShardedGeneralWave

        sw = ShardedGeneralWave(m, ndev)
    elif sharded:
        from ..parallel.partition import decompose3d
        from ..parallel.sharded_wave import ShardedLinearWave

        sw = ShardedLinearWave(m, decompose3d(ndev))
    u, v = sw.zero_state() if sharded else m.zero_state()

    cm = (
        CheckpointManager(cfg.run.checkpoint_dir, cfg.run.checkpoint_every_steps)
        if cfg.run.checkpoint_dir
        else None
    )
    t = case.t0
    step0 = 0
    if cm is not None:
        snap = cm.restore()
        if snap is not None:
            step0, u_np, v_np, t, _ = snap
            u = jnp.asarray(u_np, dtype=m.dtype)
            v = jnp.asarray(v_np, dtype=m.dtype)
            log.info("resumed from step %d (t=%.6e)", step0, t)

    chunk = cfg.run.checkpoint_every_steps if cm else max(nstep, 1)
    chunk = min(chunk, max(nstep - step0, 1))

    compile_s = warmup_s = None
    memory = {}
    if sharded:
        kind = "general, RCB" if is_general else "structured, halo-add"
        solver_path = f"sharded {kind} {integrator} (ndev={ndev})"
        solve_chunk = lambda u, v, t0_, n: sw.solve_n(
            t0_, dt, n, u, v, integrator=integrator)[:2]
    else:
        # one executable for every chunk length: the step count is traced
        # (fori_loop). Grid-sized tables are hoisted to runtime arguments
        # (utils/closure.py). Compile and a warm call happen before the
        # solve timer, so solve_seconds is execution only.
        from ..solvers.leapfrog import leapfrog_solve_dyn
        from ..solvers.rk4 import rk4_solve_dyn
        from ..utils.closure import hoisted_jit

        if integrator == "leapfrog":
            damp = np.asarray(m.damping)
            body = lambda uu, vv, tt, n: leapfrog_solve_dyn(
                m.force, damp, uu, vv, tt, dt, n)
        else:
            body = lambda uu, vv, tt, n: rk4_solve_dyn(
                m.f0, m.f1, uu, vv, tt, dt, n)
        solver_path = f"{'general' if is_general else 'structured'} " \
                      f"XLA {integrator}"
        _targ = lambda x: jnp.asarray(x, dtype=jnp.result_type(float))
        tc0 = time.perf_counter()
        fn = hoisted_jit(body, u, v, _targ(t), np.int32(1))
        compiled = fn.jitted.lower(
            fn.consts, u, v, _targ(t), np.int32(1)).compile()
        compile_s = time.perf_counter() - tc0
        log.info("compile: %.3f s (excluded from solve time)", compile_s)
        memory = memory_report(compiled)
        log.info("solver executable memory: %s", memory)

        def solve_chunk(u, v, t0_, n):
            return compiled(fn.consts, u, v, _targ(t0_), np.int32(n))

        tw0 = time.perf_counter()
        jax.block_until_ready(solve_chunk(u, v, t, 1))
        warmup_s = time.perf_counter() - tw0
        log.info("warmup: %.3f s (first execution, excluded from solve "
                 "time)", warmup_s)
    log.info("solver path: %s", solver_path)

    step = step0
    with tm("solve"):
        while step < nstep:
            n = min(chunk, nstep - step)
            u, v = solve_chunk(u, v, t, n)
            step += n
            t = t + n * dt
            jax.block_until_ready(u)
            progress(step, nstep, t, every=1)
            if cm is not None and step < nstep:
                cm.save(step, np.asarray(u), np.asarray(v), t)

    solve_s = tm._acc["solve"]
    log.info("Solve time: %.3f s", solve_s)
    out_path = cfg.run.output_path
    if out_path:
        if sharded:
            log.info("output: skipped for sharded runs (save a "
                     "checkpoint and post-process instead)")
        elif is_general:
            from ..core.io import write_xdmf_unstructured

            write_xdmf_unstructured(
                out_path, m.dofs,
                {"u": np.asarray(u), "v": np.asarray(v)}, time=t,
            )
            log.info("wrote %s", out_path)
        else:
            from ..core.dofmap import StructuredDofGrid
            from ..core.io import write_xdmf_rectilinear

            dg = StructuredDofGrid(m.mesh, m.p)
            write_xdmf_rectilinear(
                out_path, tuple(dg.axis_coords(d) for d in range(3)),
                {"u": np.asarray(u), "v": np.asarray(v)}, time=t,
            )
            log.info("wrote %s", out_path)
    report = {
        "ndofs": int(m.ops.ndofs),
        "nsteps": nstep,
        "t_final": float(t),
        "steps_per_period": case.steps_per_period,
        "solve_seconds": solve_s,
        "gdof_steps_per_s": m.ops.ndofs * (nstep - step0) / solve_s / 1e9,
        "u_norm": float(jnp.linalg.norm(u.astype(jnp.float32))),
        "solver_path": solver_path,
        "compile_seconds": compile_s,
        "warmup_seconds": warmup_s,
        **memory,
    }
    return report, u, v


def run(cfg: SimulationConfig) -> dict:
    """Run the configured solve and return its report."""
    return solve(cfg)[0]


def memory_report(compiled) -> dict:
    """Device-memory footprint of a compiled executable, in bytes."""
    ma = compiled.memory_analysis()
    if ma is None:
        return {}
    return {
        f"{k}_bytes": int(getattr(ma, f"{k}_size_in_bytes"))
        for k in ("argument", "output", "temp", "generated_code")
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=str, default=None)
    ap.add_argument("--mesh", type=str, default=None,
                    help="XDMF mesh file (imported-mesh mode — the "
                         "reference's cpu_planar3d workflow)")
    ap.add_argument("--meshtags", type=str, default=None,
                    help="XDMF facet meshtags (tag 1 source, 2 absorbing)")
    ap.add_argument("--cells", type=int, nargs=3, default=None)
    ap.add_argument("--degree", type=int, default=None)
    ap.add_argument("--ndev", type=int, default=None)
    ap.add_argument("--dtype", choices=["f32", "bf16", "f64"], default=None)
    ap.add_argument("--checkpoint-dir", type=str, default=None)
    ap.add_argument("--output", type=str, default=None,
                    help="write final u/v as XDMF (ParaView-readable)")
    ap.add_argument("--integrator", choices=["rk4", "leapfrog"],
                    default=None,
                    help="leapfrog: 1 stiffness apply/step (2nd order, "
                         "dt auto-scaled)")
    args = ap.parse_args()
    enable_compile_cache()

    cfg = (
        SimulationConfig.from_json(open(args.config).read())
        if args.config
        else SimulationConfig()
    )
    if args.mesh:
        cfg.domain.mesh_path = args.mesh
    if args.meshtags:
        cfg.domain.meshtags_path = args.meshtags
    if args.cells:
        cfg.domain.ncells = tuple(args.cells)
    if args.degree:
        cfg.domain.degree = args.degree
    if args.ndev:
        cfg.run.ndev = args.ndev
    if args.dtype:
        cfg.run.dtype = args.dtype
    if args.checkpoint_dir:
        cfg.run.checkpoint_dir = args.checkpoint_dir
    if args.output:
        cfg.run.output_path = args.output
    if args.integrator:
        cfg.time.integrator = args.integrator

    out = run(cfg)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
