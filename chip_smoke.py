"""Chip smoke test: the planar3d solver's main paths on the GPU, checked.

One process, x64 enabled (the f32 phases pass their dtype explicitly).
Each phase prints its numbers and each error beside its tolerance and
the reason for that tolerance; a check that fails raises, so the script
exits non-zero and prints no result line. The last line is one JSON
object naming the device.

  python chip_smoke.py           one GPU: phases 1-5 at full width
  python chip_smoke.py --multi   four GPUs: the sharded paths only, each
                                 against the single-device solve

Phases (one GPU):
  1. app, RK4, default config (planar3d HIFU, 64x32x32 cells, p=4,
     4,276,737 dofs, the whole solve): f32 against the same solve in f64,
     and the f64 solve against the analytic plane wave;
  2. the same for the leapfrog integrator;
  3. operators at real widths: f32 against f64 references (structured
     stiffness p=2..6 against the per-cell path, BP1 Gauss mass at 64^3);
  4. an imported mesh (a 32x16x16 box written as XDMF) through the app's
     --mesh path, against the structured solve of the same box;
  5. BP1 CG at 64^3 cells, p=4, f64, its residual checked on the host.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np


class SmokeFailure(AssertionError):
    pass


def check(name: str, value: float, tol: float, why: str) -> None:
    """Print ``name`` beside its tolerance; raise if it is not within."""
    ok = bool(np.isfinite(value)) and value <= tol
    print(f"  {name}: {value:.3e} <= {tol:.0e} "
          f"[{'ok' if ok else 'FAIL'}] ({why})", flush=True)
    if not ok:
        raise SmokeFailure(f"{name} = {value!r} exceeds {tol!r}")


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _app_cfg(cells, dtype, integrator="rk4", mesh_path=None,
             tags_path=None):
    from wave_fenics_tpu.utils.config import SimulationConfig

    cfg = SimulationConfig()
    cfg.domain.ncells = tuple(cells)
    cfg.domain.mesh_path = mesh_path
    cfg.domain.meshtags_path = tags_path
    cfg.time.integrator = integrator
    cfg.run.dtype = dtype
    return cfg


def _print_run(label: str, rep: dict, kind: str) -> None:
    print(f"  {label}: {rep['ndofs']} dofs, {rep['nsteps']} steps, "
          f"compile {rep['compile_seconds']:.3f} s, warm-up "
          f"{rep['warmup_seconds']:.3f} s, solve {rep['solve_seconds']:.3f} "
          f"s, {rep['gdof_steps_per_s']:.4f} GDoF*steps/s on {kind}",
          flush=True)
    mem = {k: v for k, v in rep.items() if k.endswith("_bytes")}
    print(f"  {label} solver executable memory_analysis: {mem}", flush=True)


def phase_app(integrator: str, cells=(64, 32, 32), kind: str = "") -> dict:
    """Phases 1/2: the app's default solve in f32 and in f64; f32 against
    f64 and f64 against the analytic plane wave."""
    from wave_fenics_tpu.apps.planar3d_app import solve
    from wave_fenics_tpu.core.dofmap import StructuredDofGrid
    from wave_fenics_tpu.models.planar3d import analytic_plane_wave

    print(f"phase app-{integrator}: cells {tuple(cells)}", flush=True)
    rep32, u32, _ = solve(_app_cfg(cells, "f32", integrator))
    _print_run("f32", rep32, kind)
    cfg64 = _app_cfg(cells, "f64", integrator)
    rep64, u64, _ = solve(cfg64)
    _print_run("f64", rep64, kind)
    check("relL2(u_f32, u_f64)", rel_l2(u32, u64), 2e-4,
          "f32 roundoff carried through the whole solve; 2.7e-5 on the "
          "CPU at 64x1x1 cells")
    case = cfg64.build_case()
    m = case.model
    x = StructuredDofGrid(m.mesh, m.p).axis_coords(0)
    exact = analytic_plane_wave(x, rep64["t_final"], case)
    u64 = np.asarray(u64)
    # the planar problem is x-only: every transverse line must match
    err = rel_l2(u64, np.broadcast_to(exact[:, None, None], u64.shape))
    # the solution is x-only, so 64x1x1 cells on the CPU give the same
    # error: 1.56e-2 (RK4) and 6.98e-2 (leapfrog, 2nd order in time)
    tol = 2e-2 if integrator == "rk4" else 8e-2
    check("relL2(u_f64, analytic plane wave)", err, tol,
          "discretisation error at 8 GLL nodes per wavelength; 1.56e-2 "
          "(RK4) and 6.98e-2 (leapfrog) on the CPU at 64x1x1 cells")
    return {"f32": rep32, "f64": rep64, "analytic_err": err}


def phase_operators(stiff_cells=None, bp1_cells=64, bp1_degree=4) -> dict:
    """Phase 3: f32 operators against f64 references at real widths. The
    1e-5 bound is what f32 arithmetic meets and a TF32 product (10-bit
    mantissa, ~1e-3) cannot, so it also proves HIGHEST precision."""
    import jax
    import jax.numpy as jnp

    from wave_fenics_tpu.core.mesh import box_mesh
    from wave_fenics_tpu.ops.operators import StructuredOperators
    from wave_fenics_tpu.ops.separable import (mass_separable,
                                               separable_mass_tables)

    if stiff_cells is None:  # ~2.2M dofs each, the suite's sweep
        stiff_cells = {2: 64, 3: 42, 4: 32, 5: 26, 6: 21}
    print("phase operators", flush=True)
    rng = np.random.default_rng(0)
    errs = {}
    why = "f32 arithmetic; a TF32 product would give ~1e-3"
    for p, n in stiff_cells.items():
        mesh = box_mesh((n, n, n), (1.0, 1.0, 1.0))
        o32 = StructuredOperators(mesh, p, dtype=jnp.float32)
        o64 = StructuredOperators(mesh, p, dtype=jnp.float64)
        x32 = jnp.asarray(rng.standard_normal(o32.grid_shape), jnp.float32)
        y32 = jax.jit(lambda a: o32.stiffness(a, 1500.0))(x32)
        y64 = jax.jit(lambda a: o64.stiffness_percell(a, 1500.0))(
            x32.astype(jnp.float64))
        errs[f"stiffness p={p}"] = e = rel_l2(y32, y64)
        print(f"  stiffness p={p}: {n}^3 cells, {o32.ndofs} dofs", flush=True)
        check(f"relL2(stiffness f32, per-cell f64) p={p}", e, 1e-5, why)
    mesh = box_mesh((bp1_cells,) * 3, (1.0, 1.0, 1.0))
    o32 = StructuredOperators(mesh, bp1_degree, dtype=jnp.float32)
    x32 = jnp.asarray(rng.standard_normal(o32.grid_shape), jnp.float32)
    y32 = jax.jit(o32.mass_gauss)(x32)
    M64 = separable_mass_tables(bp1_degree, mesh.h, np.float64)
    y64 = jax.jit(lambda a: mass_separable(a, M64, bp1_degree))(
        x32.astype(jnp.float64))
    errs["bp1 mass"] = e = rel_l2(y32, y64)
    print(f"  BP1 mass p={bp1_degree}: {bp1_cells}^3 cells, {o32.ndofs} dofs",
          flush=True)
    check("relL2(BP1 mass f32, f64)", e, 1e-5, why)
    return errs


def box_xface_tags(hm):
    """Tensor-ordered x-face quads of a box HexMesh: tag 1 the x = min
    face (source), tag 2 the x = max face (absorbing)."""
    x = hm.points[:, 0]
    tags = {}
    for tag, x0, verts in ((1, x.min(), (0, 2, 4, 6)),
                           (2, x.max(), (1, 3, 5, 7))):
        quads = hm.cells[:, list(verts)]
        on = np.all(np.abs(x[quads] - x0) < 1e-12 * max(1.0, abs(x0)), axis=1)
        tags[tag] = quads[on]
    return tags


def phase_imported_mesh(cells=(32, 16, 16), kind: str = "") -> dict:
    """Phase 4: a box written as XDMF (inline XML, no HDF5), solved by the
    app's imported-mesh path, against the structured solve of the box."""
    from wave_fenics_tpu.apps.planar3d_app import solve
    from wave_fenics_tpu.core.dofmap import StructuredDofGrid, build_dofmap
    from wave_fenics_tpu.core.io import write_xdmf_mesh, write_xdmf_meshtags

    print(f"phase imported-mesh: cells {tuple(cells)}", flush=True)
    cfg = _app_cfg(cells, "f32")
    mesh = cfg.build_case().model.mesh
    hm = mesh.to_hex_mesh()
    tags = box_xface_tags(hm)
    with tempfile.TemporaryDirectory() as d:
        mpath = os.path.join(d, "box.xdmf")
        tpath = os.path.join(d, "box_tags.xdmf")
        write_xdmf_mesh(mpath, hm)
        write_xdmf_meshtags(
            tpath, np.concatenate([tags[1], tags[2]]),
            np.repeat([1, 2], [len(tags[1]), len(tags[2])]))
        rep_g, u_g, _ = solve(_app_cfg(cells, "f32", mesh_path=mpath,
                                       tags_path=tpath))
    _print_run("imported mesh", rep_g, kind)
    rep_s, u_s, _ = solve(cfg)
    _print_run("structured", rep_s, kind)
    if rep_g["nsteps"] != rep_s["nsteps"]:
        raise SmokeFailure(f"step counts differ: {rep_g['nsteps']} vs "
                           f"{rep_s['nsteps']}")
    # structured grid ids -> general dof ids through the two dofmaps
    # (same cells, same local node order)
    p = cfg.domain.degree
    gmap = build_dofmap(hm, p).dofmap
    perm = np.empty(rep_s["ndofs"], np.int64)
    perm[StructuredDofGrid(mesh, p).dofmap().ravel()] = gmap.ravel()
    err = rel_l2(np.asarray(u_g)[perm], np.asarray(u_s).ravel())
    check("relL2(u imported mesh, u structured)", err, 1e-4,
          "same discretisation by two operator paths in f32; they differ "
          "by summation order only")
    return {"general": rep_g, "structured": rep_s, "err": err}


def bp1_host_apply(x: np.ndarray, M1, p: int) -> np.ndarray:
    """y = (Mx (x) My (x) Mz) x in NumPy f64, cell by cell along each
    axis — an implementation independent of ops.separable."""
    y = x
    for d in range(3):
        n = (y.shape[d] - 1) // p
        out = np.zeros_like(y)
        yd = np.moveaxis(y, d, 0)
        od = np.moveaxis(out, d, 0)
        for c in range(n):
            od[c * p: c * p + p + 1] += np.tensordot(
                M1[d], yd[c * p: c * p + p + 1], axes=1)
        y = out
    return y


def phase_bp1_cg(cells=64, degree=4, kmax=50, rtol=1e-4) -> dict:
    """Phase 5: CG on the BP1 consistent mass in f64 (the reference's
    gpu_cg campaign: kmax 50, rtol 1e-4), its residual recomputed on the
    host in f64 by an independent implementation."""
    import jax
    import jax.numpy as jnp

    from wave_fenics_tpu.core.mesh import box_mesh
    from wave_fenics_tpu.ops.operators import StructuredOperators
    from wave_fenics_tpu.ops.separable import separable_mass_tables
    from wave_fenics_tpu.solvers.cg import cg

    print(f"phase bp1-cg: {cells}^3 cells, p={degree}, f64", flush=True)
    mesh = box_mesh((cells,) * 3, (1.0, 1.0, 1.0))
    ops = StructuredOperators(mesh, degree, dtype=jnp.float64)
    b = np.random.default_rng(1).standard_normal(ops.grid_shape)
    bd = jnp.asarray(b)
    solve = jax.jit(lambda bb: cg(ops.mass_gauss, bb, kmax=kmax, rtol=rtol))
    jax.block_until_ready(solve(bd))  # compile
    t0 = time.perf_counter()
    x, k, rnorm2 = jax.block_until_ready(solve(bd))
    secs = time.perf_counter() - t0
    iters = int(k)
    print(f"  {ops.ndofs} dofs, {iters} iterations, {secs:.4f} s, "
          f"{ops.ndofs * iters / secs / 1e9:.4f} GDoF*iter/s", flush=True)
    M1 = separable_mass_tables(degree, mesh.h, np.float64)
    r = bp1_host_apply(np.asarray(x), M1, degree) - b
    res = float(np.linalg.norm(r) / np.linalg.norm(b))
    res_cg = float(np.sqrt(rnorm2)) / float(np.linalg.norm(b))
    print(f"  ||Mx-b||/||b||: host f64 {res:.6e}, CG recursion {res_cg:.6e}",
          flush=True)
    if iters < kmax and res_cg >= rtol:
        raise SmokeFailure("CG stopped before kmax above rtol")
    check("|host residual / CG residual - 1|", abs(res / res_cg - 1.0), 1e-8,
          "f64: the recursive residual drifts from the true one by "
          "roundoff only")
    check("host ||Mx-b||/||b||", res, max(rtol, 1e-2),
          "stops at rtol or kmax, the reference's rule; 50 unpreconditioned "
          "iterations at p=4 reach 3.1e-3 on the CPU at 16^3 cells")
    return {"iters": iters, "residual": res, "seconds": secs}


def phase_multi(cells=(64, 32, 32), general_cells=(32, 16, 16),
                nsteps=200) -> dict:
    """--multi: ShardedLinearWave (RK4, leapfrog) and ShardedGeneralWave
    (both exchanges) against the single-device solve, and distributed CG
    iteration parity — f64, on four devices."""
    import jax
    import jax.numpy as jnp

    from wave_fenics_tpu.models.general_wave import GeneralLinearWave
    from wave_fenics_tpu.parallel.partition import decompose3d
    from wave_fenics_tpu.parallel.sharded_general import ShardedGeneralWave
    from wave_fenics_tpu.parallel.sharded_wave import ShardedLinearWave
    from wave_fenics_tpu.solvers.cg import cg
    from wave_fenics_tpu.solvers.leapfrog import leapfrog_solve_n
    from wave_fenics_tpu.solvers.rk4 import rk4_solve_n
    from wave_fenics_tpu.utils.closure import hoisted_jit

    ndev = 4

    def on_all(a, what):
        n = len(a.sharding.device_set)
        print(f"  {what}: state on {n} devices", flush=True)
        if n != ndev:
            raise SmokeFailure(f"{what} state is on {n} devices, not {ndev}")

    why = "one f64 solve split over devices: halo sums in another order"
    out = {}
    case = _app_cfg(cells, "f64").build_case()
    m = case.model
    parts = decompose3d(ndev)
    print(f"phase multi: structured {tuple(cells)} on {parts}, "
          f"{nsteps} steps", flush=True)
    sw = ShardedLinearWave(m, parts)
    u0, v0 = m.zero_state()
    for integ in ("rk4", "leapfrog"):
        dt = case.dt if integ == "rk4" else 0.71 * case.dt
        if integ == "rk4":
            fn = lambda u, v: rk4_solve_n(m.f0, m.f1, u, v, 0.0, dt, nsteps)
        else:
            damp = np.asarray(m.damping)
            fn = lambda u, v: leapfrog_solve_n(m.force, damp, u, v, 0.0, dt,
                                               nsteps)
        u1, _ = hoisted_jit(fn, u0, v0)(u0, v0)
        us, _, _ = sw.solve_n(0.0, dt, nsteps, integrator=integ)
        on_all(us, f"ShardedLinearWave {integ}")
        out[integ] = e = rel_l2(sw.to_global(us), u1)
        check(f"relL2(sharded {integ}, single device)", e, 1e-10, why)

    gcase = _app_cfg(general_cells, "f64").build_case()
    hm = gcase.model.mesh.to_hex_mesh()
    gm = GeneralLinearWave(mesh=hm, p=gcase.model.p,
                           facet_tags=box_xface_tags(hm), dtype=jnp.float64)
    print(f"  general {tuple(general_cells)}: {gm.ndofs} dofs", flush=True)
    u1, _ = gm.solve_n(0.0, gcase.dt, nsteps)
    for exch in ("allgather", "ppermute"):
        sg = ShardedGeneralWave(gm, ndev, exchange=exch)
        ug, _, _ = sg.solve_n(0.0, gcase.dt, nsteps)
        on_all(ug, f"ShardedGeneralWave {exch}")
        out[exch] = e = rel_l2(sg.to_global(ug), u1)
        check(f"relL2(sharded general {exch}, single device)", e, 1e-10, why)

    # implicit-step system (diag(m) + tau*K) x = b, Jacobi-preconditioned:
    # the distributed gpu_cg configuration (cg.hpp:37-121 + halo/iter)
    h = float(gcase.model.mesh.h[0])
    tau = (0.25 * h / (gm.c0 * gm.p ** 2)) ** 2
    b = np.random.default_rng(2).standard_normal(gm.ndofs)
    xd, iters, _ = sg.cg_solve(sg.from_global(b), tau, kmax=200, rtol=1e-8)
    mvec = jnp.asarray(gm.m)
    mv = lambda z: mvec * z - tau * gm.ops.stiffness(z, gm.c0)
    x1, k1, _ = hoisted_jit(
        lambda bb: cg(mv, bb, kmax=200, rtol=1e-8,
                      precond=lambda r: r / mvec), jnp.asarray(b)
    )(jnp.asarray(b))
    print(f"  distributed CG: {iters} iterations, single device {int(k1)}",
          flush=True)
    if iters != int(k1):
        raise SmokeFailure(f"CG iterations differ: {iters} vs {int(k1)}")
    out["cg"] = e = rel_l2(sg.to_global(xd), x1)
    check("relL2(distributed CG x, single device)", e, 1e-10, why)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="four GPUs: run only the sharded phases")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)
    devs = jax.devices()
    need = 4 if args.multi else 1
    if devs[0].platform != "gpu" or len(devs) < need:
        print(f"chip_smoke.py: needs {need} GPU(s); JAX found "
              f"{len(devs)} {devs[0].platform!r} device(s)", file=sys.stderr)
        sys.exit(1)
    from wave_fenics_tpu.utils.device import card_info, enable_compile_cache

    enable_compile_cache()
    card = card_info()
    kind = f"{devs[0].device_kind} ({card.splitlines()[0]})"
    print(card, flush=True)
    print(f"jax {jax.__version__}, device_kind {devs[0].device_kind}, "
          f"{len(devs)} device(s)", flush=True)
    t0 = time.perf_counter()
    if args.multi:
        phase_multi()
    else:
        phase_app("rk4", kind=kind)
        phase_app("leapfrog", kind=kind)
        phase_operators()
        phase_imported_mesh(kind=kind)
        phase_bp1_cg()
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
