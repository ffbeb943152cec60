"""Run the full benchmark suite and write one JSON document.

Covers the reference's complete metric surface (SURVEY.md §6) in one go:
tsmm GFLOPs, operator matvec DOF/s for p in a sweep, CG Dofs*iter/s, local
gather/scatter, unstructured operators and solves, and the headline
planar3d throughput (bench.py). Every record names the device it ran on.

Entries run one after another, each in its own process, so only one
process holds the card at a time; this process never imports jax.
``--in-process`` runs every entry in this process instead.
The suite exits non-zero if any entry failed.

Run: python -m wave_fenics_tpu.benchmarks.suite [--out suite.json]
     [--quick] [--in-process]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _run_inproc(mod: str, args: list[str]) -> dict:
    import contextlib
    import importlib
    import importlib.util
    import io

    if mod == "bench.py":
        spec = importlib.util.spec_from_file_location(
            "bench", os.path.join(_ROOT, "bench.py"))
        m = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(m)
    else:
        m = importlib.import_module(f"wave_fenics_tpu.benchmarks.{mod}")
    old_argv = sys.argv
    sys.argv = [mod] + args
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            m.main()
    finally:
        sys.argv = old_argv
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _run_subprocess(mod: str, args: list[str]) -> dict:
    if mod == "bench.py":
        cmd = [sys.executable, os.path.join(_ROOT, "bench.py"), *args]
    else:
        cmd = [sys.executable, "-m", f"wave_fenics_tpu.benchmarks.{mod}",
               *args]
    out = subprocess.run(
        cmd, capture_output=True, text=True, timeout=1800, check=True,
        cwd=_ROOT,
    ).stdout.strip().splitlines()
    return json.loads(out[-1])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="suite.json")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--degrees", type=int, nargs="*", default=[2, 3, 4, 5, 6])
    ap.add_argument("--in-process", action="store_true",
                    help="run every entry inside this process (one JAX "
                         "client and one compile cache for the suite)")
    args = ap.parse_args()

    results: list = []

    def run(mod: str, *a: str) -> None:
        alist = list(a)
        try:
            if args.in_process:
                res = _run_inproc(mod, alist)
            else:
                res = _run_subprocess(mod, alist)
        except subprocess.CalledProcessError as e:
            res = {"metric": f"{mod} {' '.join(alist)}",
                   "error": (e.stderr or "")[-500:]}
        except Exception as e:  # noqa: BLE001 — recorded, then exit 1
            res = {"metric": f"{mod} {' '.join(alist)}",
                   "error": f"{type(e).__name__}: {e}"[:500]}
        results.append(res)
        # written after every entry so an outer timeout still leaves
        # the finished records behind
        with open(args.out, "w") as f:
            json.dump({"results": results}, f, indent=1)
        print(json.dumps(res), flush=True)

    size = "16" if args.quick else "32"
    reps = "10" if args.quick else "200"

    run("tsmm", "--ncells", "20000" if args.quick else "100000",
        "--reps", reps)
    # ~constant dof count across degrees (s*p ~ 128 -> ~2.2M dofs), like
    # the reference's fixed-cell-count campaign
    stiff_size = {1: 128, 2: 64, 3: 42, 4: 32, 5: 26, 6: 21}
    for p in args.degrees:
        s = size if args.quick else str(stiff_size.get(p, size))
        run("operators_bench", "--op", "stiffness", "--size", s,
            "--degree", str(p), "--reps", reps)
    run("operators_bench", "--op", "spectral", "--size", size,
        "--degree", "4", "--reps", reps, "--check")
    run("operators_bench", "--op", "spectral-roundtrip", "--size", size,
        "--degree", "4", "--reps", reps, "--check")
    # CEED BP1: consistent-mass matvec + CG, p = 1..5 (reference
    # campaign: demo/gpu_cg/submit.sh:4-15, bp1.ufl:20-21)
    cg_size = "16" if args.quick else "64"
    for p in (1, 2, 3, 4, 5):
        run("operators_bench", "--op", "bp1-mass", "--size", cg_size,
            "--degree", str(p), "--reps", reps)
        run("cg_bench", "--size", cg_size, "--degree", str(p))
    run("scatter_bench", "--mode", "local", "--size", size, "--check")
    # explicit-dofmap (unstructured-mesh) operators at p=4: 'mass' is the
    # non-collocated Gauss B^T diag B pipeline
    gsize = "8" if args.quick else "16"
    for op in ("mass", "stiffness-gauss", "stiffness-general",
               "mass-general"):
        run("operators_bench", "--op", op, "--size", gsize, "--degree",
            "4", "--reps", reps, "--check")
    # CG over the explicit-dofmap consistent mass — the operator the
    # reference's gpu_cg benches (demo/gpu_cg/main.cpp:104-109)
    run("cg_bench", "--op", "general", "--size", gsize, "--degree", "4",
        "--precond")
    if not args.quick:
        # unstructured-mesh solve rate — the imported-mesh analogue of
        # the reference's solve-time metric (main.cpp:85-93)
        for integ in ("rk4", "leapfrog"):
            run("general_solve", "--size", "16", "--degree", "4",
                "--steps", "200", "--integrator", integ)
    # headline planar3d solves (RK4 parity metric, leapfrog variant)
    hc = ("--cells", "32", "16", "16") if args.quick else ()
    run("bench.py", *hc, "--solver", "base")
    run("bench.py", *hc, "--solver", "lf")

    errors = sum(1 for r in results if "error" in r)
    print(json.dumps({"suite": args.out, "n": len(results),
                      "errors": errors}))
    if errors:
        sys.exit(1)


if __name__ == "__main__":
    main()
