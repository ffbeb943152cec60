"""Smoke tests for the benchmark CLIs (in-process, tiny sizes).

Ensures every reference-metric harness stays runnable; numbers are not
asserted (hardware benchmarks live outside pytest).
"""

import json
import sys

import pytest


def _run_main(module, argv, capsys):
    sys.argv = ["bench"] + argv
    module.main()
    out = capsys.readouterr().out.strip().splitlines()[-1]
    return json.loads(out)


def test_tsmm_cli(capsys):
    from wave_fenics_tpu.benchmarks import tsmm

    r = _run_main(tsmm, ["--ncells", "200", "--reps", "2"], capsys)
    assert r["gflops"] > 0


@pytest.mark.parametrize(
    "op", ["mass", "spectral", "spectral-roundtrip", "stiffness",
           "bp1-mass"]
)
def test_operators_cli(op, capsys):
    from wave_fenics_tpu.benchmarks import operators_bench

    r = _run_main(
        operators_bench,
        ["--op", op, "--size", "4", "--degree", "2", "--reps", "2", "--check"],
        capsys,
    )
    assert r["gdofs_per_s"] > 0
    if "max_rel_err_vs_f64_oracle" in r:
        assert r["max_rel_err_vs_f64_oracle"] < 1e-4


def test_cg_cli(capsys):
    from wave_fenics_tpu.benchmarks import cg_bench

    r = _run_main(cg_bench, ["--size", "4", "--degree", "2"], capsys)
    assert r["iters"] >= 1


def test_cg_general_cli(capsys):
    """CG over the explicit-dofmap Gauss mass (the gpu_cg operator,
    demo/gpu_cg/main.cpp:104-109) converges under Jacobi."""
    from wave_fenics_tpu.benchmarks import cg_bench

    r = _run_main(
        cg_bench,
        ["--op", "general", "--size", "4", "--degree", "2", "--precond"],
        capsys,
    )
    assert r["iters"] >= 1
    assert r["ndofs"] == 9**3


def test_scatter_cli(capsys):
    from wave_fenics_tpu.benchmarks import scatter_bench

    r = _run_main(
        scatter_bench,
        ["--mode", "local", "--size", "4", "--reps", "2", "--check"],
        capsys,
    )
    assert r["gdofs_per_s"] > 0


@pytest.mark.parametrize(
    "op,extra",
    [("stiffness-general", []), ("mass-general", []),
     ("stiffness-general", ["--dtype", "f64"]), ("stiffness-gauss", []),
     ("mass-general", ["--s", "5"])],
)
def test_general_operators_cli(op, extra, capsys):
    from wave_fenics_tpu.benchmarks import operators_bench

    r = _run_main(
        operators_bench,
        ["--op", op, "--size", "3", "--degree", "2", "--reps", "2",
         "--check"] + extra,
        capsys,
    )
    assert r["gdofs_per_s"] > 0
    assert r["max_rel_err_vs_f64_oracle"] < 1e-4
    assert r["device_kind"] and r["device_count"] >= 1


def test_scatter_general_halo_cli(capsys):
    from wave_fenics_tpu.benchmarks import scatter_bench

    r = _run_main(
        scatter_bench,
        ["--mode", "general-halo", "--size", "4", "--degree", "2",
         "--ndev", "4", "--reps", "2", "--exchange", "allgather"],
        capsys,
    )
    assert r["us_per_exchange"] > 0 and r["interface_slots"] > 0
    r = _run_main(
        scatter_bench,
        ["--mode", "general-halo", "--size", "4", "--degree", "2",
         "--ndev", "4", "--reps", "2", "--exchange", "ppermute"],
        capsys,
    )
    assert r["us_per_exchange"] > 0 and r["rounds"] > 0
    assert r["bucket_slots"] > 0


def test_general_solve_cli(capsys):
    from wave_fenics_tpu.benchmarks import general_solve

    r = _run_main(
        general_solve,
        ["--size", "4", "--degree", "2", "--steps", "5", "--reps", "2"],
        capsys,
    )
    assert r["gdof_steps_per_s"] > 0
    assert r["platform"] == "cpu"
    assert 0.0 < r["vmax"] < 1e15
