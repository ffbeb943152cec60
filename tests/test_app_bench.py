"""bench.py's measurement and the planar3d app's timers, on tiny CPU
cases (the numbers themselves are GPU records outside pytest).

bench.py times two trip counts of one dynamic-trip executable and takes
the difference; its entry point refuses to run without a GPU. The app
reports compile, warm-up and solve seconds apart.
"""

import importlib.util
import os

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_bench():
    spec = importlib.util.spec_from_file_location(
        "bench_script", os.path.join(_ROOT, "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench


def _measure(argv):
    bench = _load_bench()
    return bench.measure(bench._parser().parse_args(
        ["--cells", "4", "2", "2", "--degree", "2"] + argv))


def _check_two_point(solver):
    out = _measure(["--steps", "8", "--solver", solver])
    assert out["unit"] == "GDoF*steps/s"
    assert out["value"] > 0 and out["ms_per_step"] > 0
    # two-point: hi window 8, lo window 8//4 = 2
    assert out["timing"] == "two-point (8-2 steps)"
    # XLA's own count of one step's traffic: at least the state arrays
    # read and written once (2 for RK4's u, v; 3 for leapfrog's u, v, F)
    nstate = 3 if solver == "lf" else 2
    assert out["xla_bytes_per_step"] >= 2 * nstate * 225 * 4
    assert out["xla_flops_per_step"] > 0


def test_bench_worker_two_point():
    _check_two_point("base")


def test_bench_worker_two_point_leapfrog():
    _check_two_point("lf")


def test_bench_worker_two_point_degenerate():
    # steps < 8 collapses to a single-point window (n_lo = 0), no crash
    out = _measure(["--steps", "2", "--solver", "base"])
    assert out["value"] > 0
    assert out["timing"] == "two-point (2-0 steps)"


def test_bench_refuses_without_gpu(capsys, monkeypatch):
    bench = _load_bench()
    monkeypatch.setattr("sys.argv", ["bench.py"])
    with pytest.raises(SystemExit) as e:
        bench.main()
    assert e.value.code != 0
    captured = capsys.readouterr()
    assert "no GPU" in captured.err
    assert captured.out == ""  # no result line


def test_app_reports_warmup_and_solve_split():
    from wave_fenics_tpu.apps.planar3d_app import run as app_run
    from wave_fenics_tpu.utils.config import SimulationConfig

    cfg = SimulationConfig()
    cfg.domain.ncells = (8, 2, 2)
    out = app_run(cfg)
    # compile and the first execution are reported apart from the solve
    assert out["compile_seconds"] is not None
    assert out["warmup_seconds"] is not None and out["warmup_seconds"] >= 0
    assert out["solve_seconds"] > 0
    assert out["nsteps"] > 0 and out["u_norm"] > 0
    assert out["temp_bytes"] >= 0 and out["argument_bytes"] > 0
