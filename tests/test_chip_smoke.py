"""chip_smoke.py's phases at tiny sizes on the CPU (each against the same
reference it uses on the card), and its refusal to run without a GPU."""

import importlib.util
import os

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("integrator", ["rk4", "leapfrog"])
def test_phase_app(smoke, integrator):
    # the default config's x-resolution (64 cells over 0.1 m) with one
    # transverse cell: the planar solution is x-only, so the analytic
    # bound holds as it does at full width
    out = smoke.phase_app(integrator, cells=(64, 1, 1))
    assert out["f32"]["nsteps"] == out["f64"]["nsteps"] > 1000
    assert out["analytic_err"] > 0


def test_phase_operators(smoke):
    errs = smoke.phase_operators({2: 4, 3: 3, 4: 2, 5: 2, 6: 2},
                                 bp1_cells=4)
    assert len(errs) == 6 and max(errs.values()) < 1e-6


def test_phase_imported_mesh(smoke):
    out = smoke.phase_imported_mesh(cells=(4, 2, 2))
    assert out["general"]["solver_path"].startswith("general")
    assert out["structured"]["solver_path"].startswith("structured")


def test_phase_bp1_cg(smoke):
    out = smoke.phase_bp1_cg(cells=8)
    assert 0 < out["iters"] <= 50


def test_phase_multi(smoke):
    out = smoke.phase_multi(cells=(8, 4, 2), general_cells=(4, 2, 2),
                            nsteps=10)
    assert set(out) == {"rk4", "leapfrog", "allgather", "ppermute", "cg"}


def test_refuses_without_gpu(smoke, capsys):
    with pytest.raises(SystemExit) as e:
        smoke.main([])
    assert e.value.code != 0
    captured = capsys.readouterr()
    assert "needs 1 GPU" in captured.err
    assert captured.out == ""  # no result line
