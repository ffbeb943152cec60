"""Tests for auxiliary subsystems: checkpoint/resume, config, timing."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from wave_fenics_tpu.utils.checkpoint import CheckpointManager, load_state, save_state
from wave_fenics_tpu.utils.config import SimulationConfig
from wave_fenics_tpu.utils.timing import Timer, timeit


def test_save_load_roundtrip(tmp_path):
    u = jnp.asarray(np.random.default_rng(0).standard_normal((4, 5)))
    v = 2.0 * u
    p = str(tmp_path / "snap")
    save_state(p, u, v, t=1.5e-6, meta={"step": 10})
    u2, v2, t, meta = load_state(p)
    np.testing.assert_array_equal(np.asarray(u), np.asarray(u2))
    np.testing.assert_array_equal(np.asarray(v), np.asarray(v2))
    assert t == 1.5e-6 and meta["step"] == 10


def test_checkpoint_manager_resume_and_gc(tmp_path):
    cm = CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    u = jnp.ones((3, 3))
    for step in (100, 200, 300):
        cm.save(step, u * step, u, t=step * 1e-8)
    assert cm.latest_step() == 300
    step, u2, v2, t, meta = cm.restore()
    assert step == 300
    np.testing.assert_allclose(np.asarray(u2), 300.0)
    # gc kept only last 2
    names = sorted(os.listdir(tmp_path / "ckpt"))
    assert len([n for n in names if n.startswith("step_")]) == 2


def test_checkpoint_resume_continues_solve(tmp_path):
    """Solve 2N steps == solve N, checkpoint, restore, solve N more."""
    from wave_fenics_tpu.models.planar3d import planar3d_case

    case = planar3d_case(ncells=(4, 2, 2), domain_length=0.01, dtype=jnp.float64)
    m = case.model
    dt = case.dt
    uA, vA, _ = m.solve(0.0, 20 * dt, dt)

    u1, v1, _ = m.solve(0.0, 10 * dt, dt)
    p = str(tmp_path / "mid")
    save_state(p, u1, v1, t=10 * dt)
    u1r, v1r, t1, _ = load_state(p)
    uB, vB, _ = m.solve(t1, 20 * dt, dt, jnp.asarray(u1r), jnp.asarray(v1r))
    np.testing.assert_allclose(np.asarray(uA), np.asarray(uB), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(np.asarray(vA), np.asarray(vB), rtol=1e-12, atol=1e-14)


def test_config_roundtrip():
    cfg = SimulationConfig()
    s = cfg.to_json()
    cfg2 = SimulationConfig.from_json(s)
    assert cfg2.domain.ncells == (64, 32, 32)
    assert cfg2.physics.speed_of_sound == 1500.0
    case = SimulationConfig.from_json(
        json.dumps({"domain": {"ncells": [4, 2, 2], "domain_length": 0.01}})
    ).build_case()
    assert case.model.mesh.shape == (4, 2, 2)


def test_timer_table():
    tm = Timer()
    with tm("phase_a"):
        pass
    with tm("phase_a"):
        pass
    tab = tm.table()
    assert "phase_a" in tab and " 2 " in tab


def test_timeit_runs():
    f = jax.jit(lambda x: x * 2)
    t = timeit(f, jnp.ones((8, 8)), reps=2, warmup=1)
    assert t > 0


def test_planar3d_app_run_and_resume(tmp_path):
    """End-to-end app driver: run with checkpoints, interrupt, resume."""
    import json

    from wave_fenics_tpu.apps.planar3d_app import run
    from wave_fenics_tpu.utils.config import SimulationConfig

    cfg = SimulationConfig.from_json(json.dumps({
        "domain": {"ncells": [4, 2, 2], "domain_length": 0.01, "degree": 3},
        "run": {"dtype": "f64", "checkpoint_dir": str(tmp_path / "ck"),
                "checkpoint_every_steps": 20},
    }))
    out1 = run(cfg)
    assert out1["nsteps"] > 20
    # simulate a crash: reuse the checkpoint dir; resume should continue
    out2 = run(cfg)
    assert out2["u_norm"] == pytest.approx(out1["u_norm"], rel=1e-10)


@pytest.mark.parametrize("integrator", ["rk4", "leapfrog"])
def test_planar3d_app_chunked_matches_single_chunk(tmp_path, integrator):
    """Odd-length checkpoint chunks through the one dynamic-trip
    executable reproduce the single-chunk solve."""
    from wave_fenics_tpu.apps.planar3d_app import solve

    base_cfg = json.dumps({
        "domain": {"ncells": [4, 2, 2], "domain_length": 0.01, "degree": 3},
        "time": {"n_tail_periods": 1.0, "integrator": integrator},
        "run": {"dtype": "f64"},
    })
    ref, u_ref, _ = solve(SimulationConfig.from_json(base_cfg))
    cfg = SimulationConfig.from_json(base_cfg)
    cfg.run.checkpoint_dir = str(tmp_path / "ck")
    cfg.run.checkpoint_every_steps = 7
    out, u, _ = solve(cfg)
    assert out["nsteps"] == ref["nsteps"] > 7
    assert out["t_final"] == pytest.approx(ref["t_final"], rel=1e-14)
    np.testing.assert_allclose(np.asarray(u), np.asarray(u_ref),
                               rtol=1e-12,
                               atol=1e-12 * float(np.abs(u_ref).max()))


def test_profiling_annotate():
    from wave_fenics_tpu.utils.profiling import annotate, xla_dump_flags

    with annotate("phase"):
        x = jnp.ones((4, 4)) * 2
    assert float(x.sum()) == 32.0
    flags = xla_dump_flags("/tmp/xla_dump_test")
    assert "--xla_dump_to=/tmp/xla_dump_test" in flags


def test_device_info_and_progress(capsys):
    from wave_fenics_tpu.utils.logging import device_info, progress

    info = device_info()
    assert "platform" in info
    progress(50, 100, 1.0e-6)  # rank-0 prints via logger; smoke only


def test_planar3d_app_sharded(tmp_path):
    """App driver over the multi-device production path."""
    import json

    from wave_fenics_tpu.apps.planar3d_app import run
    from wave_fenics_tpu.utils.config import SimulationConfig

    cfg = SimulationConfig.from_json(json.dumps({
        "domain": {"ncells": [4, 2, 2], "domain_length": 0.01, "degree": 3},
        "run": {"dtype": "f64", "ndev": 4},
    }))
    out = run(cfg)
    assert out["nsteps"] > 0 and np.isfinite(out["u_norm"])
