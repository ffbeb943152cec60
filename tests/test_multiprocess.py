"""Multi-process distributed execution test (2 CPU processes).

The reference proves its distributed path only on real clusters
(demo/gpu_cg/submit-multinode.sh:15-18, mpirun -n {4,8,16}); everything
multi-device in this repo's other tests runs single-process on virtual
devices. This test closes that gap: two OS processes, each with 2 virtual
CPU devices, jax.distributed-initialized over localhost, run the full
ShardedLinearWave solve on a 4-device global mesh; the result must match
the single-process reference solve bitwise-tightly.

This exercises what single-process virtual meshes cannot: cross-process
device_put of blocked operand arrays, Gloo-backed ppermute/psum across the
process boundary, and process_allgather of the solution.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize(
    "parts,mode",
    [("4,1,1", "stage"),   # 1-axis split, per-stage halo-add
     ("2,2,1", "stage"),   # 2-axis split: corner/edge exchange across procs
     ("2,2,1", "leapfrog"),  # one halo-add per step across procs
     # UNSTRUCTURED ShardedGeneralWave (RCB partition) across the process
     # boundary, both interface-assembly collectives — the VectorUpdater
     # redesign's real multi-rank proof (gpu_scatter_mpi/main.cpp:105-160)
     ("4,1,1", "general-allgather"),
     ("4,1,1", "general-ppermute")],
)
def test_two_process_solve_matches_single(tmp_path, parts, mode):
    here = os.path.dirname(os.path.abspath(__file__))
    worker = os.path.join(here, "_mp_worker.py")
    repo_root = os.path.dirname(here)
    port = _free_port()

    env = os.environ.copy()
    # workers force CPU (and their device count) via jax.config
    env.pop("JAX_PLATFORMS", None)
    env["XLA_FLAGS"] = ""  # workers set their own device counts
    env["PYTHONPATH"] = os.pathsep.join(
        [repo_root] + env.get("PYTHONPATH", "").split(os.pathsep)
    ).rstrip(os.pathsep)

    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(port), str(i), "2", str(tmp_path),
             parts, mode],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process worker timed out")
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\n{out}\n{err}"
        assert "done" in out

    # single-process reference: same solve, unsharded base model
    import jax.numpy as jnp

    from wave_fenics_tpu.core.mesh import FacetTags, box_mesh
    from wave_fenics_tpu.models.linear_wave import LinearWave

    tags = FacetTags({1: (0,), 2: (1,)})
    mesh = box_mesh((4, 4, 2), (1.0e-2, 1.0e-2, 0.5e-2), facet_tags=tags)
    if mode.startswith("general"):
        from wave_fenics_tpu.models.general_wave import GeneralLinearWave

        # same tag construction as _mp_worker.general_facet_tags (not
        # imported: the worker module reconfigures jax at import time)
        hm = mesh.to_hex_mesh()
        L = float(hm.points[:, 0].max())

        def xquads(x0, vids):
            ids = set(np.where(np.abs(hm.points[:, 0] - x0) < 1e-12)[0]
                      .tolist())
            return np.asarray(
                [[c[v] for v in vids] for c in hm.cells
                 if all(c[v] in ids for v in vids)]
            )

        gm = GeneralLinearWave(
            mesh=hm, p=3,
            facet_tags={1: xquads(0.0, (0, 2, 4, 6)),
                        2: xquads(L, (1, 3, 5, 7))},
            c0=1500.0, freq0=0.5e6, dtype=jnp.float64,
        )
        u_ref, v_ref = gm.solve_n(0.0, 1.0e-8, 5)
    elif mode == "leapfrog":
        from wave_fenics_tpu.solvers.leapfrog import leapfrog_solve_n

        model = LinearWave(mesh, p=3, c0=1500.0, freq0=0.5e6,
                           dtype=jnp.float64)
        u0, v0 = model.zero_state()
        u_ref, v_ref = leapfrog_solve_n(
            model.force, np.asarray(model.damping), u0, v0, 0.0, 1.0e-8, 5)
    else:
        model = LinearWave(mesh, p=3, c0=1500.0, freq0=0.5e6,
                           dtype=jnp.float64)
        u0, v0 = model.zero_state()
        u_ref, v_ref, _ = model.solve(0.0, 5 * 1.0e-8, 1.0e-8, u0, v0)

    u_mp = np.load(tmp_path / "u.npy")
    v_mp = np.load(tmp_path / "v.npy")
    scale = max(np.abs(np.asarray(u_ref)).max(), 1e-300)
    np.testing.assert_allclose(u_mp, np.asarray(u_ref), rtol=0,
                               atol=1e-10 * scale)
    vscale = max(np.abs(np.asarray(v_ref)).max(), 1e-300)
    np.testing.assert_allclose(v_mp, np.asarray(v_ref), rtol=0,
                               atol=1e-10 * vscale)
