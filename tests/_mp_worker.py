"""Worker process for the multi-process distributed test.

Launched by tests/test_multiprocess.py, one instance per process. Each
process owns 2 virtual CPU devices; together they form the 4-device global
mesh for a ShardedLinearWave solve. This is the repo's analogue of the
reference's real multi-node MPI runs (demo/gpu_cg/submit-multinode.sh,
demo/gpu_scatter_mpi/main.cpp:105-160): it exercises cross-process
sharding metadata, host->device transfer of blocked arrays, and Gloo
collectives across the process boundary.

Usage: python _mp_worker.py PORT PROC_ID NUM_PROCS OUTDIR PARTS MODE

PARTS: comma list like "4,1,1" (2-axis splits exercise corner/edge
exchanges across the process boundary); MODE: "stage" (RK4, one
halo-add per stage), "leapfrog" (one halo-add per step), or
"general-{allgather,ppermute}" (the UNSTRUCTURED
ShardedGeneralWave path — RCB cell partition + interface assembly
collective — across the process boundary, the VectorUpdater analogue of
demo/gpu_scatter_mpi/main.cpp:105-160).
"""

import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)
jax.config.update("jax_enable_x64", True)


def general_facet_tags(mesh):
    """Source/ABC x-face quads (tensor vertex order) for the general
    model on the test box; shared with the parent's reference solve."""
    import numpy as np

    hm = mesh.to_hex_mesh()
    L = float(hm.points[:, 0].max())

    def xquads(x0, vids):
        ids = set(np.where(np.abs(hm.points[:, 0] - x0) < 1e-12)[0]
                  .tolist())
        return np.asarray(
            [[c[v] for v in vids] for c in hm.cells
             if all(c[v] in ids for v in vids)]
        )

    return {1: xquads(0.0, (0, 2, 4, 6)), 2: xquads(L, (1, 3, 5, 7))}


def main():
    port, pid, nprocs, outdir = (
        int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    )
    parts = tuple(int(s) for s in (sys.argv[5] if len(sys.argv) > 5
                                   else "4,1,1").split(","))
    mode = sys.argv[6] if len(sys.argv) > 6 else "stage"

    from wave_fenics_tpu.parallel.distributed import (
        initialize, process_summary,
    )

    initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=nprocs,
        process_id=pid,
    )
    assert jax.process_count() == nprocs, "distributed init did not take"
    print(process_summary(), flush=True)

    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import multihost_utils

    from wave_fenics_tpu.core.mesh import FacetTags, box_mesh
    from wave_fenics_tpu.models.linear_wave import LinearWave
    from wave_fenics_tpu.parallel.sharded_wave import ShardedLinearWave

    tags = FacetTags({1: (0,), 2: (1,)})
    mesh = box_mesh((4, 4, 2), (1.0e-2, 1.0e-2, 0.5e-2), facet_tags=tags)
    model = LinearWave(mesh, p=3, c0=1500.0, freq0=0.5e6, dtype=jnp.float64)

    dt = 1.0e-8
    nsteps = 5
    if mode.startswith("general"):
        # the UNSTRUCTURED distributed path across a real process
        # boundary: Gloo-backed all_gather / edge-colored ppermute rounds
        from wave_fenics_tpu.models.general_wave import GeneralLinearWave
        from wave_fenics_tpu.parallel.sharded_general import (
            ShardedGeneralWave,
        )

        gm = GeneralLinearWave(
            mesh=mesh.to_hex_mesh(), p=3,
            facet_tags=general_facet_tags(mesh),
            c0=1500.0, freq0=0.5e6, dtype=jnp.float64,
        )
        sg = ShardedGeneralWave(gm, 4, exchange=mode.split("-")[1])
        assert sg.exchange_mode == mode.split("-")[1]
        u, v, _ = sg.solve_n(0.0, dt, nsteps)
        u_all = multihost_utils.process_allgather(u, tiled=True)
        v_all = multihost_utils.process_allgather(v, tiled=True)
        if pid == 0:
            ug = sg.to_global(np.asarray(u_all))
            vg = sg.to_global(np.asarray(v_all))
            np.save(os.path.join(outdir, "u.npy"), ug)
            np.save(os.path.join(outdir, "v.npy"), vg)
            print(json.dumps({"u_l2": float(np.linalg.norm(ug)),
                              "v_l2": float(np.linalg.norm(vg))}),
                  flush=True)
        print(f"proc {pid} done", flush=True)
        return
    sw = ShardedLinearWave(model, parts=parts)
    integrator = "leapfrog" if mode == "leapfrog" else "rk4"
    u, v, _ = sw.solve_n(0.0, dt, nsteps, integrator=integrator)

    # gather the blocked global arrays to every process, reduce to the
    # plain dof grid, and let process 0 write it for the parent to check
    u_all = multihost_utils.process_allgather(u, tiled=True)
    v_all = multihost_utils.process_allgather(v, tiled=True)
    if pid == 0:
        ug = sw.to_global(np.asarray(u_all))
        vg = sw.to_global(np.asarray(v_all))
        np.save(os.path.join(outdir, "u.npy"), ug)
        np.save(os.path.join(outdir, "v.npy"), vg)
        print(json.dumps({"u_l2": float(np.linalg.norm(ug)),
                          "v_l2": float(np.linalg.norm(vg))}), flush=True)
    print(f"proc {pid} done", flush=True)


if __name__ == "__main__":
    main()
