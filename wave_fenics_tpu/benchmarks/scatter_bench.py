"""Gather/scatter + halo-exchange benchmarks (gpu_scatter_local /
gpu_scatter_mpi demos).

- local: structured overlap gather/scatter roundtrip vs indexed
  (dofmap) path, with the iota exact-value check of
  demo/gpu_scatter_local/main.cpp:84-90
- halo: sharded halo-add exchange timing over an N-device mesh
  (the VectorUpdater update_fwd/update_rev comparison,
  demo/gpu_scatter_mpi/main.cpp:105-160).

Run: python -m wave_fenics_tpu.benchmarks.scatter_bench --mode local --size 32
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core.dofmap import StructuredDofGrid
from ..core.mesh import box_mesh
from ..ops import gather_scatter as gs
from ..utils.timing import timeit
from ..utils.device import enable_compile_cache
from .common import (make_parser, report, resolve_dtype,
                     two_point_time)


def _two_point_sharded(run, x, reps):
    """Per-exchange seconds for a jitted sharded ``run(x, n)``
    with a dynamic trip count (same two-point method as
    common.two_point_time, adapted to shard_map programs where the
    fori_loop lives inside the per-device body)."""
    n_hi = jnp.asarray(reps, jnp.int32)
    run(x, n_hi)  # compile once; both points share this executable
    if reps < 8:
        return timeit(run, x, n_hi, reps=3, warmup=1) / reps
    r_lo = reps // 4
    t_hi = timeit(run, x, n_hi, reps=3, warmup=1)
    t_lo = timeit(run, x, jnp.asarray(r_lo, jnp.int32), reps=3, warmup=1)
    return max(t_hi - t_lo, 1e-9) / (reps - r_lo)


def main():
    ap = make_parser(size=32, degree=4, reps=50)
    ap.add_argument("--mode", choices=["local", "halo", "general-halo"],
                    default="local")
    ap.add_argument("--ndev", type=int, default=8)
    ap.add_argument("--exchange", default="auto",
                    choices=["auto", "allgather", "ppermute"],
                    help="general-halo assembly collective")
    args = ap.parse_args()
    enable_compile_cache()
    dtype = resolve_dtype(args.dtype)
    p = args.degree
    mesh = box_mesh((args.size,) * 3, (1.0, 1.0, 1.0))
    dg = StructuredDofGrid(mesh, p)
    reps = args.reps

    if args.mode == "local":
        if args.check:
            x = jnp.arange(dg.ndofs, dtype=jnp.float32).reshape(dg.grid_shape)
            xe = gs.gather_grid(x, p)
            ok = np.array_equal(
                np.asarray(xe).reshape(dg.ncells, -1), dg.dofmap().astype(np.float32)
            )
            assert ok, "gather(iota) != dofmap"
        x = jnp.asarray(
            np.random.default_rng(0).standard_normal(dg.grid_shape), dtype=dtype
        )

        t = two_point_time(
            lambda i, a: gs.scatter_grid(
                gs.gather_grid(a, p), p, mesh.shape
            ),
            x, reps,
        )
        from .common import streaming_fields

        ne = dg.ncells * (p + 1) ** 3  # element-tensor entries
        nbytes = 2 * (dg.ndofs + ne) * np.dtype(dtype).itemsize
        report(
            metric="structured gather+scatter roundtrip",
            ndofs=dg.ndofs, degree=p, dtype=args.dtype,
            ms=round(t * 1e3, 4), timing="two-point",
            gdofs_per_s=round(dg.ndofs / t / 1e9, 4),
            **streaming_fields(nbytes, t),
        )
    elif args.mode == "general-halo":
        # UNSTRUCTURED interface assembly — the VectorUpdater
        # update_rev+fwd analogue for arbitrary RCB cell partitions
        # (demo/gpu_scatter_mpi/VectorUpdater.hpp:106-152): all_gather
        # fan-in or edge-colored neighbor ppermute rounds (--exchange)
        from jax import shard_map

        from ..models.general_wave import GeneralLinearWave
        from ..parallel.sharded_general import ShardedGeneralWave

        gm = GeneralLinearWave(
            mesh=mesh.to_hex_mesh(), p=p, facet_tags={}, dtype=dtype
        )
        sw = ShardedGeneralWave(gm, args.ndev, exchange=args.exchange)
        u, _ = sw.zero_state()
        tb = sw._tables
        names = [n for n in ("bidx", "recv", "sidx", "ridx") if n in tb]
        specs = tuple(tb[n].sharding.spec for n in names)

        from jax.sharding import PartitionSpec as P

        def local(xb, n, *ops):
            tloc = {nm: o.reshape(o.shape[1:])
                    for nm, o in zip(names, ops)}
            sq = xb.reshape(xb.shape[1:])
            out = lax.fori_loop(
                0, n[0], lambda i, a: sw._assemble(a, tloc), sq
            )
            return out.reshape(xb.shape)

        run = jax.jit(shard_map(
            local, mesh=sw.mesh,
            in_specs=(sw.state_spec, P(None)) + specs,
            out_specs=sw.state_spec, check_vma=False,
        ))
        f = lambda x, n: run(x, n.reshape(1), *[tb[nm] for nm in names])
        t = _two_point_sharded(f, u, reps)
        ns = sw._nbr_setup
        extra = (
            dict(rounds=ns["NR"], bucket_slots=ns["Sb"])
            if sw.exchange_mode == "ppermute" and ns is not None
            else dict(interface_slots=int(tb["bidx"].shape[1]))
        )
        report(
            metric=f"unstructured interface assembly ({sw.exchange_mode})",
            ndev=args.ndev, ndofs=gm.ndofs, degree=p, dtype=args.dtype,
            us_per_exchange=round(t * 1e6, 2), timing="two-point",
            **extra,
        )
    else:
        from ..models.linear_wave import LinearWave
        from ..parallel.halo import halo_add, halo_sync
        from ..parallel.partition import decompose3d
        from ..parallel.sharded_wave import ShardedLinearWave, _BLOCK_SPEC
        from jax import shard_map

        model = LinearWave(mesh, p=p, dtype=dtype)
        sw = ShardedLinearWave(model, decompose3d(args.ndev))
        u, _ = sw.zero_state()
        parts = sw.parts

        from jax.sharding import PartitionSpec as P

        def make(fn):
            def local(xb, n):
                sq = xb.reshape(xb.shape[3:])
                return lax.fori_loop(
                    0, n[0], lambda i, a: fn(a, parts), sq
                ).reshape(xb.shape)
            run = jax.jit(shard_map(
                local, mesh=sw.mesh, in_specs=(_BLOCK_SPEC, P(None)),
                out_specs=_BLOCK_SPEC,
            ))
            return lambda x, n: run(x, n.reshape(1))

        # halo_add = reverse (sum partials) + forward (sync copies); the
        # reference times update_rev/update_fwd separately
        # (demo/gpu_scatter_mpi/main.cpp:105-160) — halo_sync is its fwd
        run_add, run_fwd = make(halo_add), make(halo_sync)
        t = _two_point_sharded(run_add, u, reps)
        t_fwd = _two_point_sharded(run_fwd, u, reps)
        face = (
            sw.block_shape[1] * sw.block_shape[2] * np.dtype(dtype).itemsize
        )
        report(
            metric="halo exchange (3-axis ppermute)",
            ndev=args.ndev, parts=list(parts), degree=p, dtype=args.dtype,
            us_per_exchange=round(t * 1e6, 2),
            us_per_fwd_sync=round(t_fwd * 1e6, 2),
            timing="two-point",
            face_bytes=face,
        )


if __name__ == "__main__":
    main()
