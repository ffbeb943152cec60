"""Multi-process / multi-host initialization helpers.

The reference binds one MPI rank per GPU via node-local communicator splits
(demo/gpu_cg/main.cpp:31-50, common/cuda/utils.hpp:22-38). Here: one
Python process per host (driving all of its GPUs), ``jax.distributed.
initialize`` with the coordinator address, process count and process id
given explicitly, and GSPMD/NCCL handling the collectives — there is no
per-GPU binding code.
"""

from __future__ import annotations

import jax

__all__ = ["initialize", "global_device_mesh", "process_summary"]


def initialize(**kwargs) -> None:
    """Initialize multi-process JAX (no-op on single process).

    kwargs (``coordinator_address``, ``num_processes``, ``process_id``)
    pass through to jax.distributed.initialize; nothing on a plain GPU
    host describes a cluster, so multi-process runs must give them.
    """
    try:
        jax.distributed.initialize(**kwargs)
    except (RuntimeError, ValueError):
        # already initialized, or single-process run
        pass


def global_device_mesh(parts: tuple[int, int, int] | None = None):
    """A 3D mesh over ALL devices (all processes).

    With parts=None, factors the global device count near-cubically
    (the decompose3d policy, demo/gpu_cg/mesh.hpp:37-48).
    """
    from .partition import decompose3d, make_device_mesh

    n = len(jax.devices())
    if parts is None:
        parts = decompose3d(n)
    return make_device_mesh(parts)


def process_summary() -> str:
    """Rank/size/devices line (the reference's startup prints)."""
    return (
        f"process {jax.process_index()}/{jax.process_count()}, "
        f"local devices: {len(jax.local_devices())}, "
        f"global devices: {len(jax.devices())}"
    )
