"""Shared benchmark harness: CLI flags + result table.

Replaces the reference's per-demo boost::program_options parsing and result
table printer (``read_inputs`` / ``output_table``, demo/gpu_cg/utils.hpp:12-87)
with one argparse/JSON helper. Flag names are kept compatible where the
reference had them (--size/--degree/--s/--p/--check). Every entry point
turns on the persistent compile cache (utils.device.enable_compile_cache).
"""

from __future__ import annotations

import argparse
import json


def make_parser(**defaults) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=defaults.get("size", 32),
                    help="cells per axis of the unit box")
    ap.add_argument("--degree", "--p", type=int, dest="degree",
                    default=defaults.get("degree", 4))
    ap.add_argument("--s", type=int, default=defaults.get("s", None),
                    help="total cells = 2^s (overrides --size; gpu_cg style)")
    ap.add_argument("--reps", type=int, default=defaults.get("reps", 100))
    ap.add_argument("--check", action="store_true",
                    help="verify against the f64 oracle path")
    ap.add_argument("--dtype", choices=["f32", "bf16", "f64"], default="f32")
    return ap


def resolve_dtype(name: str):
    import jax
    import jax.numpy as jnp

    if name == "f64" and not jax.config.read("jax_enable_x64"):
        # without x64, jnp silently downcasts f64 values to f32: f64
        # requested means x64 semantics.
        jax.config.update("jax_enable_x64", True)
    return {"f32": jnp.float32, "bf16": jnp.bfloat16, "f64": jnp.float64}[name]


def cells_from_args(args) -> tuple[int, int, int]:
    """E = 2^s cells decomposed near-cubically (mesh.hpp:37-48 analogue),
    or size^3."""
    if args.s is not None:
        from ..parallel.partition import decompose3d

        return decompose3d(2**args.s)
    return (args.size, args.size, args.size)


def two_point_time(body, x0, reps: int, *, timeit_reps: int = 3,
                   warmup: int = 1) -> float:
    """Seconds per application of ``body`` (a carry -> carry map) with
    the fixed per-call cost removed: builds ONE dynamic-trip-count
    executable ``fori_loop(0, n, body, x0)``, times it at ``reps`` and
    ``reps//4`` trips, and divides the difference by the trip-count
    difference — dispatch and synchronisation cancel, and both windows
    share one compilation.

    ``body`` takes (i, carry) like a fori_loop body and must CHAIN the
    carry (a loop-invariant body would be hoisted by XLA)."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from ..utils.closure import hoisted_jit
    from ..utils.timing import timeit

    run = hoisted_jit(
        lambda x, n: lax.fori_loop(0, n, body, x),
        x0, jnp.asarray(reps, jnp.int32),
    )
    jax.block_until_ready(run(x0, jnp.asarray(reps, jnp.int32)))
    if reps >= 8:
        r_lo = reps // 4
        t_hi = timeit(run, x0, jnp.asarray(reps, jnp.int32),
                      reps=timeit_reps, warmup=warmup)
        t_lo = timeit(run, x0, jnp.asarray(r_lo, jnp.int32),
                      reps=timeit_reps, warmup=warmup)
        return max(t_hi - t_lo, 1e-9) / (reps - r_lo)
    return timeit(run, x0, jnp.asarray(reps, jnp.int32),
                  reps=timeit_reps, warmup=warmup) / reps


#: Published peaks per ``device_kind`` (NVIDIA H100 SXM data sheet,
#: dense rates without sparsity, at the full 700 W power limit). A device
#: that is not listed is an error (device_peaks raises), never a default.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "fp32_flops_per_s": 67e12,
        "source": "NVIDIA H100 SXM data sheet",
    },
}


def device_peaks(kind: str) -> dict:
    """Published peaks of the device ``kind`` (``device_kind`` as JAX
    reports it); an unknown kind is an error, not a default."""
    try:
        return DEVICE_PEAKS[kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {kind!r}; add it to "
            "DEVICE_PEAKS with its source"
        ) from None


def streaming_fields(nbytes_per_apply: float, t_seconds: float) -> dict:
    """Effective bandwidth of a streaming record. ``nbytes`` is the
    NOMINAL state traffic model of the op (a lower bound on real
    traffic)."""
    return {"effective_gbps": round(nbytes_per_apply / t_seconds / 1e9, 1)}


def device_fields() -> dict:
    """The device a result was measured on, as JAX reports it."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "device_kind": d.device_kind,
            "device_count": len(jax.devices())}


def report(**kv) -> None:
    """One JSON line, reference-table fields included
    (utils.hpp:48-87 analogue), stamped with the device it ran on."""
    print(json.dumps({**kv, **device_fields()}))
