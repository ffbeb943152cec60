"""Hoist closed-over array constants out of jitted programs.

JAX lowers every array a jitted function closes over as a dense HLO
literal — for the general-operator path that means the dofmap, the
geometric factors and the grid-sized mass/boundary vectors (tens to
hundreds of MB at production mesh sizes) are serialized into the
program, which bloats compile time and the executable.

:func:`hoisted_jit` traces the function once, splits the resulting
jaxpr's large array constants out, and jits an equivalent function
that receives them as runtime ARGUMENTS (device buffers passed at
dispatch), keeping the HLO small. (``jax.closure_convert`` cannot do
this: it only hoists AD-perturbed consts.) Use it at every jit
boundary that closes over operator tables (benchmarks, solve
drivers); reference counterpart: the CUDA operators receive their
tables as kernel pointer arguments
(common/cuda/mass.hpp:74-95) rather than embedding
them in the module.
"""

from __future__ import annotations

from typing import Callable

import jax
from jax.tree_util import tree_flatten, tree_unflatten

__all__ = ["hoisted_jit"]

try:  # jax >= 0.5 moved core to jax.extend
    from jax.extend.core import jaxpr_as_fun  # noqa: F401
    from jax.extend import core as _core
except Exception:  # pragma: no cover - older jax
    from jax import core as _core  # type: ignore


def _eval_jaxpr(jaxpr, consts, *args):
    import jax.core as jcore

    ev = getattr(jcore, "eval_jaxpr", None)
    if ev is None:  # pragma: no cover
        from jax._src.core import eval_jaxpr as ev
    return ev(jaxpr, consts, *args)


def hoisted_jit(fn: Callable, *example_args, min_bytes: int = 1 << 16,
                **jit_kwargs) -> Callable:
    """``jax.jit(fn)`` with large closed-over array constants hoisted to
    runtime arguments.

    ``example_args``: abstract (ShapeDtypeStruct) or concrete arrays
    fixing the call signature. Constants smaller than ``min_bytes``
    stay embedded (they fold into the program); larger ones are
    device_put once and passed at every dispatch. The returned callable
    keeps the original signature; hoisted buffers are available as
    attribute ``consts``.
    """
    closed, out_shape = jax.make_jaxpr(fn, return_shape=True)(*example_args)
    _, out_tree = tree_flatten(out_shape)
    consts = list(closed.consts)

    def _nbytes(c):
        try:
            import numpy as np

            return int(np.prod(np.shape(c)) * np.dtype(c.dtype).itemsize)
        except Exception:
            return 0

    is_big = [_nbytes(c) >= min_bytes for c in consts]
    small = [c for c, b in zip(consts, is_big) if not b]
    big = [jax.device_put(c) for c, b in zip(consts, is_big) if b]

    def merged(big_vals):
        it_s, it_b = iter(small), iter(big_vals)
        return [next(it_b if b else it_s) for b in is_big]

    def converted(big_vals, *args):
        flat, _ = tree_flatten(args)
        out = _eval_jaxpr(closed.jaxpr, merged(big_vals), *flat)
        return tree_unflatten(out_tree, out)

    jfn = jax.jit(converted, **jit_kwargs)

    def run(*args):
        return jfn(big, *args)

    run.consts = big
    run.jitted = jfn
    run.n_hoisted = len(big)
    return run
