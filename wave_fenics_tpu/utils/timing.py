"""Timing utilities: the dolfinx ``common::Timer`` / ``MPI_Wtime``
analogue (SURVEY.md §5). Device work is asynchronous, so every timed
region ends in ``jax.block_until_ready``.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import jax
import numpy as np

__all__ = ["Timer", "timeit"]


class Timer:
    """Named accumulating timers with a printable table
    (dolfinx ``list_timings`` analogue)."""

    def __init__(self):
        self._acc: dict[str, float] = defaultdict(float)
        self._n: dict[str, int] = defaultdict(int)

    @contextmanager
    def __call__(self, name: str, *sync_arrays):
        t0 = time.perf_counter()
        yield
        jax.block_until_ready(sync_arrays)
        self._acc[name] += time.perf_counter() - t0
        self._n[name] += 1

    def table(self) -> str:
        lines = [f"{'timer':<40} {'calls':>6} {'total s':>10} {'mean ms':>10}"]
        for k in sorted(self._acc):
            n, tot = self._n[k], self._acc[k]
            lines.append(f"{k:<40} {n:>6} {tot:>10.4f} {tot / n * 1e3:>10.3f}")
        return "\n".join(lines)


def timeit(fn, *args, reps: int = 5, warmup: int = 2) -> float:
    """Median wall-clock seconds of ``fn(*args)``, each call waited for
    with ``jax.block_until_ready``."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))
