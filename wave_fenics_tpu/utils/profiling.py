"""Tracing/profiling: the NVTX / nsys / cudaProfilerApi analogue.

The reference brackets hot phases with nvtxMark and gates nsys capture via
cudaProfilerStart/Stop (SURVEY.md §5: gpu_cg/CUDA/cg.hpp:74-113,
gpu_scatter_mpi/main.cpp:89-123). Equivalents here:

- ``annotate(name)``      -> jax.named_scope + jax.profiler trace annotation
  (shows up in XLA/perfetto traces like an NVTX range)
- ``trace(logdir)``       -> jax.profiler.trace context (nsys capture-range
  analogue; view with tensorboard/xprof)
- ``step_annotation(n)``  -> jax.profiler.StepTraceAnnotation
- ``xla_dump(dirpath)``   -> env hook to dump HLO for offline inspection
"""

from __future__ import annotations

import contextlib
import os

import jax

__all__ = ["annotate", "trace", "step_annotation", "xla_dump_flags"]


@contextlib.contextmanager
def annotate(name: str):
    """Range marker visible in profiler traces (NVTX analogue)."""
    with jax.named_scope(name):
        with jax.profiler.TraceAnnotation(name):
            yield


def trace(logdir: str):
    """Profiler capture context (nsys --capture-range analogue)."""
    return jax.profiler.trace(logdir)


def step_annotation(step: int):
    return jax.profiler.StepTraceAnnotation("step", step_num=step)


def xla_dump_flags(dirpath: str) -> str:
    """XLA_FLAGS snippet to dump optimized HLO to ``dirpath``."""
    os.makedirs(dirpath, exist_ok=True)
    return f"--xla_dump_to={dirpath} --xla_dump_hlo_as_text"
