"""wave_fenics_tpu: matrix-free spectral-element wave solver in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
Excalibur-SLE/wave-fenics (matrix-free high-order FEM for the linear
second-order wave equation, GLL spectral elements on hexahedra, explicit RK4,
matrix-free CG), run on NVIDIA GPUs through XLA:

- element operators are sum-factorized batched tensor contractions
- dof gather/scatter on structured meshes is pure reshape/overlap-add
  (no atomics, deterministic)
- distribution is SPMD domain decomposition over a ``jax.sharding.Mesh`` with
  ``lax.ppermute`` halo exchange and ``lax.psum`` reductions
"""

from . import core, models, ops, solvers  # noqa: F401

__version__ = "0.1.0"
