"""The 3D planar HIFU benchmark case — the reference's north-star workload.

Mirrors demo/cpu_planar3d/main.cpp:
- material/source/domain constants (:24-36): c0 = 1500 m/s, f0 = 0.5 MHz,
  p0 = 60 kPa, L = 0.1 m, basis degree 4
- CFL timestep dt = CFL * hmin / (c0 * p^2), snapped to an integer number of
  steps per source period (:61-66)
- final time tf = L/c0 + 8/f0 (:64)
- boundary tags: source plane at x = 0 (ds(1)), absorbing plane at x = L
  (ds(2)) — the reference reads these from an external XDMF meshtag file;
  the planar3d geometry makes them the two x-faces.

The reference's mesh is external (not in-repo); here the domain is a
configurable box (L x W x W) of hex cells. For the true planar problem the
transverse resolution can be minimal (the solution is x-only), which the
analytic plane-wave check in tests exploits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.mesh import FacetTags, box_mesh
from .linear_wave import LinearWave

__all__ = ["Planar3DCase", "planar3d_case", "planar3d_case_xdmf"]


@dataclass(frozen=True)
class Planar3DCase:
    model: LinearWave
    t0: float
    tf: float
    dt: float
    steps_per_period: int

    @property
    def nsteps(self) -> int:
        return int((self.tf - self.t0) / self.dt) + 1


def planar3d_case(
    ncells: tuple[int, int, int] = (64, 4, 4),
    domain_length: float = 0.1,
    width: float | None = None,
    degree: int = 4,
    speed_of_sound: float = 1500.0,
    source_frequency: float = 0.5e6,
    pressure_amplitude: float = 60000.0,
    cfl: float = 0.5,
    n_tail_periods: float = 8.0,
    dtype=None,
) -> Planar3DCase:
    """Build the planar3d case (demo/cpu_planar3d/main.cpp:24-72 semantics)."""
    import jax.numpy as jnp

    if dtype is None:
        dtype = jnp.float32
    L = domain_length
    if width is None:
        width = L * ncells[1] / ncells[0]  # keep cells cubic by default
    tags = FacetTags({1: (0,), 2: (1,)})  # x=lo -> source, x=hi -> absorbing
    mesh = box_mesh(ncells, (L, width, width), facet_tags=tags)

    model = LinearWave(
        mesh=mesh,
        p=degree,
        c0=speed_of_sound,
        freq0=source_frequency,
        p0=pressure_amplitude,
        dtype=dtype,
    )

    # CFL timestep snapped to integer steps per period (main.cpp:61-66)
    h = mesh.hmin()
    dt = cfl * h / (speed_of_sound * degree**2)
    period = 1.0 / source_frequency
    steps_per_period = int(period / dt) + 1
    dt = period / steps_per_period

    t0 = 0.0
    tf = L / speed_of_sound + n_tail_periods / source_frequency
    return Planar3DCase(
        model=model, t0=t0, tf=tf, dt=dt, steps_per_period=steps_per_period
    )


def planar3d_case_xdmf(
    mesh_path: str,
    meshtags_path: str | None = None,
    degree: int = 4,
    speed_of_sound: float = 1500.0,
    source_frequency: float = 0.5e6,
    pressure_amplitude: float = 60000.0,
    cfl: float = 0.5,
    n_tail_periods: float = 8.0,
    source_tag: int = 1,
    abc_tag: int = 2,
    dtype=None,
    quadrature: str = "gll",
) -> Planar3DCase:
    """The planar3d case on an IMPORTED mesh — the reference's actual
    workflow (demo/cpu_planar3d/main.cpp:39-45 reads mesh + facet
    meshtags from XDMF; ds(1) = source, ds(2) = absorbing). The model is
    the explicit-dofmap ``GeneralLinearWave`` (indexed gather/scatter
    operators); dt uses the same CFL-snap as the box case
    (main.cpp:61-66) with hmin measured on the imported geometry, and
    tf = Lx/c0 + tail with Lx the mesh's x-extent (main.cpp:64)."""
    import jax.numpy as jnp

    from .general_wave import from_xdmf

    if dtype is None:
        dtype = jnp.float32
    model = from_xdmf(
        mesh_path,
        meshtags_path,
        p=degree,
        c0=speed_of_sound,
        freq0=source_frequency,
        p0=pressure_amplitude,
        source_tag=source_tag,
        abc_tag=abc_tag,
        dtype=dtype,
        quadrature=quadrature,
    )
    h = model.mesh.hmin()
    dt = cfl * h / (speed_of_sound * degree**2)
    period = 1.0 / source_frequency
    steps_per_period = int(period / dt) + 1
    dt = period / steps_per_period

    xs = np.asarray(model.mesh.points)[:, 0]
    L = float(xs.max() - xs.min())
    t0 = 0.0
    tf = L / speed_of_sound + n_tail_periods / source_frequency
    return Planar3DCase(
        model=model, t0=t0, tf=tf, dt=dt, steps_per_period=steps_per_period
    )


def analytic_plane_wave(x: np.ndarray, t: float, case: Planar3DCase) -> np.ndarray:
    """Steady-state analytic solution of the 1D planar problem.

    After the source window has fully ramped (t > alpha*T) and the wavefront
    has passed position x, u(x, t) = p0 * sin(w0 (t - x/c0)).
    The boundary condition g = p0 w0 / c0 cos(w0 t) on ds(1) imposes
    du/dx(0) = -p0 w0/c0 cos(w0 t) ... matching the traveling wave; used by
    tests to validate the end-to-end solve.
    """
    m = case.model
    tau = t - x / m.c0
    return m.p0 * np.sin(m.w0 * tau) * (tau > 0)
