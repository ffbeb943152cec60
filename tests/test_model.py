"""End-to-end model tests: boundary weights, windowing, and the analytic
plane-wave validation of the planar3d HIFU solve (SURVEY.md §4.6, done
in-repo here rather than offline)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from wave_fenics_tpu.core.mesh import FacetTags, box_mesh
from wave_fenics_tpu.models.linear_wave import LinearWave, lumped_boundary_weights
from wave_fenics_tpu.models.planar3d import analytic_plane_wave, planar3d_case


def test_boundary_weights_area():
    """Lumped facet weights must integrate 1 to the face area."""
    mesh = box_mesh((3, 2, 4), (1.0, 0.5, 2.0))
    for fid, area in [(0, 0.5 * 2.0), (1, 0.5 * 2.0), (2, 1.0 * 2.0), (4, 1.0 * 0.5)]:
        W = lumped_boundary_weights(mesh, 4, (fid,))
        np.testing.assert_allclose(W.sum(), area, rtol=1e-12)


def test_boundary_weights_quadratic_exactness():
    """sum W * f(dofs) == integral of f over the face for smooth f (GLL
    facet quadrature, exact for degree <= 2p-3 per direction)."""
    mesh = box_mesh((2, 2, 2), (1.0, 1.0, 1.0))
    p = 4
    W = lumped_boundary_weights(mesh, p, (0,))  # x=0 face
    from wave_fenics_tpu.core.dofmap import StructuredDofGrid

    dg = StructuredDofGrid(mesh, p)
    C = dg.dof_coords_grid()
    f = C[..., 1] ** 3 * C[..., 2] ** 2  # integral over unit face = 1/4 * 1/3
    np.testing.assert_allclose((W * f).sum(), 1.0 / 12.0, rtol=1e-12)


def test_window_ramp():
    case = planar3d_case(ncells=(4, 2, 2), domain_length=0.01)
    m = case.model
    T = m.period
    assert float(m.window(jnp.asarray(0.0))) == 0.0
    np.testing.assert_allclose(float(m.window(jnp.asarray(4 * T))), 1.0, atol=1e-12)
    np.testing.assert_allclose(float(m.window(jnp.asarray(100 * T))), 1.0)
    # monotone ramp
    ts = np.linspace(0, 4 * T, 50)
    ws = [float(m.window(jnp.asarray(t))) for t in ts]
    assert all(b >= a - 1e-12 for a, b in zip(ws, ws[1:]))


def test_zero_source_stays_zero():
    mesh = box_mesh((4, 2, 2), (1.0, 0.5, 0.5), facet_tags=FacetTags({}))
    model = LinearWave(mesh, p=3, dtype=jnp.float64)
    u, v, _ = model.solve(0.0, 1e-5, 1e-6)
    assert float(jnp.abs(u).max()) == 0.0
    assert float(jnp.abs(v).max()) == 0.0


@pytest.mark.slow
def test_planar3d_analytic_plane_wave():
    """The flagship correctness check: 2-wavelength planar HIFU solve in f64
    must match the analytic traveling wave after the source ramp."""
    case = planar3d_case(
        ncells=(16, 2, 2), domain_length=6.0e-3, dtype=jnp.float64
    )
    m = case.model
    solve = jax.jit(
        lambda: m.solve(case.t0, case.tf, case.dt), static_argnums=()
    )
    u, v, nsteps = m.solve(case.t0, case.tf, case.dt)
    u = np.asarray(u)
    from wave_fenics_tpu.core.dofmap import StructuredDofGrid

    dg = StructuredDofGrid(m.mesh, m.p)
    x = dg.axis_coords(0)
    u_line = u[:, 0, 0]  # transverse-invariant solution: take one line
    u_exact = analytic_plane_wave(x, case.tf, case)
    rel = np.linalg.norm(u_line - u_exact) / np.linalg.norm(u_exact)
    assert rel < 1e-5, rel  # measured 6.4e-7 at this resolution
    # transverse invariance
    spread = np.abs(u - u_line[:, None, None]).max()
    assert spread < 1e-6 * np.abs(u).max()


def test_energy_conserved_closed_box():
    """With no source/ABC faces, the semi-discrete system conserves acoustic
    energy; RK4 preserves it to O(dt^4) per step."""
    from wave_fenics_tpu.core.dofmap import StructuredDofGrid
    from wave_fenics_tpu.models.diagnostics import energy, l2_norm

    mesh = box_mesh((4, 4, 4), (1.0, 1.0, 1.0), facet_tags=FacetTags({}))
    model = LinearWave(mesh, p=3, c0=1.0, dtype=jnp.float64)
    dg = StructuredDofGrid(mesh, 3)
    C = dg.dof_coords_grid()
    # smooth standing-wave initial condition
    u0 = jnp.asarray(
        np.sin(np.pi * C[..., 0]) * np.sin(np.pi * C[..., 1])
        * np.sin(np.pi * C[..., 2])
    )
    v0 = jnp.zeros_like(u0)
    E0 = float(energy(model, u0, v0))
    assert E0 > 0
    dt = 2e-3
    u, v, _ = model.solve(0.0, 200 * dt, dt, u0, v0)
    E1 = float(energy(model, u, v))
    assert abs(E1 - E0) / E0 < 1e-6  # RK4 dissipation O(dt^4): measured 3.3e-8
    assert float(l2_norm(model, u0)) == pytest.approx(
        np.sqrt(1 / 8), rel=1e-6
    )  # ||sin sin sin||_L2 over the unit box


def test_energy_decays_with_abc():
    """Absorbing boundary removes energy (after the source is switched off
    the field radiates out)."""
    from wave_fenics_tpu.models.diagnostics import energy

    tags = FacetTags({2: (0, 1)})  # both x-faces absorbing, no source
    mesh = box_mesh((4, 2, 2), (1.0, 0.5, 0.5), facet_tags=tags)
    model = LinearWave(mesh, p=3, c0=1.0, dtype=jnp.float64)
    from wave_fenics_tpu.core.dofmap import StructuredDofGrid

    dg = StructuredDofGrid(mesh, 3)
    C = dg.dof_coords_grid()
    u0 = jnp.asarray(np.exp(-50 * (C[..., 0] - 0.5) ** 2))
    v0 = jnp.zeros_like(u0)
    E0 = float(energy(model, u0, v0))
    dt = 2e-3
    u, v, _ = model.solve(0.0, 400 * dt, dt, u0, v0)
    E1 = float(energy(model, u, v))
    assert E1 < 0.6 * E0  # the pulse reached the faces and left


@pytest.mark.slow
def test_p_convergence_plane_wave():
    """Spectral (p-) convergence of the end-to-end HIFU solve: error drops
    by orders of magnitude from p=2 to p=4 at fixed resolution."""
    errs = {}
    for p in (2, 3, 4):
        case = planar3d_case(
            ncells=(12, 1, 1), domain_length=4.5e-3, degree=p,
            width=4.5e-3 / 12, dtype=jnp.float64,
        )
        m = case.model
        u, v, _ = m.solve(case.t0, case.tf, case.dt)
        from wave_fenics_tpu.core.dofmap import StructuredDofGrid

        dg = StructuredDofGrid(m.mesh, p)
        x = dg.axis_coords(0)
        u_exact = analytic_plane_wave(x, case.tf, case)
        errs[p] = float(
            np.linalg.norm(np.asarray(u)[:, 0, 0] - u_exact)
            / np.linalg.norm(u_exact)
        )
    assert errs[3] < 0.2 * errs[2]
    assert errs[4] < 0.2 * errs[3]


@pytest.mark.slow
def test_leapfrog_kernels_analytic_plane_wave():
    """Physics bound for the leapfrog integrator: f64 planar HIFU solve vs
    the analytic traveling wave. The spatial error is at the RK4 class;
    the leapfrog floor is pure O(dt^2) temporal dispersion, so refining
    dt by 4 cuts the error by ~16 and dt/8 reaches the RK4 test's 1e-5
    tolerance class."""
    from wave_fenics_tpu.core.dofmap import StructuredDofGrid
    from wave_fenics_tpu.solvers.leapfrog import leapfrog_solve_n

    case = planar3d_case(
        ncells=(12, 1, 1), domain_length=4.5e-3, width=4.5e-3 / 12,
        dtype=jnp.float64,
    )
    m = case.model
    dg = StructuredDofGrid(m.mesh, m.p)
    x = dg.axis_coords(0)
    u_exact = analytic_plane_wave(x, case.tf, case)
    n0 = int(np.ceil((case.tf - case.t0) / (0.71 * case.dt)))
    damp = np.asarray(m.damping)
    u0, v0 = m.zero_state()

    def err(k):
        n = k * n0
        dt = (case.tf - case.t0) / n
        u, _ = jax.jit(lambda a, b: leapfrog_solve_n(
            m.force, damp, a, b, case.t0, dt, n))(u0, v0)
        ug = np.asarray(u)
        return np.linalg.norm(ug[:, 0, 0] - u_exact) / np.linalg.norm(
            u_exact)

    e1, e4, e8 = err(1), err(4), err(8)
    assert e1 < 5e-4, e1           # CFL-dt physics bound
    assert 12 < e1 / e4 < 22, (e1, e4)  # 2nd order: ~16
    assert e8 < 1e-5, e8           # the RK4 test's tolerance class


@pytest.mark.slow
def test_probe_recording_matches_analytic():
    """Recorded probe time series matches the analytic traveling wave in
    steady state (the 'hydrophone' observable)."""
    from wave_fenics_tpu.models.linear_wave import solve_recording

    case = planar3d_case(ncells=(16, 2, 2), domain_length=6.0e-3,
                         dtype=jnp.float64)
    m = case.model
    x_probe = 3.0e-3
    nsteps = case.nsteps
    u, v, series = solve_recording(
        m, case.t0, case.dt, nsteps, np.array([[x_probe, 0.0, 0.0]])
    )
    ts = case.t0 + case.dt * np.arange(1, nsteps + 1)
    # compare over the final periods (past ramp + transit)
    sel = ts > (m.alpha * m.period + x_probe / m.c0 + 2 * m.period)
    tau = ts[sel] - x_probe / m.c0
    exact = m.p0 * np.sin(m.w0 * tau)
    got = np.asarray(series)[sel, 0]
    rel = np.linalg.norm(got - exact) / np.linalg.norm(exact)
    assert rel < 1e-4, rel


def test_structured_heterogeneous_model():
    """Two-layer medium on the structured model: runs, differs from the
    homogeneous solve, and conserves energy on a closed box."""
    from wave_fenics_tpu.models.diagnostics import energy

    mesh = box_mesh((4, 2, 2), (1.0, 0.5, 0.5), facet_tags=FacetTags({}))
    mids = mesh.cell_midpoints()
    c0_cells = np.where(mids[:, 0] < 0.5, 1.0, 1.3)
    het = LinearWave(mesh, p=3, c0=1.0, dtype=jnp.float64, c0_cells=c0_cells)
    hom = LinearWave(mesh, p=3, c0=1.0, dtype=jnp.float64)
    from wave_fenics_tpu.core.dofmap import StructuredDofGrid

    dg = StructuredDofGrid(mesh, 3)
    C = dg.dof_coords_grid()
    u0 = jnp.asarray(np.exp(-30 * (C[..., 0] - 0.3) ** 2))
    v0 = jnp.zeros_like(u0)
    dt = 1e-3
    u_het, v_het, _ = het.solve(0.0, 300 * dt, dt, u0, v0)
    u_hom, v_hom, _ = hom.solve(0.0, 300 * dt, dt, u0, v0)
    assert float(jnp.linalg.norm(u_het - u_hom)) > 1e-3 * float(
        jnp.linalg.norm(u_hom)
    )
    # energy functional with the same heterogeneous operator is conserved
    E = lambda u, v: 0.5 * (
        jnp.vdot(v, het.ops.mass(v)) - jnp.vdot(u, het.ops.stiffness(u, 1.0))
    )
    np.testing.assert_allclose(
        float(E(u_het, v_het)), float(E(u0, v0)), rtol=1e-6
    )
