"""NumPy dense-assembly oracles for operator tests.

Plays the role of the reference's CPU oracle operators
(MassOperatorCPU, common/operators.hpp:43-109; --check path of
demo/gpu_operator_monolithic/main.cpp:102-118) — but assembles the full
dense global matrices by direct quadrature, making the check unconditional
rather than a single-vector comparison.
"""

import numpy as np

from wave_fenics_tpu.core import geometry
from wave_fenics_tpu.core.basis import tabulate_1d


def tables_3d(p, q=None, rule="gll"):
    """3D tabulation: Phi[nq, nd], dPhi[3, nq, nd] (z-fastest flattening)."""
    tab = tabulate_1d(p, q, rule)
    B, D = tab.B, tab.D
    Phi = np.einsum("qi,rj,sk->qrsijk", B, B, B)
    nq, nd = tab.nq**3, tab.nd**3
    Phi = Phi.reshape(nq, nd)
    dx = np.einsum("qi,rj,sk->qrsijk", D, B, B).reshape(nq, nd)
    dy = np.einsum("qi,rj,sk->qrsijk", B, D, B).reshape(nq, nd)
    dz = np.einsum("qi,rj,sk->qrsijk", B, B, D).reshape(nq, nd)
    return Phi, np.stack([dx, dy, dz])


def assemble_dense(mesh_hex, dofmap, p, q=None, rule="gll", coeff=1.0):
    """Dense global (M, K): M = sum_c P_c^T Phi^T diag(detJw) Phi P_c,
    K = coeff * sum_c P_c^T [sum_q dphi^T G dphi] P_c."""
    Phi, dPhi = tables_3d(p, q, rule)
    G, detJw = geometry.precompute_geometric_data(mesh_hex, p, q, rule, clamp=False)
    nc = mesh_hex.ncells
    nd = Phi.shape[1]
    ndofs = int(dofmap.max()) + 1
    M = np.zeros((ndofs, ndofs))
    K = np.zeros((ndofs, ndofs))
    for c in range(nc):
        Me = Phi.T @ (detJw[c][:, None] * Phi)
        Ke = np.zeros((nd, nd))
        for d in range(3):
            for e in range(3):
                if np.any(G[c][:, d, e]):  # axis-aligned cells: diagonal G
                    Ke += dPhi[d].T @ (G[c][:, d, e, None] * dPhi[e])
        idx = dofmap[c]
        M[np.ix_(idx, idx)] += Me
        K[np.ix_(idx, idx)] += coeff * Ke
    return M, K


def box_facet_weights(mesh, p, facet_ids):
    """Lumped facet-mass grid [Nx, Ny, Nz] of the given box faces by GLL
    facet quadrature, cell face by cell face: each face node gets
    (w_j / sum w) (w_k / sum w) * (cell face area)."""
    from wave_fenics_tpu.core.basis import gll_points_weights
    from wave_fenics_tpu.core.mesh import BOX_FACETS

    _, w = gll_points_weights(p + 1)
    w = w / w.sum()
    shape = tuple(n * p + 1 for n in mesh.shape)
    W = np.zeros(shape)
    for fid in facet_ids:
        axis, side = BOX_FACETS[fid]
        a, b = [d for d in range(3) if d != axis]
        area = mesh.h[a] * mesh.h[b]
        plane = 0 if side == 0 else shape[axis] - 1
        for ca in range(mesh.shape[a]):
            for cb in range(mesh.shape[b]):
                for j in range(p + 1):
                    for k in range(p + 1):
                        idx = [0, 0, 0]
                        idx[axis] = plane
                        idx[a] = ca * p + j
                        idx[b] = cb * p + k
                        W[tuple(idx)] += w[j] * w[k] * area
    return W


def source_amplitude(t, c0, freq0, p0, alpha):
    """g(t): the windowed source value of the planar HIFU boundary
    (LinearGLL.hpp:154-162)."""
    w0 = 2.0 * np.pi * freq0
    ramp = 0.5 * (1.0 - np.cos(freq0 * np.pi * t / alpha))
    window = ramp if t < alpha / freq0 else 1.0
    return window * p0 * w0 / c0 * np.cos(w0 * t)


def dense_wave(K, m, W1, W2, c0, freq0, p0, alpha):
    """(f1, force, damping) of the dense semi-discrete wave system
    du/dt = v, dv/dt = (K u + c0^2 g(t) W1 - c0 W2 v) / m, with K the
    assembled stiffness already scaled by -c0^2."""
    def force(t, u):
        g = source_amplitude(t, c0, freq0, p0, alpha)
        return (K @ u + c0**2 * g * W1) / m

    damping = c0 * W2 / m
    f1 = lambda t, u, v: force(t, u) - damping * v
    return f1, force, damping


def rk4_step_dense(f1, u, v, t, dt):
    """One classic RK4 step of (u' = v, v' = f1) — the reference tableau
    (LinearGLL.hpp:233-236)."""
    k1u, k1v = v, f1(t, u, v)
    k2u, k2v = (v + 0.5 * dt * k1v,
                f1(t + 0.5 * dt, u + 0.5 * dt * k1u, v + 0.5 * dt * k1v))
    k3u, k3v = (v + 0.5 * dt * k2v,
                f1(t + 0.5 * dt, u + 0.5 * dt * k2u, v + 0.5 * dt * k2v))
    k4u, k4v = v + dt * k3v, f1(t + dt, u + dt * k3u, v + dt * k3v)
    return (u + dt / 6 * (k1u + 2 * k2u + 2 * k3u + k4u),
            v + dt / 6 * (k1v + 2 * k2v + 2 * k3v + k4v))


def leapfrog_step_dense(force, damping, u, v, t, dt):
    """One kick-drift-kick step with the semi-implicit diagonal damping
    (implicit first half-kick, explicit second)."""
    vh = (v + 0.5 * dt * force(t, u)) / (1.0 + 0.5 * dt * damping)
    u = u + dt * vh
    v = (1.0 - 0.5 * dt * damping) * vh + 0.5 * dt * force(t + dt, u)
    return u, v
