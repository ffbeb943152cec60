"""Distributed execution for UNSTRUCTURED (explicit-dofmap) meshes.

The reference distributes arbitrary partitioned DOLFINx meshes with MPI
neighbor all-to-all over owned/ghost index maps
(demo/gpu_scatter_mpi/VectorUpdater.hpp:21-230, DOLFINx common::IndexMap).
The redesign keeps the *capability* — any hex mesh, any cell
partition — but re-expresses the variable-size per-neighbor machinery as
fixed-shape sharded tables + XLA collectives under ``shard_map``:

- cells are split by recursive coordinate bisection (``rcb_partition``);
- each device holds its cells' dofs (owned + interface copies) in a local
  vector padded to a common length (+1 dummy slot that absorbs padding);
- after a local matrix-free apply, interface dofs hold PARTIAL sums;
  two interchangeable fixed-shape assembly modes complete them (the
  forward+reverse scatter of VectorUpdater, deterministic by fixed
  summation order):
  * ``allgather``: one ``all_gather`` of each device's interface buffer
    plus a static per-device gather-sum table — one collective, O(ndev)
    traffic; best for small fleets;
  * ``ppermute``: the VectorUpdater-faithful NEIGHBOR exchange
    (VectorUpdater.hpp:106-152's MPI_Dist_graph point-to-point,
    re-expressed for XLA collectives): pairwise dof buckets between parts that
    actually share interface dofs, greedily edge-colored into rounds of
    disjoint pairs, one ``lax.ppermute`` per round — O(max_degree *
    max_bucket) traffic per device, independent of fleet size;
  ``exchange='auto'`` picks the cheaper per-device traffic.
- ownership weights (1/multiplicity) make global dots exact, as in the
  structured paths.

All shapes are static (padded to per-fleet maxima), so the whole solve
jits into one XLA program per device; its collectives go to NCCL on GPUs.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..models.general_wave import GeneralLinearWave
from ..ops import element_kernels as ek
from ..solvers.rk4 import rk4_solve_n

__all__ = ["rcb_partition", "ShardedGeneralWave"]


def rcb_partition(points: np.ndarray, nparts: int) -> np.ndarray:
    """Recursive coordinate bisection of point set into ``nparts`` balanced
    parts (the mesh-agnostic analogue of the reference's Cartesian
    decompose, demo/gpu_cg/mesh.hpp:37-112). Returns part id per point."""
    parts = np.zeros(len(points), np.int32)

    def rec(idx, lo, n):
        if n == 1:
            parts[idx] = lo
            return
        n0 = n // 2
        axis = int(np.argmax(np.ptp(points[idx], axis=0)))
        order = idx[np.argsort(points[idx][:, axis], kind="stable")]
        cut = len(idx) * n0 // n
        rec(order[:cut], lo, n0)
        rec(order[cut:], lo + n0, n - n0)

    rec(np.arange(len(points)), 0, nparts)
    return parts


@dataclass(frozen=True)
class ShardedGeneralWave:
    """Distributed GeneralLinearWave over a 1D device mesh ('d').

    Each device applies the indexed stiffness to its own cells (local
    dofmaps and geometric factors padded to fleet maxima, so ONE
    compiled program serves every device)."""

    model: GeneralLinearWave
    ndev: int
    devices: object = None
    #: interface-assembly collective: 'allgather' (one all_gather +
    #: gather-sum), 'ppermute' (edge-colored pairwise neighbor rounds),
    #: or 'auto' (cheaper per-device traffic)
    exchange: str = "auto"

    @cached_property
    def mesh(self) -> Mesh:
        devs = self.devices if self.devices is not None else jax.devices()
        if len(devs) < self.ndev:
            raise ValueError(f"need {self.ndev} devices, have {len(devs)}")
        return Mesh(np.array(devs[: self.ndev]), axis_names=("d",))

    # ------------------------------------------------------------------
    # host setup: partition, local maps, exchange tables
    # ------------------------------------------------------------------
    @cached_property
    def _setup(self):
        md = self.model
        nd = (md.p + 1) ** 3
        dofmap = np.asarray(md.dofs.dofmap, np.int64)
        nc = dofmap.shape[0]
        cent = md.mesh.cell_coords().mean(axis=1)
        part = rcb_partition(cent, self.ndev)

        cells_of = [np.where(part == i)[0] for i in range(self.ndev)]
        NC = max(len(c) for c in cells_of)

        loc_ids: list[np.ndarray] = []  # global ids of local dofs, per part
        g2l: list[dict] = []
        for i in range(self.ndev):
            ids = np.unique(dofmap[cells_of[i]])
            loc_ids.append(ids)
            g2l.append({int(g): k for k, g in enumerate(ids)})
        NL = max(len(ids) for ids in loc_ids)
        NLP = NL + 1  # +1 dummy slot absorbing all padding

        # local dofmaps + geometric factors, padded
        ldof = np.full((self.ndev, NC, nd), NL, np.int32)
        G = np.asarray(md.ops._G)  # [nc, nq, nq, nq, 3, 3]
        npdt = np.dtype(md.dtype)
        Gl = np.zeros((self.ndev, NC) + G.shape[1:], npdt)
        for i, cells in enumerate(cells_of):
            lut = g2l[i]
            ldof[i, : len(cells)] = np.vectorize(lut.__getitem__)(
                dofmap[cells]
            ).astype(np.int32)
            Gl[i, : len(cells)] = G[cells]

        # per-dof part multiplicity -> interface dofs + ownership weights
        counts = np.zeros(md.ndofs, np.int32)
        for ids in loc_ids:
            counts[ids] += 1
        shared = counts > 1

        # interface buffers: slot s of part i <-> global dof bdofs[i][s]
        bdofs = [ids[shared[ids]] for ids in loc_ids]
        S = max((len(b) for b in bdofs), default=1) or 1
        bidx = np.full((self.ndev, S), NL, np.int32)
        slot_of = [dict() for _ in range(self.ndev)]
        for i, bd in enumerate(bdofs):
            for s, g in enumerate(bd):
                bidx[i, s] = g2l[i][int(g)]
                slot_of[i][int(g)] = s
        deg = max((int(counts[bd].max()) for bd in bdofs if len(bd)),
                  default=2)
        K = max(deg - 1, 1)
        # recv[i, s, k]: flat index into the all-gathered [ndev*S] buffer
        # (+ sentinel ndev*S -> appended zero) of the k-th OTHER copy
        recv = np.full((self.ndev, S, K), self.ndev * S, np.int32)
        holders: dict[int, list[int]] = {}
        for i, bd in enumerate(bdofs):
            for g in bd:
                holders.setdefault(int(g), []).append(i)
        for g, hs in holders.items():
            for i in hs:
                k = 0
                for j in hs:
                    if j == i:
                        continue
                    recv[i, slot_of[i][g], k] = j * S + slot_of[j][g]
                    k += 1

        # per-dof local vectors: inv_m, W1, W2, ownership weights
        def localize(vec, dummy=0.0):
            out = np.full((self.ndev, NLP), dummy, npdt)
            for i, ids in enumerate(loc_ids):
                out[i, : len(ids)] = vec[ids]
            return out

        inv_m = localize(np.asarray(md.inv_m, np.float64))
        # dummy slot m = 1 so implicit-solve operators stay SPD on padding
        m = localize(np.asarray(md.m, np.float64), dummy=1.0)
        W1 = localize(np.asarray(md.W1, np.float64))
        W2 = localize(np.asarray(md.W2, np.float64))
        own = localize(1.0 / counts.astype(np.float64))

        return dict(
            part=part, cells_of=cells_of, loc_ids=loc_ids, NC=NC,
            NL=NL, NLP=NLP, S=S, K=K,
            ldof=ldof, G=Gl, bidx=bidx, recv=recv,
            inv_m=inv_m, m=m, W1=W1, W2=W2, own=own,
        )

    @cached_property
    def _nbr_setup(self):
        """Bucketed neighbor-exchange tables (the ``ppermute`` assembly
        mode): for every part pair (i, j) sharing interface dofs, a
        fixed-size bucket of their common dofs (sorted by global id, so
        both sides agree on slot order). Pairs are greedily edge-colored
        into rounds of vertex-disjoint pairs; round r is one
        ``lax.ppermute`` with the static permutation of that color class
        (both directions of every pair ride the same collective).

        A dof held by v > 2 parts appears in all v*(v-1)/2 holder pairs,
        so summing every received bucket reproduces exactly the
        all-gather mode's sum of other copies' partials.

        Returns None when no interface dofs exist (ndev == 1)."""
        s = self._setup
        # interface dofs of part i = global ids behind bidx's local slots
        holders: dict[int, list[int]] = {}
        for i in range(self.ndev):
            ids = s["loc_ids"][i]
            sl = s["bidx"][i]
            for li in sl[sl != s["NL"]]:
                holders.setdefault(int(ids[li]), []).append(i)
        pair_dofs: dict[tuple[int, int], list[int]] = {}
        for g, hs in holders.items():
            for a in range(len(hs)):
                for b in range(a + 1, len(hs)):
                    pair_dofs.setdefault((hs[a], hs[b]), []).append(g)
        if not pair_dofs:
            return None
        Sb = max(len(v) for v in pair_dofs.values())
        # greedy edge coloring, largest buckets first (classic Vizing-
        # style bound: <= max_degree + 1 rounds on simple graphs)
        order = sorted(pair_dofs, key=lambda k: -len(pair_dofs[k]))
        colors: list[list[tuple[int, int]]] = []
        used: list[set[int]] = []
        for pair in order:
            i, j = pair
            for r, u in enumerate(used):
                if i not in u and j not in u:
                    colors[r].append(pair)
                    u.update(pair)
                    break
            else:
                colors.append([pair])
                used.append({i, j})
        NR = len(colors)
        lv = self._lv
        # send sentinel reads the appended zero (index lv); recv sentinel
        # adds into the dummy absorb slot NL
        sidx = np.full((self.ndev, NR, Sb), lv, np.int32)
        ridx = np.full((self.ndev, NR, Sb), s["NL"], np.int32)
        g2l = [{int(g): k for k, g in enumerate(ids)}
               for ids in s["loc_ids"]]
        perms: list[tuple[tuple[int, int], ...]] = []
        for r, cls in enumerate(colors):
            pr: list[tuple[int, int]] = []
            for (i, j) in cls:
                gs = sorted(pair_dofs[(i, j)])
                li = np.asarray([g2l[i][g] for g in gs], np.int32)
                lj = np.asarray([g2l[j][g] for g in gs], np.int32)
                sidx[i, r, : len(gs)] = li
                ridx[i, r, : len(gs)] = li
                sidx[j, r, : len(gs)] = lj
                ridx[j, r, : len(gs)] = lj
                pr += [(i, j), (j, i)]
            perms.append(tuple(pr))
        return dict(NR=NR, Sb=Sb, perms=tuple(perms), sidx=sidx,
                    ridx=ridx)

    @cached_property
    def exchange_mode(self) -> str:
        """The resolved assembly collective ('allgather' | 'ppermute')."""
        if self.exchange in ("allgather", "ppermute"):
            return self.exchange
        if self.exchange != "auto":
            raise ValueError(f"unknown exchange mode {self.exchange!r}")
        ns = self._nbr_setup
        if ns is None:
            return "allgather"
        s = self._setup
        # per-device traffic: NR rounds x Sb-slot buckets vs the
        # all_gather's ndev x S interface-buffer fan-in
        return ("ppermute"
                if ns["NR"] * ns["Sb"] < self.ndev * s["S"]
                else "allgather")

    @property
    def _lv(self) -> int:
        """Local vector length: local dofs + the dummy slot."""
        return self._setup["NLP"]

    # ------------------------------------------------------------------
    # device tables (sharded on axis 'd')
    # ------------------------------------------------------------------
    @cached_property
    def _tables(self):
        s = self._setup
        lv = self._lv
        sh = lambda a, spec: jax.device_put(
            jnp.asarray(a), NamedSharding(self.mesh, spec)
        )

        def shv(a, pad=0.0):  # per-dof vectors, padded to physical length
            out = np.full((self.ndev, lv), pad, a.dtype)
            out[:, : a.shape[1]] = a
            return sh(out, P("d", None))

        out = dict(inv_m=shv(s["inv_m"]))
        if self.exchange_mode == "ppermute":
            ns = self._nbr_setup
            if ns is not None:  # None: no interface dofs, assembly no-op
                out["sidx"] = sh(ns["sidx"], P("d", None, None))
                out["ridx"] = sh(ns["ridx"], P("d", None, None))
        else:
            out["bidx"] = sh(s["bidx"], P("d", None))
            out["recv"] = sh(s["recv"], P("d", None, None))
        out.update(
            m=shv(s["m"], pad=1.0),
            W1=shv(s["W1"]),
            W2=shv(s["W2"]),
            own=shv(s["own"]),
        )
        out["ldof"] = sh(s["ldof"], P("d", None, None))
        out["G"] = sh(s["G"], P("d", *([None] * (s["G"].ndim - 1))))
        return out

    @property
    def state_spec(self):
        return P("d", None)

    # ------------------------------------------------------------------
    # local physics (runs inside shard_map; arrays are local views)
    # ------------------------------------------------------------------
    def _assemble(self, b, tloc):
        """Sum interface partial contributions across parts
        (VectorUpdater.hpp:106-152 semantics, deterministic): either one
        all_gather of the fixed-size interface buffer + static
        gather-sum, or edge-colored pairwise neighbor ppermute rounds
        packed/unpacked through static bucket tables."""
        if self.exchange_mode == "ppermute":
            ns = self._nbr_setup
            if ns is None:
                return b
            # snapshot of the PARTIAL values: every round's bucket is
            # packed from bz, adds land in b — so a dof's outgoing value
            # never includes contributions received in earlier rounds
            bz = jnp.concatenate([b, jnp.zeros((1,), dtype=b.dtype)])
            sidx, ridx = tloc["sidx"], tloc["ridx"]
            for r, perm in enumerate(ns["perms"]):
                send = bz.at[sidx[r]].get(mode="promise_in_bounds")
                got = lax.ppermute(send, "d", perm)
                b = b.at[ridx[r]].add(got, mode="promise_in_bounds")
            return b
        bidx, recv = tloc["bidx"], tloc["recv"]
        buf = b[bidx]  # [S]
        g = lax.all_gather(buf, "d")  # [ndev, S]
        gf = jnp.concatenate(
            [g.reshape(-1), jnp.zeros((1,), dtype=b.dtype)]
        )
        add = gf.at[recv].get(mode="promise_in_bounds").sum(axis=1)
        return b.at[bidx].add(add, mode="promise_in_bounds")

    def _stiffness_local(self, u, tb):
        """Local partial stiffness apply: indexed gather -> element
        contraction -> scatter-add over this part's cells."""
        md = self.model
        m1 = md.p + 1
        coeff = -jnp.asarray(md.c0, dtype=md.dtype) ** 2
        xe = u.at[tb["ldof"]].get(
            mode="promise_in_bounds"
        ).reshape(-1, m1, m1, m1)
        ye = ek.stiffness_element_full(
            xe, np.asarray(md.ops._B), np.asarray(md.ops._D),
            tb["G"], coeff,
        )
        return jnp.zeros(u.shape, dtype=u.dtype).at[
            tb["ldof"].reshape(-1)
        ].add(ye.reshape(-1), mode="promise_in_bounds")

    def _f1_local(self, t, u, v, tb):
        md = self.model
        b = self._stiffness_local(u, tb)
        b = self._assemble(b, tb)
        g = (md.c0**2 * md.g_amplitude(t)).astype(md.dtype)
        b = b + g * tb["W1"] - md.c0 * (tb["W2"] * v)
        return b * tb["inv_m"]

    def _force_local(self, t, u, tb):
        """v-independent part of _f1_local — the leapfrog force
        (solvers/leapfrog.py); damping splits off as the diagonal
        c0 * W2 * inv_m."""
        md = self.model
        b = self._stiffness_local(u, tb)
        b = self._assemble(b, tb)
        g = (md.c0**2 * md.g_amplitude(t)).astype(md.dtype)
        return (b + g * tb["W1"]) * tb["inv_m"]

    # ------------------------------------------------------------------
    # drivers
    # ------------------------------------------------------------------
    def zero_state(self):
        z = jax.device_put(
            jnp.zeros((self.ndev, self._lv), dtype=self.model.dtype),
            NamedSharding(self.mesh, self.state_spec),
        )
        return z, z

    def solve_n(self, t0, dt, nsteps, u0=None, v0=None,
                integrator: str = "rk4"):
        """``integrator``: 'rk4' (parity default) or 'leapfrog' (ONE
        assembled stiffness apply + exchange per step; 2nd order, dt <=
        ~0.71x the RK4 CFL step — solvers/leapfrog.py)."""
        if integrator not in ("rk4", "leapfrog"):
            raise ValueError(f"unknown integrator: {integrator!r}")
        if u0 is None:
            u0, v0 = self.zero_state()
        tb = self._tables
        names = list(tb)
        specs = tuple(tb[n].sharding.spec for n in names)

        def local(u, v, *ops):
            # shard_map gives local blocks with the leading 'd' axis of
            # size 1; squeeze it
            tloc = {n: o.reshape(o.shape[1:]) for n, o in
                    zip(names, ops)}
            usq = u.reshape(u.shape[1:])
            vsq = v.reshape(v.shape[1:])
            if integrator == "leapfrog":
                from ..solvers.leapfrog import leapfrog_solve_n

                md = self.model
                damp = md.c0 * tloc["W2"] * tloc["inv_m"]
                force = lambda t, uu: self._force_local(t, uu, tloc)
                uo, vo = leapfrog_solve_n(force, damp, usq, vsq, t0,
                                          dt, nsteps)
            else:
                f0 = lambda t, uu, vv: vv
                f1 = lambda t, uu, vv: self._f1_local(t, uu, vv, tloc)
                uo, vo = rk4_solve_n(f0, f1, usq, vsq, t0, dt, nsteps)
            return uo.reshape(u.shape), vo.reshape(v.shape)

        sm = shard_map(
            local,
            mesh=self.mesh,
            in_specs=(self.state_spec, self.state_spec) + specs,
            out_specs=(self.state_spec, self.state_spec),
        )
        u, v = jax.jit(sm)(u0, v0, *[tb[n] for n in names])
        return u, v, nsteps

    def cg_solve(self, b, tau, kmax: int = 50, rtol: float = 1e-8):
        """Distributed CG solve of the SPD implicit-step system
        ``(diag(m) + tau*K) x = b`` on the unstructured partition — the
        reference's distributed matrix-free CG (demo/gpu_cg/CUDA/cg.hpp:
        37-121 + VectorUpdater halo per iteration) carried to arbitrary
        imported meshes. K is the positive stiffness (c0^2-weighted), m
        the assembled lumped mass; tau = beta*dt^2 in an implicit Newmark
        step. ``b`` is a local sharded vector of ASSEMBLED (consistent)
        values; Jacobi preconditioning by 1/m.

        Returns (x, iters, rnorm2) with x sharded like the state.
        """
        from ..solvers.cg import cg

        md = self.model
        tb = self._tables
        names = list(tb)
        specs = tuple(tb[n].sharding.spec for n in names)
        tau = np.dtype(md.dtype).type(tau)

        def local(bl, *ops):
            tloc = {n: o.reshape(o.shape[1:]) for n, o in
                    zip(names, ops)}
            bsq = bl.reshape(bl.shape[1:])

            def matvec(x):
                # _stiffness_local applies -c0^2-weighted stiffness
                s = self._stiffness_local(x, tloc)
                s = self._assemble(s, tloc)
                return tloc["m"] * x - tau * s

            dot = lambda a, c: lax.psum(
                jnp.sum(a * c * tloc["own"]), "d")
            x, k, rn = cg(matvec, bsq, kmax=kmax, rtol=rtol, dot=dot,
                          precond=lambda r: r / tloc["m"])
            return (x.reshape(bl.shape), k.reshape(1), rn.reshape(1))

        sm = shard_map(
            local, mesh=self.mesh,
            in_specs=(self.state_spec,) + specs,
            out_specs=(self.state_spec, P(), P()),
        )
        x, k, rn = jax.jit(sm)(b, *[tb[n] for n in names])
        return x, int(k[0]), rn[0]

    # ------------------------------------------------------------------
    # global <-> local conversion + weighted reductions
    # ------------------------------------------------------------------
    def from_global(self, x: np.ndarray) -> jax.Array:
        s = self._setup
        out = np.zeros((self.ndev, self._lv), np.dtype(self.model.dtype))
        for i, ids in enumerate(s["loc_ids"]):
            out[i, : len(ids)] = np.asarray(x)[ids]
        return jax.device_put(
            jnp.asarray(out), NamedSharding(self.mesh, self.state_spec)
        )

    def to_global(self, xs: jax.Array) -> np.ndarray:
        s = self._setup
        xs = np.asarray(xs)
        out = np.zeros(self.model.ndofs, xs.dtype)
        for i, ids in enumerate(s["loc_ids"]):
            out[ids] = xs[i, : len(ids)]
        return out

    def dot(self, a: jax.Array, b: jax.Array):
        """Ownership-weighted global dot (each shared dof counted once)."""
        tb = self._tables

        def local(x, y, w):
            return lax.psum(
                jnp.sum(x * y * w, keepdims=True).reshape(1, 1), "d"
            )

        sm = shard_map(
            local, mesh=self.mesh,
            in_specs=(self.state_spec, self.state_spec,
                      tb["own"].sharding.spec),
            out_specs=P(None, None),
        )
        return sm(a, b, tb["own"]).reshape(())
