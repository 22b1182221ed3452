"""Fully distributed IPCS Navier-Stokes on row-sharded lattice grids.

SPMD version of models/stokes.py (P2-P1 Taylor-Hood, Chorin/IPCS): the
P2 velocity dofs live on the fine (2nx+1)^2 lattice, the P1 pressure on
the coarse (nx+1)^2 lattice, both row-sharded over a 1-D device mesh
with aligned blocks (coarse row k <-> fine rows 2k, 2k+1). All operators
are lattice planes (ops/lattice.py):

  * the momentum matrix A, its rhs companion R = (rho/dt)M - 0.5 visc
    + 0.5 mu edge, and the P2 mass M — fine-grid planes, halo width 2;
  * the pressure Poisson K1 — coarse-grid planes, halo width 1;
  * the linear coupling terms (pressure-div MINUS pressure-edge, div,
    grad) — rectangular COO operators (models/stokes.host_coupling_coo)
    converted with lattice.to_planes_coo on the joint fine grid, so the
    boundary-edge integral is plain matrix entries and the sharded step
    needs NO facet communication.

The only per-step quadrature is the nonlinear convection term, computed
cell-partitioned by coarse row (static strided slices on the halo'd fine
grid, downward reverse-halo accumulation of the two overflow rows).
Krylov solves run inside shard_map with psum dots (ops/krylov with a
custom dot).

Communication per step: ppermute row halos (width 2 fine / 1 coarse)
inside each matvec, one 2-row reverse ship for convection, psum scalars
in the Krylov dots — all nearest-neighbor traffic.

cfg.multigrid composes the geometric V-cycle (ops/multigrid.py) with the
row sharding: level-0 weighted-Jacobi smoothing runs on the local rows
with the same halo matvec, the post-smooth residual is all_gather'd (a
few MB at most, one gather per cycle) and levels >= 1 run replicated
(multigrid.coarse_correction), then each device slices its rows from the
prolonged correction. Tiny hierarchies degenerate to a replicated dense
solve. Identical math to the single-device cycle — 1e-9 agreement
(tests/test_stokes_sharded.py MG tests, dryrun path 9).

ref Code/Compressible_euler/stokes.py (the workload); distribution story
analog: DOLFINx gives the reference MPI-for-free on every script, so the
rebuild's parity bar is "any workload, sharded".
Agreement with the single-device solver: 1e-9 over a full run
(tests/test_stokes_sharded.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh as DeviceMesh, NamedSharding, PartitionSpec as P

from conservation_fem_tpu.models.stokes import (
    StokesProblem,
    _phys_grads,
    host_coupling_coo,
)
from conservation_fem_tpu.ops import lattice as lat
from conservation_fem_tpu.ops.krylov import (
    bicgstab,
    bicgstab_fixed,
    cg,
    cg_fixed,
    jacobi_preconditioner,
)
from conservation_fem_tpu.ops.spmv import ell_diag


def _planes_rowmajor(offsets, planes, nrows_pad):
    """(P, nI, nJ) -> (nrows_pad, P, nJ) zero-padded, row-shardable."""
    planes = np.asarray(planes)
    Pn, nI, nJ = planes.shape
    out = np.zeros((nrows_pad, Pn, nJ), planes.dtype)
    out[:nI] = planes.transpose(1, 0, 2)
    return out


class ShardedStokes:
    """Build from a (problem, facet-data) pair; solve() matches the
    single-device API (dof vectors out)."""

    def __init__(self, p: StokesProblem, fd, device_mesh: DeviceMesh,
                 axis: str = "i"):
        self.p = p
        self.dmesh = device_mesh
        self.axis = axis
        cfg = p.cfg
        nx = cfg.nx
        self.nx = nx
        dtype = p.u0.dtype
        self.dtype = dtype
        n_dev = device_mesh.shape[axis]
        self.n_dev = n_dev

        nI1 = nx + 1
        nI2 = 2 * nx + 1
        self.nI1, self.nI2 = nI1, nI2
        self.nJ1, self.nJ2 = nI1, nI2
        L1 = -(-nI1 // n_dev)
        self.L1, self.L2 = L1, 2 * L1
        self.rows1 = n_dev * L1
        self.rows2 = n_dev * self.L2

        plan2 = lat.build_plan(np.asarray(p.vspace.dof_coords))
        plan1 = lat.build_plan(np.asarray(p.host_mesh.points))
        plan1e = lat.embed_plan(plan1, 2, nI2, self.nJ2)
        self.plan1, self.plan2 = plan1, plan2
        assert (plan2.nI, plan2.nJ) == (nI2, self.nJ2)

        # ---- host: assemble + convert all operators to padded planes ----
        sp, mp = p.sp, p.mp
        rho, mu, dt = cfg.rho, cfg.mu, p.dt
        eye = jnp.stack([jnp.stack([p.M2, jnp.zeros_like(p.M2)]),
                         jnp.stack([jnp.zeros_like(p.M2), p.M2])])
        A_blocks = np.asarray((rho / dt) * eye + 0.5 * p.visc
                              - 0.5 * mu * p.edge)
        R_blocks = np.asarray((rho / dt) * eye - 0.5 * p.visc
                              + 0.5 * mu * p.edge)

        def fine_planes(A):
            off, pl = lat.to_planes(plan2, np.asarray(sp.patch_cols), A)
            return off, _planes_rowmajor(off, pl, self.rows2)

        def coarse_planes(A):
            off, pl = lat.to_planes(plan1, np.asarray(mp.patch_cols), A)
            return off, _planes_rowmajor(off, pl, self.rows1)

        self.offA, A_pl = zip(*[fine_planes(A_blocks[s, d])
                                for s in range(2) for d in range(2)])
        self.offR, R_pl = zip(*[fine_planes(R_blocks[s, d])
                                for s in range(2) for d in range(2)])
        offM, M_pl = fine_planes(np.asarray(p.M2))
        self.offM = offM
        offK, K_pl = coarse_planes(np.asarray(p.K1))
        self.offK = offK

        coo = host_coupling_coo(p, fd)
        def pair_planes(tri, row_plan, col_plan):
            off, pl = lat.to_planes_coo(row_plan, col_plan, *tri)
            return off, _planes_rowmajor(off, pl, self.rows2)

        self.offDE, DE_pl = zip(*[pair_planes(coo["DE"][s], plan2, plan1e)
                                  for s in range(2)])
        self.offB, B_pl = zip(*[pair_planes(coo["B"][s], plan1e, plan2)
                                for s in range(2)])
        self.offG, G_pl = zip(*[pair_planes(coo["G"][s], plan2, plan1e)
                                for s in range(2)])

        # _pmv reads dynamic slices of a width-w halo'd grid; lax.dynamic_slice
        # CLAMPS out-of-range starts, so an offset beyond the halo would be
        # silently wrong rather than an error. Validate every plane family
        # against the halo width its matvec uses (fine w=2, coarse w=1).
        def _check_halo(offsets, w, name):
            m = max((max(abs(di), abs(dj)) for di, dj in offsets), default=0)
            if m > w:
                raise ValueError(
                    f"{name}: stencil offset {m} exceeds halo width {w}")
        for off in self.offA + self.offR:
            _check_halo(off, 2, "A/R")
        _check_halo(self.offM, 2, "M")
        _check_halo(self.offK, 1, "K")
        for nm in ("offDE", "offB", "offG"):
            for off in getattr(self, nm):
                _check_halo(off, 2, nm)

        # ---- masks / diagonals / convection tables ----------------------
        def pad1(x2, fill=0.0):
            return jnp.pad(jnp.asarray(x2), ((0, self.rows1 - nI1), (0, 0)),
                           constant_values=fill)

        def pad2(x2, fill=0.0):
            return jnp.pad(jnp.asarray(x2), ((0, self.rows2 - nI2), (0, 0)),
                           constant_values=fill)

        wallg = lat.to_grid(plan2, p.wall_mask)
        self.wall_s = pad2(wallg, True)                 # pad rows pinned
        pbcg = lat.to_grid(plan1, p.p_bc_mask)
        self.pbc_s = pad1(pbcg, True)
        self.pbcval_s = pad1(lat.to_grid(plan1, p.p_bc_val))

        diag1 = ((rho / dt) * ell_diag(sp, p.M2)
                 + 0.5 * ell_diag(sp, p.visc[0, 0])
                 - 0.5 * mu * ell_diag(sp, p.edge[0, 0]))
        self.diag1_s = pad2(lat.to_grid(plan2, diag1, fill=1.0), 1.0)
        self.diagK_s = pad1(lat.to_grid(plan1, ell_diag(mp, p.K1),
                                        fill=1.0), 1.0)
        self.diagM_s = pad2(lat.to_grid(plan2, ell_diag(sp, p.M2),
                                        fill=1.0), 1.0)

        # convection: per-type dof lattice offsets + constant phys grads
        vs = p.vspace
        cd = np.asarray(vs.cell_dofs)
        coords = np.asarray(vs.dof_coords)
        g_all = np.asarray(_phys_grads(sp))             # (M,Q,n,2)
        M_cells = cd.shape[0]
        half = M_cells // 2                             # lowers then uppers
        self.conv_off = []
        self.conv_g = []
        h_f = 1.0 / (2 * nx)
        for m_ex in (0, half):
            origin = coords[cd[m_ex]].min(axis=0)
            off = np.rint((coords[cd[m_ex]] - origin) / h_f).astype(int)
            self.conv_off.append([tuple(o) for o in off])
            self.conv_g.append(jnp.asarray(g_all[m_ex], dtype))
            # exemplar validity: same phys grads on a far cell of the type
            probe = m_ex + half - 1
            assert np.allclose(g_all[m_ex], g_all[probe]), \
                "structured-mesh cell-type assumption violated"
        self.phi_q = jnp.asarray(np.asarray(sp.phi), dtype)       # (Q,n)
        self.qw_q = jnp.asarray(np.asarray(sp.quad_w), dtype)
        self.area_c = float(np.asarray(sp.area)[0])

        # ---- device placement -------------------------------------------
        sh2 = NamedSharding(device_mesh, P(axis, None))
        sh3 = NamedSharding(device_mesh, P(axis, None, None))
        f = lambda a: jax.device_put(jnp.asarray(a, dtype), sh3)
        self.A_s = [f(a) for a in A_pl]
        self.R_s = [f(a) for a in R_pl]
        self.M_s = f(M_pl)
        self.K_s = f(K_pl)
        self.DE_s = [f(a) for a in DE_pl]
        self.B_s = [f(a) for a in B_pl]
        self.G_s = [f(a) for a in G_pl]
        put2 = lambda a: jax.device_put(a, sh2)
        for name in ("wall_s", "pbc_s", "pbcval_s", "diag1_s", "diagK_s",
                     "diagM_s"):
            setattr(self, name, put2(getattr(self, name)))
        self.sh2 = sh2

        # ---- geometric multigrid (cfg.multigrid): level-0 sharded, tail
        # replicated. The V-cycle's dominant cost is level-0 smoothing on
        # the fine grid — that runs on the local rows with the same halo
        # matvec as every other operator here. The post-smooth residual is
        # all_gather'd (a few MB at most, one gather per cycle), levels
        # >= 1 run replicated (ops/multigrid.coarse_correction), and each
        # device slices its rows from the prolonged correction. Same
        # hierarchy as the single-device build (models/stokes.py).
        self.mg = bool(getattr(cfg, "multigrid", False))
        self._mg1_n = self._mg2_n = 0
        self._mg1_args = self._mg2_args = ()
        if self.mg:
            from conservation_fem_tpu.ops import multigrid as mgrid

            self.mg1_static, mg1 = mgrid.build_mg(
                plan2, sp.patch_cols, sp.patch_mask,
                [[A_blocks[s, d] for d in range(2)] for s in range(2)],
                np.asarray(p.wall_mask), dtype=dtype)
            self.mg2_static, mg2 = mgrid.build_mg(
                plan1, mp.patch_cols, mp.patch_mask,
                [[np.asarray(p.K1)]], np.asarray(p.p_bc_mask), dtype=dtype)

            def shard_mg(static, arrs, rows, w, name):
                """Row-shard level 0; keep levels >= 1 + cinv replicated
                (closure constants). Returns (threaded-args, tail-arrs)."""
                if not static.shapes:            # dense-only degenerate
                    return (), arrs
                C = static.ncomp
                pl0 = []
                for s in range(C):
                    for d in range(C):
                        off = static.offsets[0][s][d]
                        assert off is not None, "MG level-0 zero block"
                        _check_halo(off, w, name)
                        pl0.append(f(_planes_rowmajor(
                            off, np.asarray(arrs["planes"][0][s][d]),
                            rows)))
                dinv0 = jnp.stack([
                    jnp.pad(arrs["dinv"][0][c],
                            ((0, rows - arrs["dinv"][0][c].shape[0]),
                             (0, 0)), constant_values=1.0)
                    for c in range(C)])
                dinv0 = jax.device_put(dinv0, NamedSharding(
                    device_mesh, P(None, axis, None)))
                tail = {"planes": [None] + list(arrs["planes"][1:]),
                        "dinv": [None] + list(arrs["dinv"][1:]),
                        "cinv": arrs["cinv"]}
                return (*pl0, dinv0), tail

            mg1_args, self._mg1_tail = shard_mg(
                self.mg1_static, mg1, self.rows2, 2, "mg1-level0")
            mg2_args, self._mg2_tail = shard_mg(
                self.mg2_static, mg2, self.rows1, 1, "mg2-level0")
            self._mg1_args, self._mg2_args = mg1_args, mg2_args
            self._mg1_n, self._mg2_n = len(mg1_args), len(mg2_args)

    # ---- local primitives (inside shard_map) ----------------------------

    def _halo(self, x, w, fill=0.0):
        ax, n = self.axis, self.n_dev
        if n == 1:
            pads = jnp.full((w, x.shape[1]), fill, x.dtype)
            return jnp.concatenate([pads, x, pads], axis=0)
        up = jax.lax.ppermute(x[-w:], ax, [(d, d + 1) for d in range(n - 1)])
        down = jax.lax.ppermute(x[:w], ax, [(d, d - 1) for d in range(1, n)])
        idx = jax.lax.axis_index(ax)
        up = jnp.where(idx == 0, fill, up)
        down = jnp.where(idx == n - 1, fill, down)
        return jnp.concatenate([up, x, down], axis=0)

    def _pmv(self, planes, offsets, x, w):
        """planes (L, P, nJ), x (L, nJ): lattice matvec with row halos."""
        L, nJ = x.shape
        xe = jnp.pad(self._halo(x, w), ((0, 0), (w, w)))
        out = jnp.zeros_like(x)
        for k, (di, dj) in enumerate(offsets):
            out = out + planes[:, k, :] * jax.lax.dynamic_slice(
                xe, (w + di, w + dj), (L, nJ))
        return out

    def _embed(self, pc):
        """coarse (L1, nJ1) -> fine (L2, nJ2) local block (aligned rows)."""
        out = jnp.zeros((self.L2, self.nJ2), pc.dtype)
        return out.at[0:2 * self.L1:2, 0:self.nJ2:2].set(pc)

    def _extract(self, xf):
        """fine (L2, nJ2) -> coarse (L1, nJ1) local block."""
        return xf[0:2 * self.L1:2, 0:self.nJ2:2]

    def _conv_rhs(self, u):
        """rho (u . grad u) . v on local cells: u (2, L2, nJ2)."""
        L1, nJ2, nx = self.L1, self.nJ2, self.nx
        # downward halo: cells in the last coarse row read 2 rows beyond
        xe = jnp.stack([
            jnp.concatenate([u[s], self._halo(u[s], 2)[-2:]], axis=0)
            for s in range(2)])                          # (2, L2+2, nJ2)
        idx = jax.lax.axis_index(self.axis)
        ci = idx * L1 + jnp.arange(L1)
        cell_valid = (ci < nx)[:, None]                  # (L1, 1)
        ncy = nx
        out = jnp.zeros((2, self.L2 + 2, nJ2), u.dtype)
        Q = self.phi_q.shape[0]
        for t in range(2):
            offs = self.conv_off[t]
            g = self.conv_g[t]                           # (Q, n, 2)
            uc = [xe[:, oi:oi + 2 * L1:2, oj:oj + 2 * ncy:2]
                  for (oi, oj) in offs]                  # each (2, L1, ncy)
            u_q = [sum(self.phi_q[q, a] * uc[a] for a in range(len(offs)))
                   for q in range(Q)]                    # (2, L1, ncy)
            gu = [[sum(g[q, a, d] * uc[a] for a in range(len(offs)))
                   for d in range(2)] for q in range(Q)]
            conv = [u_q[q][0] * gu[q][0] + u_q[q][1] * gu[q][1]
                    for q in range(Q)]                   # (2, L1, ncy)
            for a, (oi, oj) in enumerate(offs):
                val = (2.0 * self.area_c) * sum(
                    self.qw_q[q] * self.phi_q[q, a] * conv[q]
                    for q in range(Q))
                val = jnp.where(cell_valid[None], val, 0.0)
                out = out.at[:, oi:oi + 2 * L1:2, oj:oj + 2 * ncy:2].add(val)
        # ship the two overflow rows to the next device's first rows
        if self.n_dev > 1:
            ship = jax.lax.ppermute(
                out[:, -2:], self.axis,
                [(d, d + 1) for d in range(self.n_dev - 1)])
            idx = jax.lax.axis_index(self.axis)
            ship = jnp.where(idx == 0, 0.0, ship)
            out = out.at[:, :2].add(ship)
        return self.p.cfg.rho * out[:, :self.L2]

    def _pdot(self, a, b):
        return jax.lax.psum(jnp.vdot(a, b), self.axis)

    # ---- sharded multigrid preconditioners (inside shard_map) -----------

    def _mg_precond(self, static, tail, pl0, dinv0, w, nreal, L):
        """Local-rows V(nu,nu) preconditioner: r (C, L, nJ) -> e.

        Level-0 weighted-Jacobi smoothing runs on the local rows with
        halo matvecs; the coarse correction is computed replicated from
        the all_gather'd residual (ops/multigrid.coarse_correction) and
        sliced back to the local rows."""
        from conservation_fem_tpu.ops import multigrid as mgrid

        C = static.ncomp
        off0 = static.offsets[0]
        axis = self.axis
        rows = self.n_dev * L

        def blockmv(x):
            return jnp.stack([
                sum(self._pmv(pl0[s * C + d], off0[s][d], x[d], w)
                    for d in range(C))
                for s in range(C)])

        def pre(r):
            om = jnp.asarray(static.omega[0], r.dtype)
            x = om * dinv0 * r
            for _ in range(static.nu - 1):
                x = x + om * dinv0 * (r - blockmv(x))
            res = r - blockmv(x)
            full = jax.lax.all_gather(res, axis, axis=1,
                                      tiled=True)[:, :nreal]
            e = mgrid.coarse_correction(static, tail, full)
            e = jnp.pad(e, ((0, 0), (0, rows - nreal), (0, 0)))
            z = jnp.int32(0)
            row0 = jnp.int32(jax.lax.axis_index(axis) * L)
            x = x + jax.lax.dynamic_slice(
                e, (z, row0, z), (C, L, e.shape[2]))
            for _ in range(static.nu):
                x = x + om * dinv0 * (r - blockmv(x))
            return x

        return pre

    def _mg_dense(self, static, cinv, nreal, L):
        """Dense-only degenerate hierarchy (tiny grids, no stencil
        level): gather, one cinv matmul, slice local rows."""
        C = static.ncomp
        axis = self.axis
        rows = self.n_dev * L
        nI, nJ = static.coarse_shape

        def pre(r):
            full = jax.lax.all_gather(r, axis, axis=1,
                                      tiled=True)[:, :nreal]
            e = (cinv @ full.reshape(-1).astype(cinv.dtype)).reshape(
                C, nI, nJ).astype(r.dtype)
            e = jnp.pad(e, ((0, 0), (0, rows - nreal), (0, 0)))
            z = jnp.int32(0)
            row0 = jnp.int32(jax.lax.axis_index(axis) * L)
            return jax.lax.dynamic_slice(e, (z, row0, z), (C, L, nJ))

        return pre

    # ---- the SPMD step ---------------------------------------------------

    def make_step(self):
        cfg = self.p.cfg
        rho, dt = cfg.rho, self.p.dt
        rtol = cfg.krylov_rtol
        axis = self.axis

        # fixed-iteration throughput twins (cfg.krylov_iters), same as the
        # single-device make_step: psum dots ride through the custom `dot`;
        # unroll=False keeps the program small. The
        # pressure solve takes the nx-scaled count (models/stokes.auto_kip).
        from conservation_fem_tpu.models.stokes import auto_kip

        ki = cfg.krylov_iters
        kip = auto_kip(cfg)

        def _bicg(op, b, x0, precond, pdot):
            if ki is not None:
                return bicgstab_fixed(op, b, x0=x0, precond=precond,
                                      iters=ki, dot=pdot, unroll=False)
            return bicgstab(op, b, x0=x0, precond=precond, rtol=rtol,
                            dot=pdot)

        def _cg(op, b, x0, precond, pdot, mass=False, iters=None):
            it = iters if iters is not None else ki
            if it is not None:
                return cg_fixed(op, b, x0=x0, precond=precond,
                                iters=min(8, it) if mass else it,
                                dot=pdot, unroll=False)
            return cg(op, b, x0=x0, precond=precond, rtol=rtol, dot=pdot)

        def step_local(wall, pbc, pbcval, d1, dK, dM,
                       A_pl, R_pl, M_pl, K_pl, DE_pl, B_pl, G_pl,
                       u, pn, mg_args=(), mg_tails=()):
            pmv2 = lambda pl, off, x: self._pmv(pl, off, x, 2)
            pmv1 = lambda pl, off, x: self._pmv(pl, off, x, 1)
            pdot = self._pdot

            def blockmv(pls, offs, x):
                return jnp.stack([
                    pmv2(pls[0], offs[0], x[0]) + pmv2(pls[1], offs[1], x[1]),
                    pmv2(pls[2], offs[2], x[0]) + pmv2(pls[3], offs[3], x[1]),
                ])

            pe = self._embed(pn)
            # --- step 1: tentative velocity
            rhs = (blockmv(R_pl, self.offR, u) - self._conv_rhs(u)
                   + jnp.stack([pmv2(DE_pl[s], self.offDE[s], pe)
                                for s in range(2)]))
            rhs = jnp.where(wall[None], 0.0, rhs)

            def A1(x):
                x_in = jnp.where(wall[None], 0.0, x)
                y = blockmv(A_pl, self.offA, x_in)
                return jnp.where(wall[None], x, y)

            if self.mg:
                tail1 = mg_tails[0]
                if self._mg1_n:
                    pre1 = self._mg_precond(
                        self.mg1_static, tail1,
                        mg_args[:self._mg1_n - 1], mg_args[self._mg1_n - 1],
                        2, self.nI2, self.L2)
                else:
                    pre1 = self._mg_dense(self.mg1_static, tail1["cinv"],
                                          self.nI2, self.L2)
            else:
                pre1 = jacobi_preconditioner(
                    jnp.where(wall, 1.0, d1)[None]
                    * jnp.ones((2, 1, 1), u.dtype))
            u_star = _bicg(A1, rhs, u, pre1, pdot).x

            # --- step 2: pressure Poisson (coarse grid)
            div = sum(self._extract(pmv2(B_pl[s], self.offB[s], u_star[s]))
                      for s in range(2))
            b2 = pmv1(K_pl, self.offK, pn) - (rho / dt) * div
            g_ext = jnp.where(pbc, pbcval, 0.0)
            b2 = b2 - pmv1(K_pl, self.offK, g_ext)
            b2 = jnp.where(pbc, pbcval, b2)

            def A2(x):
                x_in = jnp.where(pbc, 0.0, x)
                return jnp.where(pbc, x, pmv1(K_pl, self.offK, x_in))

            if self.mg:
                tail2 = mg_tails[1]
                if self._mg2_n:
                    m2 = self._mg_precond(
                        self.mg2_static, tail2,
                        mg_args[self._mg1_n:-1], mg_args[-1],
                        1, self.nI1, self.L1)
                else:
                    m2 = self._mg_dense(self.mg2_static, tail2["cinv"],
                                        self.nI1, self.L1)
                pre2 = lambda r: m2(r[None])[0]
            else:
                pre2 = jacobi_preconditioner(jnp.where(pbc, 1.0, dK))
            p_new = _cg(A2, b2, pn, pre2, pdot, iters=kip).x

            # --- step 3: velocity correction
            dpe = self._embed(p_new - pn)
            b3 = (rho * jnp.stack([pmv2(M_pl, self.offM, u_star[s])
                                   for s in range(2)])
                  - dt * jnp.stack([pmv2(G_pl[s], self.offG[s], dpe)
                                    for s in range(2)]))

            def Mop(x):
                return rho * jnp.stack([pmv2(M_pl, self.offM, x[s])
                                        for s in range(2)])

            preM = jacobi_preconditioner(
                (rho * dM)[None] * jnp.ones((2, 1, 1), u.dtype))
            u_new = _cg(Mop, b3, u_star, preM, pdot, mass=True).x
            return u_new, p_new

        # ALL MG operands ride through the explicit arg list (closure
        # capture would bake them into the compiled program as constants):
        # per operator, level-0 (planes..., dinv0) row-sharded
        # (dinv stacked (C, rows, nJ) for BOTH hierarchies — the
        # pressure's C is just 1), then the replicated level>=1 tail
        # pytrees with an everywhere-P() spec.
        def mg_spec(nargs):
            if not nargs:
                return ()
            return ((P(axis, None, None),) * (nargs - 1)
                    + (P(None, axis, None),))

        mg_specs = mg_spec(self._mg1_n) + mg_spec(self._mg2_n)
        n_mg = self._mg1_n + self._mg2_n
        mg_tails = (self._mg1_tail, self._mg2_tail) if self.mg else ()
        tails_spec = jax.tree.map(lambda _: P(), mg_tails)

        @partial(
            shard_map, mesh=self.dmesh,
            in_specs=((P(axis, None),) * 6
                      + (P(axis, None, None),) * (4 + 4 + 1 + 1 + 2 + 2 + 2)
                      + mg_specs + (tails_spec,)
                      + (P(None, axis, None), P(axis, None))),
            out_specs=(P(None, axis, None), P(axis, None)),
        )
        def step(*args):
            wall, pbc, pbcval, d1, dK, dM = args[:6]
            ops = args[6:22]
            mg_args = args[22:22 + n_mg]
            tails = args[22 + n_mg]
            u, pn = args[23 + n_mg:]
            u_new, p_new = step_local(
                wall, pbc, pbcval, d1, dK, dM,
                ops[0:4], ops[4:8], ops[8], ops[9],
                ops[10:12], ops[12:14], ops[14:16],
                u, pn, mg_args, tails)
            return u_new, p_new

        def bound(u, pn):
            return step(self.wall_s, self.pbc_s, self.pbcval_s,
                        self.diag1_s, self.diagK_s, self.diagM_s,
                        *self.A_s, *self.R_s, self.M_s, self.K_s,
                        *self.DE_s, *self.B_s, *self.G_s,
                        *self._mg1_args, *self._mg2_args, mg_tails, u, pn)

        return bound

    # ---- public API ------------------------------------------------------

    def init_state(self):
        u0 = jnp.zeros((2, self.rows2, self.nJ2), self.dtype)
        p0 = jnp.zeros((self.rows1, self.nJ1), self.dtype)
        u0 = jax.device_put(u0, NamedSharding(
            self.dmesh, P(None, self.axis, None)))
        p0 = jax.device_put(p0, self.sh2)
        return u0, p0

    def solve(self, num_steps=None):
        # NOTE: the sharded statics are closure-captured by the jitted
        # runner — fine at test sizes; large grids should thread them
        # through as arguments (cf. the _jit_state pattern in
        # models/scalar_hyperbolic.py) to keep the program small.
        n = num_steps if num_steps is not None else self.p.cfg.num_steps
        step = self.make_step()

        @jax.jit
        def _run(u0, p0):
            def body(carry, _):
                u, pn = carry
                return step(u, pn), None

            (u, pn), _ = jax.lax.scan(body, (u0, p0), None, length=n)
            return u, pn

        u, pn = _run(*self.init_state())
        # back to dof vectors
        uh = np.asarray(u)[:, :self.nI2]
        ph = np.asarray(pn)[:self.nI1]
        u_dof = np.stack([
            uh[s].reshape(-1)[np.asarray(self.plan2.idx)] for s in range(2)])
        p_dof = ph.reshape(-1)[np.asarray(self.plan1.idx)]
        return u_dof, p_dof
