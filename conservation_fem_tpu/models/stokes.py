"""Incompressible Navier-Stokes via Chorin/IPCS splitting, P2-P1
Taylor-Hood, pressure-driven Poiseuille channel flow.

Rebuild of Code/Compressible_euler/stokes.py:
  * unit square 10x10 (:15), dt = T/num_steps = 0.02, T = 10 (:16-19);
  * vector P2 velocity / P1 pressure (:22-25);
  * bcs: no-slip on walls y=0,1 (:32-37), pressure 8 at inflow x=0 and 0 at
    outflow x=1 (:39-51);
  * step 1 tentative velocity (:76-82): rho (u-u_n)/k . v + rho (u_n.grad u_n).v
    + sigma((u+u_n)/2, p_n):eps(v) + boundary terms
    int p_n n.v ds - int mu grad(U) n . v ds;
  * step 2 pressure Poisson (:90-94): grad p.grad q = grad p_n.grad q
    - (rho/k) div(u*) q with pressure bcs;
  * step 3 velocity correction (:98-102): rho u.v = rho u*.v - k grad(p*-p_n).v;
  * oracle: exact Poiseuille u = (4 y (1-y), 0), L2 error checked every 20
    steps (:135-144,186-190).

Solvers: the reference uses BCGS+AMG / CG+SOR (:104-125); here BiCGStab/CG
with Jacobi to tight tolerance. Per-step work is pure SpMV + two small
quadrature RHS terms, jitted in one lax.scan.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from conservation_fem_tpu.ops import assembly, assembly_pk as apk
from conservation_fem_tpu.ops.facets import boundary_facet_data
from conservation_fem_tpu.ops.krylov import (
    bicgstab,
    bicgstab_fixed,
    cg,
    cg_fixed,
    jacobi_preconditioner,
)
from conservation_fem_tpu.ops.mesh import Mesh, rectangle_mesh
from conservation_fem_tpu.ops.spaces import build_space
from conservation_fem_tpu.ops.spmv import ell_diag, ell_matvec
from conservation_fem_tpu.ops.precision import einsum_exact as _einsum


@dataclasses.dataclass(frozen=True)
class StokesConfig:
    nx: int = 10                  # ref stokes.py:15
    T: float = 10.0
    num_steps: int = 500
    mu: float = 1.0
    rho: float = 1.0
    p_in: float = 8.0             # ref :43
    p_out: float = 0.0
    krylov_rtol: float = 1e-11
    dtype: str = "float64"
    # "ell": generic gather SpMV; "lattice": grid-space Krylov with the
    # generalized lattice-stencil operators (ops/lattice.py) — gather-free
    # SpMV on the P2 (velocity) and P1 (pressure) lattices — but the
    # per-step RHS terms still ride ELL gathers; "grid": the FULLY
    # gather-free step (parallel/stokes_sharded.py on a 1-device mesh —
    # R-plane blockmv rhs, strided-slice convection quadrature, COO-plane
    # couplings; the gather RHS terms are a solve-independent per-step
    # floor on the other backends, not measured on the H100).
    # Identity: tests/test_stokes.py ("lattice"), tests/test_stokes_sharded
    # ("grid" == sharded n=1 == lattice at 1e-9 f64).
    backend: str = "ell"
    # fixed-iteration Krylov solves (throughput path: no data-dependent
    # loop exit): iterations for the momentum BiCGStab / pressure
    # CG; the velocity-mass CG always converges in a few iterations and
    # uses min(8, krylov_iters). None = adaptive to krylov_rtol.
    krylov_iters: int | None = None
    # pressure-Poisson iteration override: its Jacobi-CG condition grows
    # ~1/h^2, so ki that converges at nx 32 under-converges at 64+
    # (measured Linf vs adaptive: 3e-2 at nx32/ki25 but 6e-1 at nx64).
    # None = auto-scale with nx (auto_kip) whenever krylov_iters is set.
    krylov_iters_pressure: int | None = None
    # Geometric-multigrid preconditioning for the lattice backend
    # (ops/multigrid.py): V(2,2) Galerkin cycles on both the 2x2 momentum
    # block and the pressure Poisson make the Krylov iteration counts
    # resolution-INDEPENDENT (auto_kip stops scaling with nx; set
    # krylov_iters ~ 4-6 for the fixed path, see calibrate_stokes_ki.py).
    multigrid: bool = False


def auto_kip(cfg: "StokesConfig") -> int | None:
    """Fixed pressure-Poisson CG iteration count, scaled with nx.

    kappa(Jacobi-CG on the P1 Poisson) ~ 1/h^2 -> iterations to a fixed
    tolerance ~ sqrt(kappa) ~ nx. Calibrated on CPU f64 over the full
    500-step Poiseuille run (scripts/calibrate_stokes_ki.py) vs the
    adaptive 1e-11 solution: at nx 32, (ki=25, kip=2nx) -> Linf 5.0e-3;
    at nx 64, (ki=60, kip=3nx) -> Linf 6.8e-4 and (ki=40, kip=4nx) ->
    5.3e-3, while kip=25 diverges to 6.4e-1; at nx 128, (ki=128,
    kip=3nx=384) -> Linf 5.7e-5 and oracle L2 5.8e-6 vs the adaptive
    run's 5.2e-6 — the rule holds across a 4x size range. BOTH counts
    must scale (momentum kappa ~ 1 + dt*mu/h^2 too): set krylov_iters
    ~ nx and this default provides kip = 3*nx
    (scripts/calibrate_stokes_ki.py).
    """
    if cfg.krylov_iters_pressure is not None:
        return cfg.krylov_iters_pressure
    if cfg.krylov_iters is None:
        return None
    if cfg.multigrid:
        # MG-CG converges in ~7 iterations at ANY nx (measured 7 at nx
        # 32/64/128 to rtol 1e-10, tests/test_multigrid.py) — the whole
        # point of the V-cycle; no resolution scaling needed.
        return max(cfg.krylov_iters, 6)
    return max(cfg.krylov_iters, 3 * cfg.nx)


class StokesProblem(NamedTuple):
    cfg: object
    host_mesh: object
    vspace: object                # host P2 FunctionSpace
    sp: object                    # P2 SpaceArrays (velocity components)
    mp: object                    # P1 MeshArrays (pressure)
    dt: float
    M2: object                    # P2 mass ELL
    visc: object                  # (2,2,N,K) viscous blocks (volume, mu incl.)
    edge: object                  # (2,2,N,K) edge-grad blocks (no mu)
    K1: object                    # P1 stiffness ELL
    wall_mask: object             # (N2,) velocity Dirichlet mask
    p_bc_mask: object             # (N1,)
    p_bc_val: object              # (N1,)
    u0: object                    # (2,N2)
    p0: object                    # (N1,)


def _phys_grads(sp):
    return _einsum("mde,qne->mqnd", sp.jinv_t, sp.dphi)


def _assemble_visc_blocks(sp, mu):
    """V[m][l]_ab = mu ( delta_ml grad phi_a . grad phi_b
                        + d_l phi_a d_m phi_b ), volume part of
    2 mu eps(u):eps(v)."""
    g = _phys_grads(sp)                                   # (M,Q,n,2)
    lap = _einsum("q,mqad,mqbd->mab", sp.quad_w, g, g)
    blocks = []
    for m in range(2):
        row = []
        for l in range(2):
            cross = _einsum("q,mqa,mqb->mab", sp.quad_w,
                               g[..., l], g[..., m])
            loc = mu * ((lap if m == l else 0.0) + cross)
            vals = 2.0 * sp.area[:, None, None] * loc
            row.append(apk.scatter_matrix(sp, vals))
        blocks.append(row)
    return jnp.stack([jnp.stack(r) for r in blocks])       # (2,2,N,K)


def _assemble_edge_blocks(space, sp, fd):
    """E[m][l]_ab = int_bnd phi_a d_m phi_b n_l ds (no mu factor)."""
    n2, K = sp.patch_cols.shape
    nloc = space.nloc
    dtype = sp.area.dtype
    cs = np.asarray(space.cell_slots)                     # host
    cd = np.asarray(space.cell_dofs)
    jinv_t = np.asarray(sp.jinv_t)
    out = np.zeros((2, 2, n2 * K))
    for e in range(len(fd.edge_cell)):
        c = fd.edge_cell[e]
        le = fd.local_edge[e]
        phi = fd.phi_edge[le]                             # (Q,nloc)
        dphi = fd.dphi_edge[le]                           # (Q,nloc,2)
        gphys = np.einsum("de,qne->qnd", jinv_t[c], dphi)  # (Q,nloc,2)
        # loc[m]_ab = len * sum_q w phi_a(q) d_m phi_b(q)
        loc = fd.length[e] * np.einsum("q,qa,qbm->mab", fd.w1d, phi, gphys)
        tgt = (cd[c][:, None] * K + cs[c]).reshape(-1)    # (nloc*nloc,)
        for m in range(2):
            for l in range(2):
                np.add.at(out[m, l], tgt, (loc[m] * fd.normal[e, l]).reshape(-1))
    return jnp.asarray(out.reshape(2, 2, n2, K), dtype=dtype)


def build(cfg: StokesConfig | None = None, host_mesh: Mesh | None = None, **kw):
    if cfg is None:
        cfg = StokesConfig(**kw)
    if host_mesh is None:
        host_mesh = rectangle_mesh((0, 0), (1, 1), nx=cfg.nx)
    dtype = jnp.dtype(cfg.dtype)
    vspace = build_space(host_mesh, 2)
    sp = vspace.device_arrays(dtype)
    mp = host_mesh.device_arrays(dtype)
    dt = cfg.T / cfg.num_steps
    M2 = apk.assemble_mass(sp)
    visc = _assemble_visc_blocks(sp, cfg.mu)
    fd = boundary_facet_data(vspace)
    edge = _assemble_edge_blocks(vspace, sp, fd)
    K1 = assembly.assemble_stiffness(mp)

    xy = np.asarray(vspace.dof_coords)
    wall = np.isclose(xy[:, 1], 0.0) | np.isclose(xy[:, 1], 1.0)
    pxy = host_mesh.points
    inflow = np.isclose(pxy[:, 0], 0.0)
    outflow = np.isclose(pxy[:, 0], 1.0)
    p_bc_mask = inflow | outflow
    p_bc_val = np.where(inflow, cfg.p_in, np.where(outflow, cfg.p_out, 0.0))

    n2 = vspace.ndof
    u0 = jnp.zeros((2, n2), dtype)
    p0 = jnp.zeros(host_mesh.n_nodes, dtype)
    # store edge data needed for the per-step pressure boundary term
    prob = StokesProblem(
        cfg, host_mesh, vspace, sp, mp, dt, M2, visc, edge, K1,
        jnp.asarray(wall), jnp.asarray(p_bc_mask),
        jnp.asarray(p_bc_val, dtype), u0, p0,
    )
    return prob, fd


def host_coupling_coo(p: StokesProblem, fd):
    """The four per-step LINEAR coupling terms as host-side COO matrices.

    The step's only nonlinear term is the convection RHS; everything else
    is a fixed linear operator that the per-step code re-quadratures each
    step (mirroring the reference's forms). Assembling them once enables
    lattice-plane application and — crucially — the distributed step
    (parallel/stokes_sharded.py): boundary-edge integrals become plain
    matrix entries, so the sharded path needs no facet communication.

    Returns dict with (rows, cols, vals) triplets per component s:
      DE[s]: (N2, N1) pressure_div - pressure_edge  (step-1 rhs term)
      B[s]:  (N1, N2) div_u                          (step-2 rhs term)
      G[s]:  (N2, N1) grad_p                         (step-3 rhs term)
    Identity with the quadrature functions is tested in test_stokes.py.
    """
    sp = p.sp
    cd = np.asarray(p.vspace.cell_dofs)                 # (M, nloc)
    cells = np.asarray(p.host_mesh.cells)               # (M, 3)
    area = np.asarray(sp.area)
    g = np.asarray(_phys_grads(sp))                     # (M,Q,n,2)
    qw = np.asarray(sp.quad_w)
    phi = np.asarray(sp.phi)                            # (Q,n)
    qp = np.asarray(sp.quad_pts)
    lam = np.stack([1 - qp[:, 0] - qp[:, 1], qp[:, 0], qp[:, 1]], 1)  # (Q,3)
    M, nloc = cd.shape

    rows_v = np.repeat(cd[:, :, None], 3, axis=2).ravel()     # (M*nloc*3,)
    cols_p = np.repeat(cells[:, None, :], nloc, axis=1).ravel()

    # D_s[dof_a, vert_c] = 2 area_m sum_q qw lam[q,c] g[m,q,a,s]
    Dv = 2.0 * area[:, None, None, None] * np.einsum(
        "q,qc,mqas->macs", qw, lam, g)                  # (M,nloc,3,2)

    # E_s[dof_a, vert_c] = len_e sum_q w1d lam_e[q,c] phi_e[q,a] n_s
    ec = np.asarray(fd.edge_cell)
    le = np.asarray(fd.local_edge)
    from conservation_fem_tpu.ops.facets import _GAUSS_X, _LOCAL_EDGES, _REF_VERTS

    lam_edges = []
    for (a, b) in _LOCAL_EDGES:
        pts = (_REF_VERTS[a][None] * (1 - _GAUSS_X[:, None])
               + _REF_VERTS[b][None] * _GAUSS_X[:, None])
        lam_edges.append(np.stack(
            [1 - pts[:, 0] - pts[:, 1], pts[:, 0], pts[:, 1]], axis=1))
    lam_e = np.stack(lam_edges)[le]                     # (nb,Q,3)
    phi_e = np.asarray(fd.phi_edge)[le]                 # (nb,Q,nloc)
    Ev = np.asarray(fd.length)[:, None, None, None] * np.einsum(
        "q,bqc,bqa,bs->bacs", np.asarray(fd.w1d), lam_e, phi_e,
        np.asarray(fd.normal))                          # (nb,nloc,3,2)
    rows_e = np.repeat(cd[ec][:, :, None], 3, axis=2).ravel()
    cols_e = np.repeat(cells[ec][:, None, :], nloc, axis=1).ravel()

    # B_s[vert_c, dof_a]: div kernel == D transposed entrywise
    # G_s[dof_a, vert_c] = (2 area_m sum_q qw phi[q,a]) grads1[m,c,s]
    grads1 = np.asarray(p.host_mesh.grads)              # (M,3,2)
    phi_int = 2.0 * area[:, None] * np.einsum("q,qa->a", qw, phi)[None]
    Gv = phi_int[:, :, None, None] * grads1[:, None, :, :]   # (M,nloc,3,2)

    out = {}
    for s in range(2):
        out.setdefault("DE", []).append((
            np.concatenate([rows_v, rows_e]),
            np.concatenate([cols_p, cols_e]),
            np.concatenate([Dv[..., s].ravel(), -Ev[..., s].ravel()])))
        out.setdefault("B", []).append(
            (cols_p, rows_v, Dv[..., s].ravel()))
        out.setdefault("G", []).append(
            (rows_v, cols_p, Gv[..., s].ravel()))
    return out


def _block_matvec(sp, blocks, x):
    """blocks (2,2,N,K), x (2,N) -> (2,N)."""
    return jnp.stack([
        ell_matvec(sp, blocks[0, 0], x[0]) + ell_matvec(sp, blocks[0, 1], x[1]),
        ell_matvec(sp, blocks[1, 0], x[0]) + ell_matvec(sp, blocks[1, 1], x[1]),
    ])


def step_buffers(p: StokesProblem, fd):
    """(aux, bufs): the step's LARGE device buffers as a jit-argument
    pytree plus static lattice metadata.

    Closure-captured operator buffers would be embedded in the XLA
    program as constants (cf. BlockedPlan's pytree registration,
    ops/blocked.py); threading them as arguments keeps the program
    small. ``aux`` carries the host-built lattice plans and static
    stencil offsets; ``bufs`` the ELL blocks, physical gradients, and
    lattice coefficient planes."""
    cfg = p.cfg
    sp = p.sp
    dt, mu, rho = p.dt, cfg.mu, cfg.rho
    bufs = {"M2": p.M2, "K1": p.K1, "visc": p.visc, "edge": p.edge,
            "g": _phys_grads(sp)}
    aux = {}
    if cfg.backend == "lattice":
        from conservation_fem_tpu.ops import lattice as lat

        A_blocks = np.asarray(
            (rho / dt) * np.stack([
                np.stack([np.asarray(p.M2), np.zeros_like(p.M2)]),
                np.stack([np.zeros_like(p.M2), np.asarray(p.M2)]),
            ]) + 0.5 * np.asarray(p.visc) - 0.5 * mu * np.asarray(p.edge))
        plan2 = lat.build_plan(np.asarray(p.vspace.dof_coords))
        plan1 = lat.build_plan(np.asarray(p.host_mesh.points))
        assert plan2.full and plan1.full   # P2/P1 on a rectangle mesh
        lop = [[lat.lattice_op(plan2, sp, A_blocks[s, d])
                for d in range(2)] for s in range(2)]
        lK1 = lat.lattice_op(plan1, p.mp, np.asarray(p.K1))
        lM2 = lat.lattice_op(plan2, sp, np.asarray(p.M2))
        aux["plan2"], aux["plan1"] = plan2, plan1
        aux["lop_off"] = [[lop[s][d].offsets for d in range(2)]
                          for s in range(2)]
        aux["K1_off"], aux["M2_off"] = lK1.offsets, lM2.offsets
        bufs["lopP"] = [[lop[s][d].planes for d in range(2)]
                        for s in range(2)]
        bufs["K1P"], bufs["M2P"] = lK1.planes, lM2.planes
        if cfg.multigrid:
            from conservation_fem_tpu.ops import multigrid as mgrid

            dtype = jnp.asarray(p.M2).dtype
            aux["mg1_static"], bufs["mg1"] = mgrid.build_mg(
                plan2, sp.patch_cols, sp.patch_mask,
                [[A_blocks[s, d] for d in range(2)] for s in range(2)],
                np.asarray(p.wall_mask), dtype=dtype)
            aux["mg2_static"], bufs["mg2"] = mgrid.build_mg(
                plan1, p.mp.patch_cols, p.mp.patch_mask,
                [[np.asarray(p.K1)]], np.asarray(p.p_bc_mask), dtype=dtype)
    elif cfg.multigrid:
        raise NotImplementedError(
            "multigrid=True needs backend='lattice' or 'grid' (the V-cycle "
            "transfers are lattice-stencil ops; the gather-ELL backend keeps "
            "Jacobi-preconditioned Krylov)")
    return aux, bufs


def make_step(p: StokesProblem, fd, aux=None, bufs=None):
    """One IPCS step closure. With (aux, bufs) from step_buffers the big
    operator buffers are read from ``bufs`` — call inside jit with bufs
    as a traced argument to keep them out of the compile payload."""
    if bufs is None:
        aux, bufs = step_buffers(p, fd)
    cfg = p.cfg
    sp, mp = p.sp, p.mp
    dt, mu, rho = p.dt, cfg.mu, cfg.rho
    wall = p.wall_mask
    g = bufs["g"]
    M2, K1 = bufs["M2"], bufs["K1"]
    phi = sp.phi
    qw = sp.quad_w
    # P1 basis at the P2 quad points (barycentric coordinates)
    lam = jnp.stack(
        [1 - sp.quad_pts[:, 0] - sp.quad_pts[:, 1],
         sp.quad_pts[:, 0], sp.quad_pts[:, 1]], axis=1
    ).astype(sp.area.dtype)                                # (Q,3)

    # precomputed edge quantities for the pressure boundary RHS
    e_cells = jnp.asarray(fd.edge_cell, jnp.int32)
    e_len = jnp.asarray(fd.length, sp.area.dtype)
    e_norm = jnp.asarray(fd.normal, sp.area.dtype)
    e_phi = jnp.asarray(fd.phi_edge, sp.area.dtype)        # (3,Q,nloc)
    e_loc = jnp.asarray(fd.local_edge, jnp.int32)
    w1d = jnp.asarray(fd.w1d, sp.area.dtype)
    # P1 pressure values along each local edge at gauss pts: lambda on edge
    ref_edge_lam = []
    from conservation_fem_tpu.ops.facets import _GAUSS_X, _LOCAL_EDGES, _REF_VERTS

    for (a, b) in _LOCAL_EDGES:
        pts = (_REF_VERTS[a][None] * (1 - _GAUSS_X[:, None])
               + _REF_VERTS[b][None] * _GAUSS_X[:, None])
        ref_edge_lam.append(
            np.stack([1 - pts[:, 0] - pts[:, 1], pts[:, 0], pts[:, 1]], axis=1)
        )
    e_lam = jnp.asarray(np.stack(ref_edge_lam), sp.area.dtype)  # (3,Q,3)

    A_blocks = (rho / dt) * jnp.stack([
        jnp.stack([M2, jnp.zeros_like(M2)]),
        jnp.stack([jnp.zeros_like(M2), M2]),
    ]) + 0.5 * bufs["visc"] - 0.5 * mu * bufs["edge"]

    diag1 = jnp.where(
        wall, 1.0,
        (rho / dt) * ell_diag(sp, M2)
        + 0.5 * ell_diag(sp, bufs["visc"][0, 0])
        - 0.5 * mu * ell_diag(sp, bufs["edge"][0, 0]),
    )
    pre1 = jacobi_preconditioner(jnp.stack([diag1, diag1]).reshape(-1))

    def A1_op(xflat):
        x = xflat.reshape(2, -1)
        x_in = jnp.where(wall[None, :], 0.0, x)
        y = _block_matvec(sp, A_blocks, x_in)
        return jnp.where(wall[None, :], x, y).reshape(-1)

    K1_diag = jnp.where(p.p_bc_mask, 1.0, ell_diag(mp, K1))
    pre2 = jacobi_preconditioner(K1_diag)

    def A2_op(x):
        x_in = jnp.where(p.p_bc_mask, 0.0, x)
        y = ell_matvec(mp, K1, x_in)
        return jnp.where(p.p_bc_mask, x, y)

    M2_diag = ell_diag(sp, M2)

    def M_op(xflat):
        x = xflat.reshape(2, -1)
        return rho * jnp.stack([
            ell_matvec(sp, M2, x[0]), ell_matvec(sp, M2, x[1])
        ]).reshape(-1)

    preM = jacobi_preconditioner(
        rho * jnp.stack([M2_diag, M2_diag]).reshape(-1))

    # fixed-vs-adaptive Krylov (cfg.krylov_iters)
    ki = cfg.krylov_iters

    def _bicg(op, b, x0, precond):
        if ki is not None:
            # unroll=False: three ki-iteration solves per step fully
            # unrolled make a very large program; fori_loop compiles the
            # body once
            return bicgstab_fixed(op, b, x0=x0, precond=precond, iters=ki,
                                  unroll=False)
        return bicgstab(op, b, x0=x0, precond=precond, rtol=cfg.krylov_rtol)

    def _cg(op, b, x0, precond, mass=False, iters=None):
        it = iters if iters is not None else ki
        if it is not None:
            return cg_fixed(op, b, x0=x0, precond=precond,
                            iters=min(8, it) if mass else it, unroll=False)
        return cg(op, b, x0=x0, precond=precond, rtol=cfg.krylov_rtol)

    kip = auto_kip(cfg)

    # -- backend-selected Krylov drivers (dof-space vectors in and out) ------
    if cfg.backend == "lattice":
        from conservation_fem_tpu.ops import lattice as lat

        plan2, plan1 = aux["plan2"], aux["plan1"]
        lop = [[lat.LatticeOp(offsets=aux["lop_off"][s][d],
                              planes=bufs["lopP"][s][d])
                for d in range(2)] for s in range(2)]
        lK1 = lat.LatticeOp(offsets=aux["K1_off"], planes=bufs["K1P"])
        lM2 = lat.LatticeOp(offsets=aux["M2_off"], planes=bufs["M2P"])
        wg = lat.to_grid(plan2, wall)
        pbg = lat.to_grid(plan1, p.p_bc_mask)
        sh2 = (2, plan2.nI, plan2.nJ)
        pre1g = jacobi_preconditioner(jnp.stack(
            [lat.to_grid(plan2, diag1, fill=1.0)] * 2).reshape(-1))
        pre2g = jacobi_preconditioner(
            lat.to_grid(plan1, K1_diag, fill=1.0).reshape(-1))
        mdg = lat.to_grid(plan2, M2_diag, fill=1.0)
        preMg = jacobi_preconditioner(
            (rho * jnp.stack([mdg, mdg])).reshape(-1))
        if cfg.multigrid:
            from conservation_fem_tpu.ops import multigrid as mgrid

            # V(2,2) Galerkin cycles replace the Jacobi preconditioners:
            # iteration counts stop scaling with nx (auto_kip docstring)
            pre1g = mgrid.preconditioner(aux["mg1_static"], bufs["mg1"])
            pre2g = mgrid.preconditioner(aux["mg2_static"], bufs["mg2"])

        def _g2(x):
            return jnp.stack([lat.to_grid(plan2, x[0]),
                              lat.to_grid(plan2, x[1])])

        def _v2(y):
            return jnp.stack([lat.from_grid(plan2, y[0]),
                              lat.from_grid(plan2, y[1])])

        def A1g(xflat):
            x = xflat.reshape(sh2)
            x_in = jnp.where(wg[None], 0.0, x)
            y = jnp.stack([lop[0][0](x_in[0]) + lop[0][1](x_in[1]),
                           lop[1][0](x_in[0]) + lop[1][1](x_in[1])])
            return jnp.where(wg[None], x, y).reshape(-1)

        def A2g(xflat):
            x = xflat.reshape(plan1.nI, plan1.nJ)
            x_in = jnp.where(pbg, 0.0, x)
            return jnp.where(pbg, x, lK1(x_in)).reshape(-1)

        def Mg(xflat):
            x = xflat.reshape(sh2)
            return (rho * jnp.stack([lM2(x[0]), lM2(x[1])])).reshape(-1)

        def solve_momentum(rhs, x0):
            sol = _bicg(A1g, _g2(rhs).reshape(-1),
                        _g2(x0).reshape(-1), pre1g)
            return _v2(sol.x.reshape(sh2))

        def solve_pressure(b2, x0):
            sol = _cg(A2g, lat.to_grid(plan1, b2).reshape(-1),
                      lat.to_grid(plan1, x0).reshape(-1), pre2g, iters=kip)
            return lat.from_grid(plan1, sol.x.reshape(plan1.nI, plan1.nJ))

        def solve_mass(b3, x0):
            sol = _cg(Mg, _g2(b3).reshape(-1), _g2(x0).reshape(-1),
                      preMg, mass=True)
            return _v2(sol.x.reshape(sh2))
    else:
        def solve_momentum(rhs, x0):
            sol = _bicg(A1_op, rhs.reshape(-1), x0.reshape(-1), pre1)
            return sol.x.reshape(2, -1)

        def solve_pressure(b2, x0):
            return _cg(A2_op, b2, x0, pre2, iters=kip).x

        def solve_mass(b3, x0):
            return _cg(M_op, b3.reshape(-1), x0.reshape(-1), preM,
                       mass=True).x.reshape(2, -1)

    def conv_rhs(u):
        """rho (u . grad u) . v componentwise: (2,N)."""
        u_cell = u[:, sp.cell_dofs]                       # (2,M,n)
        u_q = _einsum("qc,smc->smq", phi, u_cell)      # (2,M,Q)
        gu = _einsum("smc,mqcd->smqd", u_cell, g)      # (2,M,Q,2) grad u_s
        conv = _einsum("dmq,smqd->smq",
                          jnp.stack([u_q[0], u_q[1]]), gu)
        vals = 2.0 * sp.area[None, :, None] * _einsum(
            "q,smq,qa->sma", qw, conv, phi
        )
        return rho * jnp.stack(
            [apk.scatter_vector(sp, vals[0]), apk.scatter_vector(sp, vals[1])]
        )

    def pressure_div_rhs(pn):
        """(D_m pn)_a = int pn d_m phi_a dx: (2,N)."""
        p_q = _einsum("qc,mc->mq", lam, pn[mp.cells])  # (M,Q)
        v0 = 2.0 * sp.area[:, None] * _einsum("q,mq,mqa->ma", qw, p_q, g[..., 0])
        v1 = 2.0 * sp.area[:, None] * _einsum("q,mq,mqa->ma", qw, p_q, g[..., 1])
        return jnp.stack(
            [apk.scatter_vector(sp, v0), apk.scatter_vector(sp, v1)]
        )

    def pressure_edge_rhs(pn):
        """int pn n . v ds: (2,N) scatter over boundary edges."""
        p_vert = pn[mp.cells[e_cells]]                    # (nb,3)
        lam_e = e_lam[e_loc]                              # (nb,Q,3)
        p_q = _einsum("bqc,bc->bq", lam_e, p_vert)     # (nb,Q)
        phi_e = e_phi[e_loc]                              # (nb,Q,nloc)
        base = e_len[:, None] * _einsum("q,bq,bqa->ba", w1d, p_q, phi_e)
        dofs = sp.cell_dofs[e_cells]                      # (nb,nloc)
        n2 = p.u0.shape[1]
        out0 = jnp.zeros(n2, sp.area.dtype).at[dofs.reshape(-1)].add(
            (base * e_norm[:, 0:1]).reshape(-1))
        out1 = jnp.zeros(n2, sp.area.dtype).at[dofs.reshape(-1)].add(
            (base * e_norm[:, 1:2]).reshape(-1))
        return jnp.stack([out0, out1])

    def div_u_rhs(u):
        """int q div(u) dx for P1 test q: (N1,)."""
        u_cell = u[:, sp.cell_dofs]
        div_q = (_einsum("mc,mqc->mq", u_cell[0], g[..., 0])
                 + _einsum("mc,mqc->mq", u_cell[1], g[..., 1]))
        vals = 2.0 * mp.area[:, None] * _einsum("q,mq,qc->mc", qw, div_q, lam)
        return assembly.scatter_vector(mp, vals)

    def grad_p_rhs(dp):
        """int phi_a d_m dp dx with dp P1 (const grad per cell): (2,N2)."""
        gp = _einsum("mc,mcd->md", dp[mp.cells], mp.grads)  # (M,2)
        phi_int = 2.0 * sp.area[:, None] * _einsum("q,qa->a", qw, phi)[None]
        v0 = phi_int * gp[:, 0:1]
        v1 = phi_int * gp[:, 1:2]
        return jnp.stack(
            [apk.scatter_vector(sp, v0), apk.scatter_vector(sp, v1)]
        )

    def step(carry, _):
        u_n, p_n = carry
        # --- step 1: tentative velocity
        rhs = (
            (rho / dt) * jnp.stack([
                ell_matvec(sp, M2, u_n[0]), ell_matvec(sp, M2, u_n[1])
            ])
            - conv_rhs(u_n)
            - 0.5 * _block_matvec(sp, bufs["visc"], u_n)
            + 0.5 * mu * _block_matvec(sp, bufs["edge"], u_n)
            + pressure_div_rhs(p_n)
            - pressure_edge_rhs(p_n)
        )
        rhs = jnp.where(wall[None, :], 0.0, rhs)
        u_star = solve_momentum(rhs, u_n)
        # --- step 2: pressure Poisson
        b2 = ell_matvec(mp, K1, p_n) - (rho / dt) * div_u_rhs(u_star)
        g_ext = jnp.where(p.p_bc_mask, p.p_bc_val, 0.0)
        b2 = b2 - ell_matvec(mp, K1, g_ext)
        b2 = jnp.where(p.p_bc_mask, p.p_bc_val, b2)
        p_new = solve_pressure(b2, p_n)
        # --- step 3: velocity correction
        b3 = rho * jnp.stack([
            ell_matvec(sp, M2, u_star[0]), ell_matvec(sp, M2, u_star[1])
        ]) - dt * grad_p_rhs(p_new - p_n)
        u_new = solve_mass(b3, u_star)
        return (u_new, p_new), None

    return step


class StokesResult(NamedTuple):
    u: object      # (2,N2)
    p: object      # (N1,)
    error_l2: float
    dt: float
    num_steps: int


def exact_velocity(sp):
    """Poiseuille u = (4 y (1-y), 0) (ref stokes.py:135-138)."""
    y = sp.dof_coords[:, 1]
    return jnp.stack([4.0 * y * (1.0 - y), jnp.zeros_like(y)])


def solve(prob_fd=None, cfg: StokesConfig | None = None, **kw) -> StokesResult:
    if prob_fd is None:
        prob_fd = build(cfg, **kw)
    p, fd = prob_fd
    if p.cfg.backend == "grid":
        return _solve_grid(p, fd)
    aux, bufs = step_buffers(p, fd)

    @jax.jit
    def _run(bufs, u0, p0):
        step = make_step(p, fd, aux=aux, bufs=bufs)
        (u, pr), _ = jax.lax.scan(step, (u0, p0), None, length=p.cfg.num_steps)
        return u, pr

    u, pr = _run(bufs, p.u0, p.p0)
    return _result(p, u, pr)


def _result(p, u, pr):
    u = jnp.asarray(u)
    pr = jnp.asarray(pr)
    u_ex = exact_velocity(p.sp)
    d = u - u_ex
    err = jnp.sqrt(
        d[0] @ ell_matvec(p.sp, p.M2, d[0]) + d[1] @ ell_matvec(p.sp, p.M2, d[1])
    )
    return StokesResult(u, pr, float(err), p.dt, p.cfg.num_steps)


def _solve_grid(p, fd) -> StokesResult:
    """backend="grid": the fully gather-free step — the grid-space SPMD
    formulation (parallel/stokes_sharded.py) on a 1-device mesh. Every
    RHS term rides lattice planes / strided slices instead of ELL
    gathers+scatters, a solve-independent per-step floor of the other
    backends (not measured on the H100)."""
    from conservation_fem_tpu.parallel.stokes_sharded import ShardedStokes

    dmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("i",))
    u, pr = ShardedStokes(p, fd, dmesh).solve()
    return _result(p, u, pr)
