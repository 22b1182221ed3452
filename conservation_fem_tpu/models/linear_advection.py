"""Linear advection u_t + w . grad u = 0, solid-body rotation on the unit
disk (or a rectangle), Crank-Nicolson in time, P1 in space.

Rebuild of the reference workload family
Code/Linear_advection/ (SURVEY.md section 2.2):

  * gfem     — unstabilized Galerkin CN (ref linear_advection.py:112-182)
  * rv_node  — node-based residual viscosity (ref RV_node.py:206-255,
               RV_node_convergence.py; Cvel=0.25, CRV=1.0)
  * rv_cell  — cell-based residual viscosity (ref RV_cell.py:169-209;
               Cvel=0.25, CRV=1.0)
  * si       — smoothness-indicator viscosity (ref smoothness.py:147-168;
               Cm=0.5, stiffness assembled once WITH bcs)
  * rk4      — explicit RK4 with mass solves per stage (ref GFEM_RK4.py)

Reference semantics reproduced:
  * w = 2*pi*(-y, x); dt = CFL*hmax/||w||_inf where ||.||_inf is
    numpy.linalg.norm(w_values, ord=inf) on the (N,2) array = max row sum
    |wx|+|wy| (a reference quirk, ref linear_advection.py:74-75 — kept).
  * IC = 0.5*(1 - tanh(((x-0.3)^2 + y^2)/0.25^2 - 1)) (ref :53-54).
  * homogeneous Dirichlet bc on the whole boundary (ref :90-93).
  * num_steps = ceil(T/dt), no final-step clamping (ref :85).
  * stabilized runs bootstrap with ONE plain GFEM step so a BDF1 residual
    exists (ref RV_cell.py:142-160).
  * the BDF1 residual projection M Rh = M (u_n-u_old)/dt + C u_n is solved
    with the bc applied (LinearProblem(..., bcs=[bc]), ref RV_cell.py:171).
  * L2 error at T=1 is measured against the P1 interpolant of the IC
    (one full rotation returns the IC; ref RV_cell.py:243).

Everything per-step is jitted and driven by lax.scan; linear solves are
matrix-free BiCGStab/CG (the reference re-assembles + LU-factorizes every
step, ref RV_node.py:220-232 — here only the eps-weighted ELL values are
recomputed, structure and code are fixed).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from conservation_fem_tpu.ops import assembly
from conservation_fem_tpu.ops.bc import constrained_matvec, ell_with_bc
from conservation_fem_tpu.ops.helpers import get_nodal_h
from conservation_fem_tpu.ops.krylov import (bicgstab, bicgstab_fixed, cg,
                                             cg_fixed, chebyshev_fixed,
                                             jacobi_preconditioner)
from conservation_fem_tpu.ops.mesh import Mesh, MeshArrays, disk_mesh, rectangle_mesh
from conservation_fem_tpu.ops.spmv import ell_diag, ell_matvec
from conservation_fem_tpu.ops import stabilization as stab


@dataclasses.dataclass(frozen=True)
class AdvectionConfig:
    mesh_size: int = 32            # hmax = 1/mesh_size
    domain: str = "disk"           # "disk" | "square"
    stabilization: str = "gfem"    # gfem | rv_node | rv_node_simple
                                   #   | rv_cell | si | rk4
    CFL: float = 0.5               # ref linear_advection.py:81
    T: float = 1.0
    Cvel: float = 0.25             # ref RV_node.py:87
    CRV: float = 1.0               # ref RV_node.py:88
    Cm: float = 0.5                # ref smoothness.py:94
    si_eps: float = 1e-8           # denominator floor (ref SI.py:186)
    discontinuous_ic: bool = False  # indicator-disk IC (ref RV_cell.py:44-45)
    # rv_cell epsilon scatter: "last" = reference's last-cell-wins loop
    # order (ref RV_cell.py:193-195), "max" = order-independent variant
    # (what the distributed path uses)
    rv_cell_scatter: str = "last"
    # blocked backend: f32 one-hots + HIGHEST-precision contractions.
    # Default ON for advection: a full rotation is a long smooth-
    # transport horizon where bf16 operand streams diffuse the bump
    # (f32 one-hots stay near the f64 gather error; accuracy on the H100
    # not measured). Shock workloads keep bf16.
    blocked_precise: bool = True
    krylov_rtol: float = 1e-12
    # "banded": RCM-diagonal operator application (gather-free; requires an
    # RCM-ordered mesh — build with reorder_mesh(rcm_permutation(m)));
    # "blocked": blocked-window dense contractions (ops/blocked.py — for
    # the reference's unstructured gmsh meshes; build()
    # RCM-reorders the mesh automatically, so solutions live in RCM
    # numbering). rv_cell with blocked raises (its last-cell-wins scatter
    # is order-dependent; use gather or the distributed "max" variant).
    ell_matvec_backend: str = "gather"
    # fixed-iteration solvers (throughput path; None = adaptive to
    # krylov_rtol). cg_iters: the BDF1-residual mass solve;
    # krylov_iters: the CN solve. inner_solver="cheby" runs both as
    # dot-free Chebyshev semi-iterations (mass: Wathen [0.5,2] Jacobi
    # bounds; CN operator: cheby_cn_bounds — the advection CN matrix
    # M + dt/2 (C + Keps) is a small skew perturbation of M).
    cg_iters: int | None = None
    krylov_iters: int | None = None
    inner_solver: str = "bicgstab"
    cheby_mass_bounds: tuple = (0.5, 2.0)
    cheby_cn_bounds: tuple = (0.4, 2.2)
    dtype: str = "float64"


def initial_condition(x, y, r0=0.25, x0=0.3, y0=0.0):
    """Smooth bump IC (ref linear_advection.py:53-54)."""
    return 0.5 * (1.0 - jnp.tanh(((x - x0) ** 2 + (y - y0) ** 2) / r0**2 - 1.0))


def initial_condition_discont(x, y, r0=0.25, x0=0.3, y0=0.0):
    """Indicator-disk IC (ref RV_cell.py:44-45)."""
    return ((x - x0) ** 2 + (y - y0) ** 2 <= r0**2).astype(x.dtype)


def velocity(points):
    """Solid rotation w = 2*pi*(-y, x) (ref linear_advection.py:59-60)."""
    return 2.0 * jnp.pi * jnp.stack([-points[:, 1], points[:, 0]], axis=1)


@dataclasses.dataclass(frozen=True)
class AdvectionProblem:
    # static metadata (hashable; Mesh/BandedPlan hash by identity)
    cfg: AdvectionConfig
    host_mesh: Mesh
    dt: float
    num_steps: int
    bplan: object        # BandedPlan or None
    # dynamic arrays
    mesh: MeshArrays
    w: object            # (N,2)
    M: object            # ELL mass
    C: object            # ELL convection
    h_cg: object         # nodal h (rv/si variants) or None
    K_bc: object         # bc-applied ELL stiffness (si variant) or None
    u0: object           # (N,) initial condition
    # blocked backend (ell_matvec_backend="blocked"): window-form twins.
    # The plan is a DATA field (registered pytree) so its one-hot buffers
    # ride through jit as arguments, not compile-payload constants.
    blkplan: object = None
    M_w: object = None   # (blocks, nb, Wpad) mass windows
    C_w: object = None   # convection windows
    Kbc_w: object = None  # bc-applied stiffness windows (si)


jax.tree_util.register_dataclass(
    AdvectionProblem,
    data_fields=["mesh", "w", "M", "C", "h_cg", "K_bc", "u0",
                 "blkplan", "M_w", "C_w", "Kbc_w"],
    meta_fields=["cfg", "host_mesh", "dt", "num_steps", "bplan"],
)


def _linear_op(p, A):
    """(matvec, diag) honoring the configured application backend.
    A: ELL (n, K) or — blocked backend — window form (blocks, nb, Wpad)."""
    if A.ndim == 3:
        from conservation_fem_tpu.ops import blocked

        As = blocked.sweep_form(p.blkplan, A)   # bf16 sweep copy, cast once
        return (lambda x: blocked.spmv(p.blkplan, As, x),
                blocked.diag_of(p.blkplan, A))
    if p.bplan is not None:
        from conservation_fem_tpu.ops.banded import banded_matvec, ell_to_banded

        band = ell_to_banded(p.bplan, A)
        return (lambda x: banded_matvec(band, x)), band[p.bplan.bandwidth]
    return (lambda x: ell_matvec(p.mesh, A, x)), ell_diag(p.mesh, A)


def _ops_MC(p):
    """The (mass, convection) operators in the backend's fast form."""
    if p.blkplan is not None:
        return p.M_w, p.C_w
    return p.M, p.C


def _asm_keps(p, eps):
    """eps-weighted stiffness in the backend's operator form."""
    if p.blkplan is not None:
        from conservation_fem_tpu.ops import blocked

        return blocked.assemble_matrix_components(
            p.blkplan, blocked.eps_locals_components(p.blkplan, eps))
    return assembly.assemble_eps_stiffness(p.mesh, eps)


def build(cfg: AdvectionConfig, host_mesh: Mesh | None = None) -> AdvectionProblem:
    dtype = jnp.dtype(cfg.dtype)
    hmax = 1.0 / cfg.mesh_size
    if host_mesh is None:
        if cfg.domain == "disk":
            host_mesh = disk_mesh(hmax)
        elif cfg.domain == "square":
            host_mesh = rectangle_mesh((0, 0), (1, 1), nx=cfg.mesh_size)
        else:
            raise ValueError(f"unknown domain {cfg.domain!r}")
    if cfg.ell_matvec_backend == "blocked":
        if cfg.stabilization == "rv_cell" and cfg.rv_cell_scatter == "last":
            raise NotImplementedError(
                "rv_cell's last-cell-wins scatter is cell-order-dependent "
                "and has no window form; use rv_cell_scatter='max' (the "
                "order-independent variant the distributed path uses) or "
                "the gather backend")
        from conservation_fem_tpu.ops.mesh import (reorder_mesh,
                                                   rcm_permutation)

        host_mesh = reorder_mesh(host_mesh, rcm_permutation(host_mesh))
    m = host_mesh.device_arrays(dtype)
    w = velocity(m.points)
    # reference quirk: matrix inf-norm = max |wx_i| + |wy_i|
    w_inf = float(jnp.abs(w).sum(axis=1).max())
    dt = cfg.CFL * hmax / w_inf
    num_steps = int(np.ceil(cfg.T / dt))
    M = assembly.assemble_mass(m)
    C = assembly.assemble_convection(m, w)
    needs_h = cfg.stabilization in ("rv_node", "rv_node_simple", "rv_cell", "si")
    h_cg = get_nodal_h(m, mass_ell=M) if needs_h else None
    K_bc = None
    if cfg.stabilization == "si":
        K = assembly.assemble_stiffness(m)
        K_bc = ell_with_bc(m, K, m.boundary_mask)
    icfn = initial_condition_discont if cfg.discontinuous_ic else initial_condition
    u0 = icfn(m.points[:, 0], m.points[:, 1]).astype(dtype)
    bplan = None
    if cfg.ell_matvec_backend == "banded":
        from conservation_fem_tpu.ops.banded import make_banded_plan

        bplan = make_banded_plan(host_mesh)
    blkplan = M_w = C_w = Kbc_w = None
    if cfg.ell_matvec_backend == "blocked":
        from conservation_fem_tpu.ops import blocked

        blkplan = blocked.make_blocked_plan(host_mesh, dtype=dtype,
                                            precise=cfg.blocked_precise)
        area_f = blkplan.area_b.reshape(-1)
        grads_f = blkplan.grads_b.reshape(-1, 3, 2)
        rs = lambda L: L.reshape(blkplan.blocks, blkplan.C, 3, 3)
        M_w = blocked.assemble_matrix(blkplan, rs(assembly.local_mass(
            area_f)))
        wc = jnp.stack([blocked.gather_cells(blkplan, w[:, 0]),
                        blocked.gather_cells(blkplan, w[:, 1])],
                       axis=-1).reshape(-1, 3, 2)
        C_w = blocked.assemble_matrix(blkplan, rs(
            assembly.local_convection(area_f, grads_f, wc)))
        if cfg.stabilization == "si":
            Kbc_w = blocked.apply_bc_matrix(blkplan, blocked.assemble_matrix(
                blkplan, rs(assembly.local_stiffness(area_f, grads_f))))
    return AdvectionProblem(
        cfg=cfg, host_mesh=host_mesh, dt=dt, num_steps=num_steps, bplan=bplan,
        mesh=m, w=w, M=M, C=C, h_cg=h_cg, K_bc=K_bc, u0=u0,
        blkplan=blkplan, M_w=M_w, C_w=C_w, Kbc_w=Kbc_w,
    )


# ---------------------------------------------------------------------------
# step kernels
# ---------------------------------------------------------------------------


def _cn_solve(p: AdvectionProblem, Keps, u_n, rtol):
    """One Crank-Nicolson solve with optional eps-stiffness term:
    (M + dt/2 C + dt/2 Keps) u = (M - dt/2 C - dt/2 Keps) u_n, u|bc = 0."""
    m, dt = p.mesh, p.dt
    bc = m.boundary_mask
    M_op, C_op = _ops_MC(p)
    if Keps is None:
        A = M_op + 0.5 * dt * C_op
        B = M_op - 0.5 * dt * C_op
    else:
        A = M_op + 0.5 * dt * C_op + 0.5 * dt * Keps
        B = M_op - 0.5 * dt * C_op - 0.5 * dt * Keps
    A_mv, A_diag = _linear_op(p, A)
    B_mv, _ = _linear_op(p, B)
    b = jnp.where(bc, 0.0, B_mv(u_n))
    diag = jnp.where(bc, 1.0, A_diag)
    pre = jacobi_preconditioner(diag)
    op = lambda x: jnp.where(bc, x, A_mv(jnp.where(bc, 0.0, x)))
    ki = p.cfg.krylov_iters
    if ki is not None and p.cfg.inner_solver == "cheby":
        res = chebyshev_fixed(op, b, x0=u_n, precond=pre, iters=ki,
                              lmin=p.cfg.cheby_cn_bounds[0],
                              lmax=p.cfg.cheby_cn_bounds[1])
    elif ki is not None:
        res = bicgstab_fixed(op, b, x0=u_n, precond=pre, iters=ki)
    else:
        res = bicgstab(op, b, x0=u_n, precond=pre, rtol=rtol)
    return res.x, res


def _residual_bdf1(p: AdvectionProblem, u_n, u_old, rtol):
    """Solve M Rh = M (u_n - u_old)/dt + C u_n with Rh|bc = 0
    (ref RV_cell.py:169-174: LinearProblem(u v dx, ..., bcs=[bc]))."""
    m = p.mesh
    bc = m.boundary_mask
    M_op, C_op = _ops_MC(p)
    M_mv, M_diag = _linear_op(p, M_op)
    C_mv, _ = _linear_op(p, C_op)
    rhs = M_mv((u_n - u_old) / p.dt) + C_mv(u_n)
    rhs = jnp.where(bc, 0.0, rhs)
    diag = jnp.where(bc, 1.0, M_diag)
    op = lambda x: jnp.where(bc, x, M_mv(jnp.where(bc, 0.0, x)))
    pre = jacobi_preconditioner(diag)
    return _mass_solve(p, op, rhs, pre, rtol)


def _mass_solve(p, op, rhs, pre, rtol):
    ci = p.cfg.cg_iters
    if ci is not None and p.cfg.inner_solver == "cheby":
        return chebyshev_fixed(op, rhs, precond=pre, iters=ci,
                               lmin=p.cfg.cheby_mass_bounds[0],
                               lmax=p.cfg.cheby_mass_bounds[1]).x
    if ci is not None:
        return cg_fixed(op, rhs, precond=pre, iters=ci).x
    return cg(op, rhs, precond=pre, rtol=rtol).x


def _step_gfem(p: AdvectionProblem, carry, _):
    u_n, u_old = carry
    uh, _ = _cn_solve(p, None, u_n, p.cfg.krylov_rtol)
    return (uh, u_n), None


def _step_rv_node(p: AdvectionProblem, carry, _):
    u_n, u_old = carry
    cfg = p.cfg
    Rh = _residual_bdf1(p, u_n, u_old, cfg.krylov_rtol)
    if p.blkplan is not None:
        from conservation_fem_tpu.ops import blocked

        eps = blocked.rv_epsilon_linear(
            p.blkplan, cfg.Cvel, cfg.CRV, u_n, u_n,
            jnp.linalg.norm(p.w, axis=1), Rh, p.h_cg)
    else:
        eps = stab.rv_epsilon_linear(
            p.mesh, cfg.Cvel, cfg.CRV, u_n, u_n, p.w, Rh, p.h_cg
        )
    Keps = _asm_keps(p, eps)
    uh, _ = _cn_solve(p, Keps, u_n, cfg.krylov_rtol)
    return (uh, u_n), None


def _step_rv_cell(p: AdvectionProblem, carry, _):
    u_n, u_old = carry
    cfg = p.cfg
    m = p.mesh
    Rh = _residual_bdf1(p, u_n, u_old, cfg.krylov_rtol)
    # global normalization max(u_n - mean(u_n)) — plain max, not inf-norm
    # (ref RV_cell.py:175)
    Rh = Rh / (u_n - u_n.mean()).max()
    if p.blkplan is not None:
        from conservation_fem_tpu.ops import blocked

        plan = p.blkplan
        wn_cell = blocked.gather_components(
            plan, jnp.linalg.norm(p.w, axis=1)).max(axis=1)
        eps = blocked.rv_epsilon_cell_max(
            plan, cfg.Cvel, cfg.CRV, Rh, wn_cell, jnp.ones(plan.n, bool))
        Keps = _asm_keps(p, eps)
        uh, _ = _cn_solve(p, Keps, u_n, cfg.krylov_rtol)
        return (uh, u_n), None
    beta_cell = jnp.linalg.norm(p.w, axis=1)[m.cells].max(axis=1)   # (M,)
    # scatter="last" (default) reproduces the reference's Python cell loop
    # exactly (last cell wins, ref RV_cell.py:193-195); "max" is the
    # order-independent variant the distributed path uses
    # (parallel/unstructured_sharded.DistributedAdvection) — slightly more
    # diffusive at cell interfaces.
    eps = stab.rv_epsilon_cell(m, cfg.Cvel, cfg.CRV, Rh, beta_cell,
                               m.h_cell, scatter=cfg.rv_cell_scatter)
    Keps = assembly.assemble_eps_stiffness(m, eps)
    uh, _ = _cn_solve(p, Keps, u_n, cfg.krylov_rtol)
    return (uh, u_n), None


def _residual_bdf1_nobc(p: AdvectionProblem, u_n, u_old, rtol):
    """Unconstrained BDF1 residual projection: M Rh = M (u_n - u_old)/dt
    + C u_n with NO boundary conditions on the mass solve. This is the
    variant that produced the reference's stored Data/RV/RV_node.h5 series
    (verified: teacher-forced per-step parity 2e-14 at every k; the current
    RV_node.py source applies bcs to this solve, ref RV_node.py:215, which
    does NOT reproduce the stored data — provenance established in round 2)."""
    m = p.mesh
    M_op, C_op = _ops_MC(p)
    M_mv, M_diag = _linear_op(p, M_op)
    C_mv, _ = _linear_op(p, C_op)
    rhs = M_mv((u_n - u_old) / p.dt) + C_mv(u_n)
    return _mass_solve(p, M_mv, rhs, jacobi_preconditioner(M_diag), rtol)


def _step_rv_node_simple(p: AdvectionProblem, carry, _):
    """Node RV with the globally-normalized simple epsilon and the
    unconstrained residual projection — exact producer of the stored
    reference series Data/RV/RV_node.h5 (full-trajectory Linf parity
    8e-13 over all 285 steps; see tests/test_golden_parity.py)."""
    u_n, u_old = carry
    cfg = p.cfg
    Rh = _residual_bdf1_nobc(p, u_n, u_old, cfg.krylov_rtol)
    eps = stab.rv_epsilon_linear_simple(cfg.Cvel, cfg.CRV, p.w, Rh, u_n, p.h_cg)
    Keps = _asm_keps(p, eps)
    uh, _ = _cn_solve(p, Keps, u_n, cfg.krylov_rtol)
    return (uh, u_n), None


def _step_si(p: AdvectionProblem, carry, _):
    u_n, u_old = carry
    cfg = p.cfg
    beta = jnp.linalg.norm(p.w, axis=1)
    if p.blkplan is not None:
        from conservation_fem_tpu.ops import blocked

        alpha = blocked.si_alpha(p.blkplan, p.Kbc_w, u_n,
                                 eps_floor=cfg.si_eps)
        eps = stab.sigmoid_activation(alpha) * cfg.Cm * p.h_cg * beta
    else:
        eps = stab.si_epsilon(
            p.mesh, cfg.Cm, p.K_bc, u_n, beta, p.h_cg, eps_floor=cfg.si_eps
        ).epsilon
    Keps = _asm_keps(p, eps)
    uh, _ = _cn_solve(p, Keps, u_n, cfg.krylov_rtol)
    return (uh, u_n), None


def _step_rk4(p: AdvectionProblem, carry, _):
    """Explicit RK4: each stage solves M k = -C u_stage with k|bc = 0
    (ref GFEM_RK4.py:134-218)."""
    u_n, u_old = carry
    m = p.mesh
    bc = m.boundary_mask
    M_op, C_op = _ops_MC(p)
    M_mv, M_diag = _linear_op(p, M_op)
    C_mv, _ = _linear_op(p, C_op)
    diag = jnp.where(bc, 1.0, M_diag)
    pre = jacobi_preconditioner(diag)
    op = lambda x: jnp.where(bc, x, M_mv(jnp.where(bc, 0.0, x)))

    def rhs_stage(u):
        r = -C_mv(u)
        return jnp.where(bc, 0.0, r)

    stage = lambda r: _mass_solve(p, op, r, pre, p.cfg.krylov_rtol)
    k1 = stage(rhs_stage(u_n))
    k2 = stage(rhs_stage(u_n + 0.5 * p.dt * k1))
    k3 = stage(rhs_stage(u_n + 0.5 * p.dt * k2))
    k4 = stage(rhs_stage(u_n + p.dt * k3))
    uh = u_n + p.dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
    uh = jnp.where(bc, 0.0, uh)
    return (uh, u_n), None


_STEPS = {
    "gfem": _step_gfem,
    "rv_node": _step_rv_node,
    "rv_node_simple": _step_rv_node_simple,
    "rv_cell": _step_rv_cell,
    "si": _step_si,
    "rk4": _step_rk4,
}


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------


class SolveResult(NamedTuple):
    u: object
    error_l2: object
    dt: float
    num_steps: int


@partial(jax.jit, static_argnums=0)
def _run_scan(step_name: str, p: AdvectionProblem):
    step = _STEPS[step_name]
    bootstrap = step_name in ("rv_node", "rv_node_simple", "rv_cell")
    u0 = p.u0
    if bootstrap:
        # one plain GFEM step to seed the BDF1 history (ref RV_cell.py:142-160)
        (u1, _), _ = _step_gfem(p, (u0, u0), None)
        carry, n = (u1, u0), p.num_steps - 1
    else:
        carry, n = (u0, u0), p.num_steps
    (u, u_prev), _ = jax.lax.scan(partial(step, p), carry, None, length=n)
    # L2 error vs P1 interpolant of the IC (exact for P1 via mass matrix)
    d = u - p.u0
    err = jnp.sqrt(d @ ell_matvec(p.mesh, p.M, d))
    return u, err


def solve(p: AdvectionProblem) -> SolveResult:
    u, err = _run_scan(p.cfg.stabilization, p)
    return SolveResult(u, err, p.dt, p.num_steps)


def run(cfg: AdvectionConfig | None = None, **kw) -> SolveResult:
    """Convenience: build + solve (the 'python linear_advection.py' analog)."""
    if cfg is None:
        cfg = AdvectionConfig(**kw)
    return solve(build(cfg))
