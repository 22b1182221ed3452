"""Higher-order (P1-P3) linear advection: degree x mesh sweeps with
GFEM / RV / SI stabilization — the unified driver the reference implements
as polynomial_alternation.py (STABILIZATION switch, :27,193-206), with the
degree-sweep harness of GFEM_pol.py:63-67, the P3 RV variant of
higher_order_RV.py (get_epsilon_linear_simple, :229) and the P2 paths of
RV_node.py:48 / higher_order_SI.py.

Reference semantics:
  * same CN forms as the P1 path, assembled in the Pk space;
  * BDF1 residual projection with bc for RV (ref polynomial_alternation.py
    :194-199, LinearProblem(..., bcs=[bc]));
  * RV variants: "rv" = patch epsilon (RV.get_epsilon_linear, RV.py:92-127),
    "rv_simple" = global normalization (RV.get_epsilon_linear_simple,
    RV.py:129-142, used for P3);
  * SI: stiffness assembled once with bc (ref smoothness.py:147-149);
  * GFEM_pol's final-step dt clamp (:199-200) is a no-op in the reference —
    the UFL forms were compiled with the original dt — so it is not
    reproduced here (documented deviation; both codes actually overshoot T).
  * error: L2 vs the Pk interpolant of the IC (ref GFEM_pol.py:234).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from conservation_fem_tpu.models.linear_advection import initial_condition, velocity
from conservation_fem_tpu.ops import assembly_pk as apk
from conservation_fem_tpu.ops import stabilization as stab
from conservation_fem_tpu.ops.krylov import (bicgstab, bicgstab_fixed, cg,
                                             cg_fixed, chebyshev_fixed,
                                             jacobi_preconditioner)
from conservation_fem_tpu.ops.mesh import Mesh, disk_mesh, rectangle_mesh
from conservation_fem_tpu.ops.spaces import build_space
from conservation_fem_tpu.ops.spmv import ell_diag, ell_matvec
from conservation_fem_tpu.ops.precision import einsum_exact as _einsum


@dataclasses.dataclass(frozen=True)
class HOAdvectionConfig:
    mesh_size: int = 16
    degree: int = 2
    domain: str = "disk"
    stabilization: str = "gfem"    # gfem | rv | rv_simple | si
    discontinuous_ic: bool = False  # ref GFEM_pol.py DISCONT flag (:26)
    CFL: float = 0.5
    T: float = 1.0
    Cvel: float = 0.25
    CRV: float = 1.0
    Cm: float = 0.5
    si_eps: float = 1e-8
    krylov_rtol: float = 1e-12
    # isoparametric (curved) disk boundary: project boundary dofs onto the
    # unit circle so P2/P3 rates are not capped by the polygonal boundary
    # (exceeds the reference, whose gmsh meshes are straight triangles)
    curved_boundary: bool = False
    # "blocked": blocked-window Pk backend (ops/blocked_pk.py) — RCM dof
    # permutation, window operators, componentwise per-step assembly
    # (solutions live in the permuted numbering; compare via
    # spaces.rcm_dof_permutation)
    ell_matvec_backend: str = "gather"
    # fixed-iteration solvers (throughput path; None = adaptive)
    cg_iters: int | None = None
    krylov_iters: int | None = None
    inner_solver: str = "bicgstab"
    cheby_mass_bounds: tuple | None = None   # default per degree in build()
    cheby_cn_bounds: tuple | None = None
    # blocked backend quality mode (f32 one-hots + HIGHEST dots) — on by
    # default for the advection family (long smooth transport; see
    # linear_advection.AdvectionConfig.blocked_precise)
    blocked_precise: bool = True
    dtype: str = "float64"


def ic_discontinuous(x, y, r0=0.25, x0=0.3, y0=0.0):
    """Indicator-disk IC (ref GFEM_pol.py:95-97)."""
    return ((x - x0) ** 2 + (y - y0) ** 2 <= r0**2).astype(x.dtype)


@dataclasses.dataclass(frozen=True)
class HOProblem:
    cfg: HOAdvectionConfig
    host_mesh: Mesh
    space: object          # host FunctionSpace
    dt: float
    num_steps: int
    sp: object             # SpaceArrays
    w: object
    M: object
    C: object
    h_cg: object
    K_bc: object
    u0: object
    # blocked backend: plan + window operators (data fields: the one-hot
    # buffers must ride through jit as arguments, cf. linear_advection)
    blkplan: object = None
    M_w: object = None
    C_w: object = None
    Kbc_w: object = None


jax.tree_util.register_dataclass(
    HOProblem,
    data_fields=["sp", "w", "M", "C", "h_cg", "K_bc", "u0",
                 "blkplan", "M_w", "C_w", "Kbc_w"],
    meta_fields=["cfg", "host_mesh", "space", "dt", "num_steps"],
)


def _ops_MC(p):
    if p.blkplan is not None:
        return p.M_w, p.C_w
    return p.M, p.C


def _linear_op(p, A):
    """(matvec, diag): ELL (n,K) or blocked window (blocks,nb,Wpad) form."""
    if A.ndim == 3:
        from conservation_fem_tpu.ops import blocked

        As = blocked.sweep_form(p.blkplan, A)   # bf16 sweep copy, cast once
        return (lambda x: blocked.spmv(p.blkplan, As, x),
                blocked.diag_of(p.blkplan, A))
    return (lambda x: ell_matvec(p.sp, A, x)), ell_diag(p.sp, A)


def get_nodal_h_pk(sp, M=None, rtol=1e-14):
    """DG0 min-edge h L2-projected into the Pk space (ref helpers.py:7-38
    with degree argument)."""
    b_loc = 2.0 * (sp.h_cell * sp.area)[:, None] * _einsum(
        "q,qa->a", sp.quad_w, sp.phi
    )[None]
    b = apk.scatter_vector(sp, b_loc)
    if M is None:
        M = apk.assemble_mass(sp)
    pre = jacobi_preconditioner(ell_diag(sp, M))
    return cg(lambda x: ell_matvec(sp, M, x), b, precond=pre, rtol=rtol).x


def _ell_with_bc(sp, A, bc):
    n = A.shape[0]
    bc_col = bc[sp.patch_cols]
    out = jnp.where(bc[:, None] | bc_col, 0.0, A)
    rows = jnp.arange(n)
    diag = out[rows, sp.diag_slot]
    return out.at[rows, sp.diag_slot].set(jnp.where(bc, 1.0, diag))


def build(cfg: HOAdvectionConfig | None = None, host_mesh: Mesh | None = None, **kw):
    if cfg is None:
        cfg = HOAdvectionConfig(**kw)
    hmax = 1.0 / cfg.mesh_size
    if host_mesh is None:
        host_mesh = disk_mesh(hmax) if cfg.domain == "disk" else rectangle_mesh(
            (0, 0), (1, 1), nx=cfg.mesh_size
        )
    projector = None
    if cfg.curved_boundary and cfg.domain == "disk":
        projector = lambda p: p / np.linalg.norm(p, axis=1, keepdims=True)
    space = build_space(host_mesh, cfg.degree, boundary_projector=projector)
    if cfg.ell_matvec_backend == "blocked":
        from conservation_fem_tpu.ops.spaces import (permute_dofs,
                                                     rcm_dof_permutation)

        space = permute_dofs(space, rcm_dof_permutation(space))
    dtype = jnp.dtype(cfg.dtype)
    sp = space.device_arrays(dtype)
    w = velocity(sp.dof_coords)
    w_inf = float(jnp.abs(w).sum(axis=1).max())   # reference matrix-inf quirk
    dt = cfg.CFL * hmax / w_inf
    num_steps = int(np.ceil(cfg.T / dt))
    M = apk.assemble_mass(sp)
    C = apk.assemble_convection(sp, w)
    h_cg = None
    if cfg.stabilization in ("rv", "rv_simple", "si"):
        h_cg = get_nodal_h_pk(sp, M)
    K_bc = None
    if cfg.stabilization == "si":
        K_bc = _ell_with_bc(sp, apk.assemble_stiffness(sp), sp.boundary_mask)
    icfn = ic_discontinuous if cfg.discontinuous_ic else initial_condition
    u0 = icfn(sp.dof_coords[:, 0], sp.dof_coords[:, 1]).astype(dtype)
    blkplan = M_w = C_w = Kbc_w = None
    if cfg.ell_matvec_backend == "blocked":
        from conservation_fem_tpu.ops import blocked
        from conservation_fem_tpu.ops import blocked_pk as bpk

        blkplan = bpk.make_blocked_pk_plan(space, dtype=dtype,
                                           precise=cfg.blocked_precise)
        M_w = blocked.assemble_matrix_components(
            blkplan, bpk.pk_mass_locals(blkplan, dtype))
        C_w = blocked.assemble_matrix_components(
            blkplan, bpk.pk_convection_locals(blkplan, w))
        if cfg.stabilization == "si":
            Kbc_w = blocked.apply_bc_matrix(
                blkplan, blocked.assemble_matrix_components(
                    blkplan, bpk.pk_stiffness_locals(blkplan, dtype)))
    return HOProblem(cfg, host_mesh, space, dt, num_steps, sp, w, M, C,
                     h_cg, K_bc, u0, blkplan, M_w, C_w, Kbc_w)


def _cn_solve(p: HOProblem, Keps, u_n):
    dt = p.dt
    bc = p.sp.boundary_mask
    M_op, C_op = _ops_MC(p)
    if Keps is None:
        A = M_op + 0.5 * dt * C_op
        B = M_op - 0.5 * dt * C_op
    else:
        A = M_op + 0.5 * dt * (C_op + Keps)
        B = M_op - 0.5 * dt * (C_op + Keps)
    A_mv, A_diag = _linear_op(p, A)
    B_mv, _ = _linear_op(p, B)
    b = jnp.where(bc, 0.0, B_mv(u_n))
    pre = jacobi_preconditioner(jnp.where(bc, 1.0, A_diag))
    op = lambda x: jnp.where(bc, x, A_mv(jnp.where(bc, 0.0, x)))
    cfg = p.cfg
    if cfg.krylov_iters is not None and cfg.inner_solver == "cheby":
        lo, hi = cfg.cheby_cn_bounds or _CN_BOUNDS[cfg.degree]
        return chebyshev_fixed(op, b, x0=u_n, precond=pre,
                               iters=cfg.krylov_iters, lmin=lo, lmax=hi).x
    if cfg.krylov_iters is not None:
        return bicgstab_fixed(op, b, x0=u_n, precond=pre,
                              iters=cfg.krylov_iters).x
    return bicgstab(op, b, x0=u_n, precond=pre, rtol=cfg.krylov_rtol).x


# Jacobi-preconditioned spectra widen with degree (measured on the mass
# matrix: P1 [.5,2], P2 [.39,2.06], P3 [.29,2.01]; the CN operator is a
# small dt-skew perturbation)
_MASS_BOUNDS = {1: (0.5, 2.0), 2: (0.35, 2.1), 3: (0.25, 2.1)}
_CN_BOUNDS = {1: (0.4, 2.2), 2: (0.3, 2.2), 3: (0.2, 2.2)}


def _residual(p: HOProblem, u_n, u_old):
    bc = p.sp.boundary_mask
    M_op, C_op = _ops_MC(p)
    M_mv, M_diag = _linear_op(p, M_op)
    C_mv, _ = _linear_op(p, C_op)
    rhs = M_mv((u_n - u_old) / p.dt) + C_mv(u_n)
    rhs = jnp.where(bc, 0.0, rhs)
    pre = jacobi_preconditioner(jnp.where(bc, 1.0, M_diag))
    op = lambda x: jnp.where(bc, x, M_mv(jnp.where(bc, 0.0, x)))
    cfg = p.cfg
    if cfg.cg_iters is not None and cfg.inner_solver == "cheby":
        lo, hi = cfg.cheby_mass_bounds or _MASS_BOUNDS[cfg.degree]
        return chebyshev_fixed(op, rhs, precond=pre, iters=cfg.cg_iters,
                               lmin=lo, lmax=hi).x
    if cfg.cg_iters is not None:
        return cg_fixed(op, rhs, precond=pre, iters=cfg.cg_iters).x
    return cg(op, rhs, precond=pre, rtol=cfg.krylov_rtol).x


def _step(p: HOProblem, carry, _):
    u_n, u_old = carry
    cfg = p.cfg
    if cfg.stabilization == "gfem":
        Keps = None
    else:
        if cfg.stabilization == "si":
            beta = jnp.linalg.norm(p.w, axis=1)
            if p.blkplan is not None:
                from conservation_fem_tpu.ops import blocked

                alpha = blocked.si_alpha(p.blkplan, p.Kbc_w, u_n,
                                         eps_floor=cfg.si_eps)
                eps = (stab.sigmoid_activation(alpha)
                       * cfg.Cm * p.h_cg * beta)
            else:
                eps = stab.si_epsilon(
                    p.sp, cfg.Cm, p.K_bc, u_n, beta, p.h_cg,
                    eps_floor=cfg.si_eps
                ).epsilon
        else:
            Rh = _residual(p, u_n, u_old)
            if cfg.stabilization == "rv":
                if p.blkplan is not None:
                    from conservation_fem_tpu.ops import blocked

                    eps = blocked.rv_epsilon_linear(
                        p.blkplan, cfg.Cvel, cfg.CRV, u_n, u_n,
                        jnp.linalg.norm(p.w, axis=1), Rh, p.h_cg)
                else:
                    eps = stab.rv_epsilon_linear(
                        p.sp, cfg.Cvel, cfg.CRV, u_n, u_n, p.w, Rh, p.h_cg
                    )
            else:  # rv_simple (ref RV.py:129-142)
                eps = stab.rv_epsilon_linear_simple(
                    cfg.Cvel, cfg.CRV, p.w, Rh, u_n, p.h_cg
                )
        if p.blkplan is not None:
            from conservation_fem_tpu.ops import blocked
            from conservation_fem_tpu.ops import blocked_pk as bpk

            Keps = blocked.assemble_matrix_components(
                p.blkplan, bpk.pk_eps_locals(p.blkplan, eps))
        else:
            Keps = apk.assemble_eps_stiffness(p.sp, eps)
    uh = _cn_solve(p, Keps, u_n)
    return (uh, u_n), None


@partial(jax.jit, static_argnums=0)
def _run(stab_name: str, p: HOProblem):
    bootstrap = stab_name in ("rv", "rv_simple")
    if bootstrap:
        (u1, _), _ = _step(
            dataclasses.replace(p, cfg=dataclasses.replace(p.cfg, stabilization="gfem")),
            (p.u0, p.u0), None,
        )
        carry, n = (u1, p.u0), p.num_steps - 1
    else:
        carry, n = (p.u0, p.u0), p.num_steps
    (u, _), _ = jax.lax.scan(partial(_step, p), carry, None, length=n)
    d = u - p.u0
    err = jnp.sqrt(d @ ell_matvec(p.sp, p.M, d))
    return u, err


def run(cfg: HOAdvectionConfig | None = None, **kw):
    if cfg is None:
        cfg = HOAdvectionConfig(**kw)
    p = build(cfg)
    u, err = _run(cfg.stabilization, p)
    return p, u, float(err)
