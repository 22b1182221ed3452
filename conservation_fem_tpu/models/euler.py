"""Compressible Euler equations: U_t + div F(U) = 0, U = (rho, m1, m2, E),
P1 group-FEM with residual-viscosity shock capturing, SSP-RK2 in time.

The reference's Euler path is an abandoned prototype — a 5-component
implicit Euler with a dead component, no BCs and no stabilization
(ref Code/Compressible_euler/euler_RV.py:22,37-46; LOG.md "gave up on
compressible euler"). The rebuild supplies the complete workload the
driver demands (BASELINE.json configs: "Sod shock tube + 2D Riemann
problem with RV shock capturing"):

  * conservative 4-component state; pressure p = (gamma-1)(E - |m|^2/(2 rho))
    (same EOS as the reference flux tensor, ref euler_RV.py:40-46).
  * group FEM: F_h = sum_j F(U_j) phi_j, so div-flux assembly is two ELL
    SpMVs per component against precomputed Cx, Cy — no quadrature in the
    hot loop (standard Guermond-Popov formulation).
  * RV from the density residual, beta = |u| + c (local wavespeed), via the
    same patch kernel family as the scalar workloads (ref RV.py:56-90).
  * SSP-RK2 with lumped mass; Dirichlet far-field (IC-valued) boundary.
  * problems: "sod" (strip, oracle = exact Riemann solution in
    utils/riemann_exact.py), "riemann2d" (4-quadrant config-3 four-shock),
    "uniform" (the reference prototype's constant-state IC,
    ref euler_RV.py:66-72 — stays exactly constant, used as a parity test).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from conservation_fem_tpu.ops import assembly
from conservation_fem_tpu.ops.helpers import get_nodal_h
from conservation_fem_tpu.ops.mesh import Mesh, rectangle_mesh
from conservation_fem_tpu.ops.spmv import ell_matvec
from conservation_fem_tpu.ops import stabilization as stab


@dataclasses.dataclass(frozen=True)
class EulerConfig:
    problem: str = "sod"          # sod | riemann2d | uniform
    nx: int = 100
    ny: int | None = None         # default: aspect-matched
    CFL: float = 0.25
    T: float | None = None        # None: problem default (sod 0.2, 2D 0.3)
    Cvel: float = 0.5
    # None resolves per problem in build(): 1.0 for sod/uniform (the
    # reference-prototype value) and 4.0 (the KPP value) for riemann2d —
    # our beyond-reference extension, where the default must be the
    # stable one: measured (f64), the config-3 four-shock interaction at
    # nx=128 develops negative pressures from t~0.11 and blows up at
    # t~0.19 with CRV=1 at ANY dt (a spatial viscosity-budget limit, not
    # CFL), while CRV=4 completes with worst p_min = +0.0075.
    CRV: float | None = None
    gamma: float = 1.4
    rho_floor: float = 1e-10
    rk_order: int = 2             # SSP-RK2 (default) or SSP-RK3
    dtype: str = "float64"
    record_metrics: bool = False
    backend: str = "auto"         # auto (stencil on structured) | ell


_PROBLEMS = {
    # problem: (p0, p1, T_default, aspect ny/nx)
    "sod": ((0.0, 0.0), (1.0, 0.25), 0.2, 0.25),
    "riemann2d": ((0.0, 0.0), (1.0, 1.0), 0.3, 1.0),
    "uniform": ((0.0, 0.0), (1.0, 1.0), 0.5, 1.0),
}


def primitive_to_conservative(rho, u1, u2, p, gamma, xp=jnp):
    E = p / (gamma - 1.0) + 0.5 * rho * (u1**2 + u2**2)
    return xp.stack([rho, rho * u1, rho * u2, E], axis=-1)


def initial_state(problem, x, y, gamma, xp=jnp):
    """xp=np evaluates on HOST at the input dtype — build() uses it with
    the f64 mesh points so dt/num_steps are dtype-invariant (an f32 run
    and its f64 anchor must integrate the same steps)."""
    if problem == "sod":
        left = x <= 0.5
        rho = xp.where(left, 1.0, 0.125)
        p = xp.where(left, 1.0, 0.1)
        return primitive_to_conservative(rho, 0.0 * x, 0.0 * x, p, gamma, xp)
    if problem == "riemann2d":
        # standard 2D Riemann configuration 3 (four shocks)
        q1 = (x > 0.5) & (y > 0.5)
        q2 = (x <= 0.5) & (y > 0.5)
        q3 = (x <= 0.5) & (y <= 0.5)
        rho = xp.select([q1, q2, q3], [1.5, 0.5323, 0.138], 0.5323)
        u1 = xp.select([q1, q2, q3], [0.0, 1.206, 1.206], 0.0)
        u2 = xp.select([q1, q2, q3], [0.0, 0.0, 1.206], 1.206)
        p = xp.select([q1, q2, q3], [1.5, 0.3, 0.029], 0.3)
        return primitive_to_conservative(rho, u1, u2, p, gamma, xp)
    if problem == "uniform":
        # ref euler_RV.py:66-72 (rho=1, m=(0.1,0), E=2.5)
        one = xp.ones_like(x)
        return xp.stack([one, 0.1 * one, 0.0 * one, 2.5 * one], axis=-1)
    raise ValueError(f"unknown problem {problem!r}")


class EulerProblem(NamedTuple):
    cfg: object
    host_mesh: object
    mesh: object
    Cx: object
    Cy: object
    ml: object            # lumped mass (N,)
    h_cg: object
    dt: float
    num_steps: int
    U0: object            # (N,4)
    bc_mask: object = None  # Dirichlet (frozen far-field) nodes
    sd: object = None     # StructuredData (stencil backend) or None
    Cx_c: object = None   # (7,n1x,n1y) stencil Cx
    Cy_c: object = None
    ml2: object = None    # lumped mass on the grid
    bc2: object = None    # grid form of bc_mask
    slip_mask: object = None   # y-wall nodes where m_y is zeroed (slip wall)
    slip2: object = None


def primitives(U, gamma, rho_floor):
    """Positivity-guarded primitives: density and pressure are floored
    (coarse-mesh undershoots near strong shocks would otherwise produce
    negative pressure; standard production-shock-code guard)."""
    rho = jnp.maximum(U[:, 0], rho_floor)
    u1 = U[:, 1] / rho
    u2 = U[:, 2] / rho
    p = (gamma - 1.0) * (U[:, 3] - 0.5 * rho * (u1**2 + u2**2))
    p = jnp.maximum(p, rho_floor)
    return rho, u1, u2, p


def flux(U, gamma, rho_floor):
    """(N,4) -> (Fx, Fy) each (N,4)."""
    rho, u1, u2, p = primitives(U, gamma, rho_floor)
    E = U[:, 3]
    Fx = jnp.stack([rho * u1, rho * u1**2 + p, rho * u1 * u2, (E + p) * u1], axis=1)
    Fy = jnp.stack([rho * u2, rho * u1 * u2, rho * u2**2 + p, (E + p) * u2], axis=1)
    return Fx, Fy


def wavespeed(U, gamma, rho_floor):
    rho, u1, u2, p = primitives(U, gamma, rho_floor)
    c = jnp.sqrt(gamma * jnp.maximum(p, 0.0) / rho)
    return jnp.sqrt(u1**2 + u2**2) + c


def build(cfg: EulerConfig | None = None, host_mesh: Mesh | None = None, **kw):
    if cfg is None:
        cfg = EulerConfig(**kw)
    if cfg.CRV is None:
        crv = 4.0 if cfg.problem == "riemann2d" else 1.0
        cfg = dataclasses.replace(cfg, CRV=crv)
    p0, p1, T_def, aspect = _PROBLEMS[cfg.problem]
    T = cfg.T if cfg.T is not None else T_def
    ny = cfg.ny if cfg.ny is not None else max(2, int(round(cfg.nx * aspect)))
    if host_mesh is None:
        host_mesh = rectangle_mesh(p0, p1, nx=cfg.nx, ny=ny)
    dtype = jnp.dtype(cfg.dtype)
    m = host_mesh.device_arrays(dtype)
    Cx, Cy = assembly.assemble_directional_convection(m)
    ml = assembly.lumped_mass(m)
    h_cg = get_nodal_h(m)
    U0 = initial_state(cfg.problem, m.points[:, 0], m.points[:, 1], cfg.gamma)
    U0 = U0.astype(dtype)
    # dt from a HOST-numpy f64 wavespeed on the f64 mesh points so
    # dt/num_steps are dtype-invariant: an f32-built bench and its
    # f64-built anchor must integrate the SAME steps (a ceil(T/dt) flip
    # from ~1e-7 wavespeed rounding would shift the end state by one dt
    # across moving shocks and trip the bench gate spuriously)
    pts = np.asarray(host_mesh.points, np.float64)
    U0h = initial_state(cfg.problem, pts[:, 0], pts[:, 1], cfg.gamma, xp=np)
    rho0 = np.maximum(U0h[:, 0], cfg.rho_floor)
    u10, u20 = U0h[:, 1] / rho0, U0h[:, 2] / rho0
    p_0 = np.maximum((cfg.gamma - 1.0) * (
        U0h[:, 3] - 0.5 * rho0 * (u10**2 + u20**2)), cfg.rho_floor)
    beta0 = np.sqrt(u10**2 + u20**2) + np.sqrt(cfg.gamma * p_0 / rho0)
    dt = cfg.CFL * float(host_mesh.hmin) / float(beta0.max())
    num_steps = int(np.ceil(T / dt))
    # Dirichlet far-field: for the quasi-1D Sod tube only the x-ends are
    # frozen (waves run in x; the y-walls carry v = 0 flow and stay free —
    # the strong-form div discretization has no wall flux term). The 2D
    # problems freeze the whole far-field boundary.
    slip_np = np.zeros(host_mesh.n_nodes, dtype=bool)
    if cfg.problem == "sod":
        x = np.asarray(host_mesh.points[:, 0])
        bc_np = host_mesh.boundary_mask & (
            np.isclose(x, p0[0]) | np.isclose(x, p1[0])
        )
        # slip walls: zero normal momentum on the y-walls (standard for the
        # quasi-1D tube; without it flow leaks through the free walls)
        slip_np = host_mesh.boundary_mask & ~bc_np
    else:
        bc_np = host_mesh.boundary_mask
    bc_mask = jnp.asarray(bc_np)
    slip_mask = jnp.asarray(slip_np)
    sd = Cx_c = Cy_c = ml2 = bc2 = None
    if cfg.backend == "auto":
        from conservation_fem_tpu.ops import structured as stn

        sd = stn.build_structured(host_mesh, cfg.nx, ny, dtype)
        Cx_c, Cy_c = stn.directional_convection_coefs(sd)
        ml2 = stn.lumped_mass_grid(sd)
        bc2 = jnp.asarray(bc_np.reshape(cfg.nx + 1, ny + 1))
        slip2 = jnp.asarray(slip_np.reshape(cfg.nx + 1, ny + 1))
    else:
        slip2 = None
    return EulerProblem(cfg, host_mesh, m, Cx, Cy, ml, h_cg, dt, num_steps, U0,
                        bc_mask, sd, Cx_c, Cy_c, ml2, bc2, slip_mask, slip2)


def _div_flux(p: EulerProblem, U):
    """(Cx Fx + Cy Fy) per component: (N,4)."""
    Fx, Fy = flux(U, p.cfg.gamma, p.cfg.rho_floor)
    div = jnp.stack(
        [
            ell_matvec(p.mesh, p.Cx, Fx[:, k]) + ell_matvec(p.mesh, p.Cy, Fy[:, k])
            for k in range(4)
        ],
        axis=1,
    )
    return div


def _rhs(p: EulerProblem, U, Keps):
    """L(U) = -ML^-1 [ div-flux + Keps U ] with far-field rows frozen."""
    visc = jnp.stack(
        [ell_matvec(p.mesh, Keps, U[:, k]) for k in range(4)], axis=1
    )
    dU = -(_div_flux(p, U) + visc) / p.ml[:, None]
    return jnp.where(p.bc_mask[:, None], 0.0, dU)


def step(p: EulerProblem, carry, _):
    U, U_old = carry
    cfg = p.cfg
    # density residual (BDF1) for RV
    rho_dot = (U[:, 0] - U_old[:, 0]) / p.dt
    div_m = (
        ell_matvec(p.mesh, p.Cx, U[:, 1]) + ell_matvec(p.mesh, p.Cy, U[:, 2])
    ) / p.ml
    R = rho_dot + div_m
    beta = wavespeed(U, cfg.gamma, cfg.rho_floor)
    eps = stab.rv_epsilon_system(
        p.mesh, cfg.Cvel, cfg.CRV, U[:, 0], beta, R, p.h_cg
    )
    Keps = assembly.assemble_eps_stiffness(p.mesh, eps)

    def slip(Uv):
        return Uv.at[:, 2].set(jnp.where(p.slip_mask, 0.0, Uv[:, 2]))

    # SSP-RK with slip-wall projection after each stage
    U1 = slip(U + p.dt * _rhs(p, U, Keps))
    if cfg.rk_order == 3:
        U2 = slip(0.75 * U + 0.25 * (U1 + p.dt * _rhs(p, U1, Keps)))
        Un = slip(U / 3.0 + 2.0 / 3.0 * (U2 + p.dt * _rhs(p, U2, Keps)))
    else:
        Un = slip(0.5 * U + 0.5 * (U1 + p.dt * _rhs(p, U1, Keps)))
    return (Un, U), None


# ---------------------------------------------------------------------------
# stencil (gather-free) step — identical math on (4, n1x, n1y) grids
# ---------------------------------------------------------------------------


def _step_structured(p: EulerProblem, carry, _):
    from conservation_fem_tpu.ops import structured as stn

    cfg = p.cfg
    sd = p.sd
    U, U_old = carry                                  # (4, n1x, n1y)
    flat = lambda G: jnp.moveaxis(G, 0, -1).reshape(-1, 4)
    grid = lambda V: jnp.moveaxis(V.reshape(sd.nx + 1, sd.ny + 1, 4), -1, 0)

    def div_flux(Ug):
        Fx, Fy = flux(flat(Ug), cfg.gamma, cfg.rho_floor)
        Fxg, Fyg = grid(Fx), grid(Fy)
        return jnp.stack([
            stn.matvec(sd, p.Cx_c, Fxg[k]) + stn.matvec(sd, p.Cy_c, Fyg[k])
            for k in range(4)
        ])

    def rhs(Ug, Kc):
        visc = jnp.stack([stn.matvec(sd, Kc, Ug[k]) for k in range(4)])
        dU = -(div_flux(Ug) + visc) / p.ml2[None]
        return jnp.where(p.bc2[None], 0.0, dU)

    rho_dot = (U[0] - U_old[0]) / p.dt
    div_m = (stn.matvec(sd, p.Cx_c, U[1]) + stn.matvec(sd, p.Cy_c, U[2])) / p.ml2
    R = rho_dot + div_m
    beta2 = wavespeed(flat(U), cfg.gamma, cfg.rho_floor).reshape(
        sd.nx + 1, sd.ny + 1
    )
    eps = stn.rv_epsilon_system_grid(sd, cfg.Cvel, cfg.CRV, U[0], R, beta2)
    Kc = stn.keps_coef(sd, eps)

    def slip(Ug):
        return Ug.at[2].set(jnp.where(p.slip2, 0.0, Ug[2]))

    U1 = slip(U + p.dt * rhs(U, Kc))
    if cfg.rk_order == 3:
        U2 = slip(0.75 * U + 0.25 * (U1 + p.dt * rhs(U1, Kc)))
        Un = slip(U / 3.0 + 2.0 / 3.0 * (U2 + p.dt * rhs(U2, Kc)))
    else:
        Un = slip(0.5 * U + 0.5 * (U1 + p.dt * rhs(U1, Kc)))
    return (Un, U), None


class EulerResult(NamedTuple):
    U: object
    dt: float
    num_steps: int


def solve(p: EulerProblem) -> EulerResult:
    if p.sd is not None:
        sd = p.sd

        @jax.jit
        def _run_st(U0):
            U0g = jnp.moveaxis(
                U0.reshape(sd.nx + 1, sd.ny + 1, 4), -1, 0
            )
            (U, _), _ = jax.lax.scan(
                lambda c, x: _step_structured(p, c, x), (U0g, U0g), None,
                length=p.num_steps,
            )
            return jnp.moveaxis(U, 0, -1).reshape(-1, 4)

        return EulerResult(_run_st(p.U0), p.dt, p.num_steps)

    @jax.jit
    def _run(U0):
        (U, _), _ = jax.lax.scan(
            lambda c, x: step(p, c, x), (U0, U0), None, length=p.num_steps
        )
        return U

    U = _run(p.U0)
    return EulerResult(U, p.dt, p.num_steps)


def run(cfg: EulerConfig | None = None, **kw) -> EulerResult:
    return solve(build(cfg, **kw))


def sod_density_error(p: EulerProblem, U, t):
    """L1 nodal error of rho vs the exact Riemann solution at time t."""
    from conservation_fem_tpu.utils.riemann_exact import sod_exact

    x = np.asarray(p.mesh.points[:, 0])
    rho_ex, _, _ = sod_exact(x, t)
    rho = np.asarray(U[:, 0])
    w = np.asarray(p.ml)
    return float(np.sum(np.abs(rho - rho_ex) * w) / np.sum(w) * 1.0)
