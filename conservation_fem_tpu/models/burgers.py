"""2D Burgers equation u_t + u (u_x + u_y) = 0 on the unit square with the
exact 5-region Riemann solution as oracle and time-dependent Dirichlet bc.

Reference: Code/Burgers_equation/Exact_Burger_RV.py — structured triangle
mesh N in {50,100,200} (:26-28), flux f'(u) = (u,u) (:33-35), quadrant IC
(:70-80), exact solution in 5 x-bands (:37-66), exact solution imposed as
time-dependent bc (:171-176), dt = 0.5 * min(h_CG) (:105-108), T = 0.5,
Cvel = 0.5, CRV = 10 (:110-111). SI variant: Cm = 0.5 with post-solve
smoothing l=4 (ref Exact_Burger_SI.py:102,193). GFEM variant shows the
unstabilized blow-up behavior (ref Exact_Burger_GFEM.py).

The closed-form Riemann solution implemented here is the standard
Guermond–Popov 2D Burgers test (five x-bands; shocks and a rarefaction
fan); band ordering follows the reference so edge-of-band ties resolve
identically (later bands overwrite earlier ones).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from conservation_fem_tpu.models.scalar_hyperbolic import (
    HyperbolicConfig,
    HyperbolicProblem,
)
from conservation_fem_tpu.ops.helpers import get_nodal_h
from conservation_fem_tpu.ops.mesh import Mesh, rectangle_mesh
from conservation_fem_tpu.ops import assembly
from conservation_fem_tpu.ops.precision import einsum_exact as _einsum


@dataclasses.dataclass(frozen=True)
class BurgersConfig:
    mesh_size: int = 200           # ref Exact_Burger_RV.py:26
    stabilization: str = "rv"      # rv | si | gfem
    CFL: float = 0.5
    T: float = 0.5
    Cvel: float = 0.5              # ref :110
    CRV: float = 10.0              # ref :111
    Cm: float = 0.5                # ref Exact_Burger_SI.py:102
    smooth_l: float = 0.0          # SI runs use 4.0 (ref Exact_Burger_SI.py:193)
    newton_rtol: float = 1e-4
    krylov_rtol: float = 1e-12
    newton_linear_rtol: float | None = None
    modified_newton: bool = False
    dtype: str = "float64"
    record_metrics: bool = False
    backend: str = "auto"          # auto | stencil | ell
    ic: str = "riemann"            # riemann | bump (ref Burger_RV.py)
    residual_scheme: str = "bdf2"  # Burger_RV.py used bdf1 (:144)
    degree: int = 1                # 2 = higher_order_SI.py parity (P2)
    # ELL application backend: "gather" | "banded" | "lattice" (structured
    # rectangle meshes, any degree — ops/lattice.py planes)
    ell_matvec_backend: str = "gather"
    # fixed-iteration unrolled solvers (throughput paths; see KPPConfig)
    cg_iters: int | None = None
    newton_iters: int | None = None
    newton_linear_iters: int = 8
    # "cheby": dot-free inner solves (see HyperbolicConfig). Jacobi-mass
    # spectra widen with degree (measured: P1 [.5,2], P2 [.39,2.06],
    # P3 [.29,2.01]) — bounds default per degree in build()
    inner_solver: str = "bicgstab"
    newton_final_residual: bool = True  # see HyperbolicConfig
    cheby_mass_bounds: tuple | None = None
    cheby_lin_bounds: tuple | None = None


def initial_condition_bump(x, y):
    """Circular-bump IC of the Burger_RV.py variant (ref Burger_RV.py:31-53):
    smooth cosine bump centred in the square."""
    import jax.numpy as jnp

    r2 = (x - 0.3) ** 2 + (y - 0.3) ** 2
    r0 = 0.2
    return jnp.where(r2 <= r0**2, 0.5 * (1 + jnp.cos(jnp.pi * jnp.sqrt(r2) / r0)), 0.0)


def initial_condition(x, y):
    """Quadrant Riemann data (ref Exact_Burger_RV.py:70-80)."""
    u = jnp.zeros_like(x)
    u = jnp.where((x <= 0.5) & (y >= 0.5), -0.2, u)
    u = jnp.where((x > 0.5) & (y >= 0.5), -1.0, u)
    u = jnp.where((x <= 0.5) & (y < 0.5), 0.5, u)
    u = jnp.where((x > 0.5) & (y < 0.5), 0.8, u)
    return u


def exact_solution(x, y, t):
    """Closed-form 5-region solution (ref Exact_Burger_RV.py:37-66).

    Valid for t > 0; at t = 0 use initial_condition. Bands are applied in
    the reference's order so overlapping band edges resolve identically.
    """
    t = jnp.asarray(t, dtype=x.dtype)
    tsafe = jnp.where(t > 0, t, 1.0)  # guard divisions; masked out at t=0
    u = jnp.zeros_like(x)

    m1 = x <= 0.5 - 0.6 * t
    u = jnp.where(m1 & (y > 0.5 + 0.15 * t), -0.2, u)
    u = jnp.where(m1 & (y <= 0.5 + 0.15 * t), 0.5, u)

    m2 = (x >= 0.5 - 0.6 * t) & (x <= 0.5 - 0.25 * t)
    line2 = -8.0 * x / 7.0 + 15.0 / 14.0 - 15.0 * t / 28.0
    u = jnp.where(m2 & (y > line2), -1.0, u)
    u = jnp.where(m2 & (y <= line2), 0.5, u)

    m3 = (x >= 0.5 - 0.25 * t) & (x <= 0.5 + 0.5 * t)
    line3 = x / 6.0 + 5.0 / 12.0 - 5.0 * t / 24.0
    u = jnp.where(m3 & (y > line3), -1.0, u)
    u = jnp.where(m3 & (y <= line3), 0.5, u)

    m4 = (x >= 0.5 + 0.5 * t) & (x <= 0.5 + 0.8 * t)
    line4 = x - 5.0 / (18.0 * tsafe) * (x + t - 0.5) ** 2
    fan = (2.0 * x - 1.0) / (2.0 * tsafe)
    u = jnp.where(m4 & (y > line4), -1.0, u)
    u = jnp.where(m4 & (y <= line4), fan, u)

    m5 = x >= 0.5 + 0.8 * t
    u = jnp.where(m5 & (y > 0.5 - 0.1 * t), -1.0, u)
    u = jnp.where(m5 & (y <= 0.5 - 0.1 * t), 0.8, u)

    return jnp.where(t > 0, u, initial_condition(x, y))


def flux_prime(u):
    """f(u) = (u^2/2, u^2/2) => f'(u) = (u, u) (ref :33-35)."""
    return jnp.stack([u, u], axis=-1)


def flux_prime_norm(u):
    return jnp.sqrt(2.0) * jnp.abs(u)


# componentwise f' for the plane-form quadrature kernels (see models/kpp.py)
flux_prime_xy = (lambda u: u, lambda u: u)


def build(cfg: BurgersConfig | None = None, host_mesh: Mesh | None = None, **kw):
    if cfg is None:
        cfg = BurgersConfig(**kw)
    built_structured = host_mesh is None
    if host_mesh is None:
        host_mesh = rectangle_mesh((0, 0), (1, 1), nx=cfg.mesh_size)
    # dt = CFL * min(h_CG) where h_CG is the projected nodal h (ref :105-108)
    m = host_mesh.device_arrays(jnp.dtype(cfg.dtype))
    h_cg = get_nodal_h(m)
    dt = cfg.CFL * float(h_cg.min())
    if cfg.degree > 1:
        # ref higher_order_SI.py:104 — dt scaled by 1/degree^2
        dt = dt / cfg.degree**2
    num_steps = int(np.ceil(cfg.T / dt))
    hcfg = HyperbolicConfig(
        stabilization=cfg.stabilization,
        Cvel=cfg.Cvel, CRV=cfg.CRV, Cm=cfg.Cm, smooth_l=cfg.smooth_l,
        newton_rtol=cfg.newton_rtol, krylov_rtol=cfg.krylov_rtol,
        newton_linear_rtol=cfg.newton_linear_rtol,
        modified_newton=cfg.modified_newton,
        residual_scheme=cfg.residual_scheme,
        dtype=cfg.dtype, record_metrics=cfg.record_metrics,
        ell_matvec_backend=cfg.ell_matvec_backend,
        cg_iters=cfg.cg_iters, newton_iters=cfg.newton_iters,
        newton_linear_iters=cfg.newton_linear_iters,
        inner_solver=cfg.inner_solver,
        newton_final_residual=cfg.newton_final_residual,
        cheby_mass_bounds=(cfg.cheby_mass_bounds
                           or {1: (0.5, 2.0), 2: (0.35, 2.1),
                               3: (0.25, 2.1)}[cfg.degree]),
        cheby_lin_bounds=(cfg.cheby_lin_bounds
                          or {1: (0.4, 2.2), 2: (0.3, 2.2),
                              3: (0.2, 2.2)}[cfg.degree]),
    )
    bc_fn = (
        (lambda pts, t: exact_solution(pts[:, 0], pts[:, 1], t))
        if cfg.ic == "riemann"
        else (lambda pts, t: jnp.zeros(pts.shape[0], pts.dtype))
    )
    ic_fn = initial_condition if cfg.ic == "riemann" else initial_condition_bump
    if cfg.degree > 1:
        if cfg.ell_matvec_backend == "blocked":
            from conservation_fem_tpu.models.blocked_pk_hyperbolic import \
                BlockedPkHyperbolicProblem

            cls = BlockedPkHyperbolicProblem
        else:
            from conservation_fem_tpu.models.pk_hyperbolic import \
                PkHyperbolicProblem

            cls = PkHyperbolicProblem
        prob = cls(
            hcfg, host_mesh, cfg.degree,
            flux_prime=flux_prime, flux_prime_norm=flux_prime_norm,
            bc_value=bc_fn, u0_fn=ic_fn, dt=dt, num_steps=num_steps,
        )
        prob.flux_prime_xy = flux_prime_xy
        return prob
    prob = HyperbolicProblem(
        hcfg, host_mesh,
        flux_prime=flux_prime,
        flux_prime_norm=flux_prime_norm,
        bc_value=bc_fn,
        u0_fn=ic_fn,
        dt=dt,
        num_steps=num_steps,
    )
    prob.flux_prime_xy = flux_prime_xy
    use_stencil = (
        cfg.backend in ("auto", "stencil") and built_structured
        and cfg.stabilization in ("rv", "si", "gfem")
    )
    if cfg.backend == "ell":
        use_stencil = False
    if use_stencil:
        from conservation_fem_tpu.models.structured_hyperbolic import structure

        prob = structure(prob, cfg.mesh_size, cfg.mesh_size)
    return prob


def l2_error_vs_exact(problem: HyperbolicProblem, u, t):
    """L2 error against the exact solution interpolated into the trial
    space — matching assemble_scalar((uh - u_exact)**2 dx) with u_exact an
    interpolant (ref Exact_Burger_RV_conv.py:223). Works for P1 and Pk."""
    from conservation_fem_tpu.ops.spmv import ell_matvec

    m = problem.mesh
    pts = getattr(m, "points", None)
    if pts is None:           # Pk space: dofs at lattice coords
        pts = m.dof_coords
    u_ex = exact_solution(pts[:, 0], pts[:, 1], t)
    d = u - u_ex
    return jnp.sqrt(d @ ell_matvec(m, problem.M, d))


def l1_error_vs_exact(problem: HyperbolicProblem, u, t):
    """L1 error int |u - u_ex| dx with u_ex the nodal interpolant, evaluated
    by quadrature (the C++ reference assembles |u0-u_ex|*dx,
    ref Burger_CPP/main.cpp:473-482). Works for P1 and Pk spaces."""
    m = problem.mesh
    pts = getattr(m, "points", None)
    if pts is None:           # Pk space: dofs at lattice coords
        u_ex = exact_solution(m.dof_coords[:, 0], m.dof_coords[:, 1], t)
        d = u - u_ex
        d_q = _einsum("qc,mc->mq", m.phi, d[m.cell_dofs])
        return ((jnp.abs(d_q) * m.quad_w[None, :]).sum(axis=1)
                * 2.0 * m.area).sum()
    u_ex = exact_solution(pts[:, 0], pts[:, 1], t)
    d = u - u_ex
    phi = assembly._quad_basis().astype(u.dtype)
    d_q = _einsum("ma,qa->mq", d[m.cells], phi)
    w = assembly._DUN4_W.astype(u.dtype) * 0.5
    return ((jnp.abs(d_q) * w[None, :]).sum(axis=1) * 2.0 * m.area).sum()


def run(cfg: BurgersConfig | None = None, **kw):
    if cfg is None:
        cfg = BurgersConfig(**kw)
    p = build(cfg)
    res = p.solve()
    # For the standard T=0.5 run the reference compares against the exact
    # field at exactly t=0.5 even though the loop overshoots slightly
    # (ref Exact_Burger_RV_conv.py:223); for truncated runs compare at the
    # actual end time.
    t_cmp = 0.5 if cfg.T == 0.5 else res.num_steps * res.dt
    err = l2_error_vs_exact(p, res.u, t_cmp)
    return res, float(err)
