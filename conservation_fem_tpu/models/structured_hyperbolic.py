"""Structured (stencil-backend) scalar conservation-law solver.

Same pipeline as models/scalar_hyperbolic.HyperbolicProblem — BDF2 residual
projection, RV epsilon, stabilized CN Newton (ref Code/KPP/KPP_NodeRV.py:
127-172) — but every operator is a gather-free 7-plane stencil
(ops/structured.py), usable whenever the mesh is a structured rectangle
triangulation (the KPP benchmark mesh, Burgers' unit square). Public API
(solve(), step(carry, t) over flat vectors) is identical, so it is a
drop-in for kpp.build(backend="stencil").

Numerical identity with the unstructured path is tested to f64 roundoff
(tests/test_structured.py).
"""

from __future__ import annotations

import jax.numpy as jnp

from conservation_fem_tpu.models.scalar_hyperbolic import HyperbolicProblem
from conservation_fem_tpu.ops import structured as st
from conservation_fem_tpu.ops.krylov import (cg, cg_fixed, chebyshev_fixed,
                                             jacobi_preconditioner)
from conservation_fem_tpu.ops.newton import newton_fixed, newton_solve


class StructuredHyperbolicProblem(HyperbolicProblem):
    """Construct via structure(); only stabilization='rv' and 'gfem' have
    stencil kernels so far (SI needs the bc-applied stiffness gather)."""

    def init_structured(self, nx: int, ny: int):
        if self.cfg.stabilization not in ("rv", "si", "gfem"):
            raise NotImplementedError(
                "stencil backend supports rv/si/gfem stabilization"
            )
        dtype = self.u0.dtype
        self.sd = st.build_structured(self.host_mesh, nx, ny, dtype)
        self._shape2 = (nx + 1, ny + 1)
        if self.cfg.stabilization == "si":
            self._K_bc_coef = st.stiffness_bc_coef(self.sd)
        return self

    def _force_lazy_operators(self):
        """No-op: the stencil kernels use sd coefficient fields; the ELL
        h_cg/K_bc would be dead weight on this backend."""

    # -- 2D pipeline ---------------------------------------------------------

    def _fprime_xy(self):
        # componentwise flux derivative for the plane-form quadrature
        # kernels (ops/structured nonlinear_rhs / flux_jacobian_coef)
        return getattr(self, "flux_prime_xy", None)

    def _residual_bdf2_2d(self, u2, uo2, uoo2, N_u=None):
        sd, dt = self.sd, self.dt
        if self.cfg.residual_scheme == "bdf1":
            du = (u2 - uo2) / dt
        else:
            du = (3.0 * u2 - 4.0 * uo2 + uoo2) / (2.0 * dt)
        if N_u is None:
            N_u = st.nonlinear_rhs(sd, u2, self.flux_prime,
                                   self._fprime_xy())
        rhs = st.mass_matvec(sd, du) + N_u
        rhs = jnp.where(sd.bc2, 0.0, rhs)
        diag = jnp.where(sd.bc2, 1.0, sd.diagM2)
        op = lambda x2: st.constrained_matvec(sd, sd.M_coef, x2)
        pre = jacobi_preconditioner(diag)
        if self.cfg.cg_iters is not None:
            # this projection feeds only the RV epsilon (tolerant), so the
            # FIXED-iteration sweep operator may stream as bf16
            # (structured.sweep_form); the adaptive-rtol CG below keeps the
            # exact operator — a bf16-perturbed operator can stall its
            # convergence below rtol and spin to maxiter.
            Mc = st.sweep_form(sd.M_coef, self.cfg.xla_bf16_planes)
            op = lambda x2: st.constrained_matvec(sd, Mc, x2)
            # fixed-count CG (no data-dependent loop exit);
            # inner_solver="cheby" drops the dots too (see HyperbolicConfig)
            if self.cfg.inner_solver == "cheby":
                lo, hi = self.cfg.cheby_mass_bounds
                return chebyshev_fixed(op, rhs, precond=pre,
                                       iters=self.cfg.cg_iters,
                                       lmin=lo, lmax=hi,
                                       unroll=self.cfg.solver_unroll).x
            return cg_fixed(op, rhs, precond=pre, iters=self.cfg.cg_iters,
                            unroll=self.cfg.solver_unroll).x
        return cg(op, rhs, precond=pre, rtol=self.cfg.krylov_rtol).x

    def _newton_cn_2d(self, u2, eps2, g2, N_un=None):
        sd, dt, cfg = self.sd, self.dt, self.cfg
        Kc = st.keps_coef(sd, eps2)
        if N_un is None:
            N_un = st.nonlinear_rhs(sd, u2, self.flux_prime,
                                    self._fprime_xy())
        Kc_un = st.matvec(sd, Kc, u2)
        base = sd.M_coef + 0.5 * dt * Kc

        def residual(v2):
            F = (
                st.mass_matvec(sd, v2 - u2)
                + 0.5 * dt * (st.nonlinear_rhs(
                    sd, v2, self.flux_prime, self._fprime_xy()) + N_un)
                + 0.5 * dt * (st.matvec(sd, Kc, v2) + Kc_un)
            )
            return jnp.where(sd.bc2, v2 - g2, F)

        def jacobian(v2):
            J = base + 0.5 * dt * st.flux_jacobian_coef(
                sd, v2, self.flux_prime, self._fprime_xy())
            # only the inner-solve sweeps see the (optionally bf16) copy;
            # the preconditioner diagonal and the Newton residual stay f32
            Js = st.sweep_form(J, cfg.xla_bf16_planes)
            mv = lambda x2: st.constrained_matvec(sd, Js, x2)
            pre = jacobi_preconditioner(jnp.where(sd.bc2, 1.0, J[0]))
            return mv, pre

        u_init = jnp.where(sd.bc2, g2, u2)
        if cfg.newton_iters is not None:
            return newton_fixed(
                residual, u_init,
                iters=cfg.newton_iters,
                linear_iters=cfg.newton_linear_iters,
                jacobian_fn=jacobian, freeze_jacobian=cfg.modified_newton,
                rtol=cfg.newton_rtol, atol=cfg.newton_atol,
                linear_solver=cfg.inner_solver,
                cheby_bounds=cfg.cheby_lin_bounds,
                final_residual=cfg.newton_final_residual,
                unroll=cfg.solver_unroll,
            )
        return newton_solve(
            residual, u_init,
            rtol=cfg.newton_rtol, atol=cfg.newton_atol,
            max_it=cfg.newton_max_it, criterion="residual",
            linear_rtol=cfg.newton_linear_rtol or cfg.krylov_rtol,
            jacobian_fn=jacobian, freeze_jacobian=cfg.modified_newton,
        )

    # -- public step (flat-vector API, same as the base class) ----------------

    def step(self, carry, t):
        u_n, u_old, u_old_old = carry
        sh = self._shape2
        u2, uo2, uoo2 = (v.reshape(sh) for v in (u_n, u_old, u_old_old))
        # one quadrature pass for N(u_n), shared by the residual
        # projection and the Newton frozen term (bit-identical reuse —
        # guarantees the sharing rather than relying on XLA CSE to
        # dedupe the two identical subgraphs)
        N_un = st.nonlinear_rhs(self.sd, u2, self.flux_prime,
                                self._fprime_xy())
        if self.cfg.stabilization == "rv":
            RH2 = self._residual_bdf2_2d(u2, uo2, uoo2, N_u=N_un)
            eps2 = st.rv_epsilon(
                self.sd, self.cfg.Cvel, self.cfg.CRV, u2, RH2,
                self.flux_prime_norm,
            )
        elif self.cfg.stabilization == "si":
            beta2 = self.flux_prime_norm(u2)
            eps2 = st.si_epsilon_grid(
                self.sd, self.cfg.Cm, self._K_bc_coef, u2, beta2,
                eps_floor=self.cfg.si_eps,
            )
        else:
            eps2 = jnp.zeros_like(u2)
        g2 = self.bc_value(self.mesh.points, t).reshape(sh)
        res = self._newton_cn_2d(u2, eps2, g2, N_un=N_un)
        uh = res.u
        if self.cfg.smooth_l > 0:
            uh = st.smooth_vector_grid(self.sd, uh, self.cfg.smooth_l)
        uh = uh.reshape(-1)
        metrics = None
        if self.cfg.record_metrics:
            metrics = {
                "eps_max": eps2.max(),
                "newton_iters": res.iters,
                "newton_converged": res.converged,
                "residual_norm": res.residual_norm,
                "u_min": uh.min(),
                "u_max": uh.max(),
            }
        return (uh, u_n, u_old), metrics


    # -- jit-state plumbing ---------------------------------------------------
    # The grid-sized buffers (7-plane mass stencil, bc mask, nodal h,
    # mesh points) cross jit boundaries as ARGUMENTS: closure captures
    # would be embedded in the program as constants (M_coef alone is
    # 470 MB at mesh 1024). Small statics (grads/phi/qw/area, Python
    # nx/ny) stay baked.

    def _jit_state(self):
        self._force_lazy_operators()
        st_ = {"M_coef": self.sd.M_coef, "bc2": self.sd.bc2,
               "h_cg2": self.sd.h_cg2, "diagM2": self.sd.diagM2,
               "pts": self.mesh.points}
        if self.cfg.stabilization == "si":
            st_["K_bc_coef"] = self._K_bc_coef
        return st_

    def _bind_jit_state(self, state):
        tok = (self.sd, self.mesh,
               getattr(self, "_K_bc_coef", None))
        self.sd = self.sd._replace(
            M_coef=state["M_coef"], bc2=state["bc2"],
            h_cg2=state["h_cg2"], diagM2=state["diagM2"])
        self.mesh = self.mesh._replace(points=state["pts"])
        if "K_bc_coef" in state:
            self._K_bc_coef = state["K_bc_coef"]
        return tok

    def _restore_jit_state(self, token):
        self.sd, self.mesh, kbc = token
        if kbc is not None:
            self._K_bc_coef = kbc


def structure(problem: HyperbolicProblem, nx: int, ny: int):
    """Upgrade a built HyperbolicProblem to the stencil backend in place."""
    problem.__class__ = StructuredHyperbolicProblem
    return problem.init_structured(nx, ny)
