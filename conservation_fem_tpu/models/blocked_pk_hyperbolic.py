"""Blocked-window instantiation of the Pk scalar hyperbolic solver.

Same math as PkHyperbolicProblem (identical to summation-order roundoff —
tests/test_blocked_pk.py) on an RCM-permuted dof numbering: all per-step
gathers/scatters/assemblies run as the component-major one-hot contractions
of ops/blocked.py + ops/blocked_pk.py instead of XLA gathers/segment_sums,
for higher-order spaces
(ref Code/Burgers_equation/higher_order_SI.py P2 SI Burgers); the lattice
backend remains for structured-mesh matvecs, but it cannot remove the
per-step assembly scatters — this backend does.

The dof permutation is internal: u0/bc evaluate at the permuted
dof_coords, so solve() results live in the permuted numbering;
`u_unpermuted = u_blocked[problem.dof_perm]` recovers the native order
(dof_perm maps old -> new; tests/test_blocked_pk.py asserts the full-run
identity against the gather path at 1e-12 f64).
"""

from __future__ import annotations

import jax.numpy as jnp

from conservation_fem_tpu.models.pk_hyperbolic import PkHyperbolicProblem
from conservation_fem_tpu.ops import blocked
from conservation_fem_tpu.ops import blocked_pk as bpk
from conservation_fem_tpu.ops import stabilization as stab
from conservation_fem_tpu.ops.bc import constrain_residual
from conservation_fem_tpu.ops.krylov import jacobi_preconditioner
from conservation_fem_tpu.ops.spaces import (build_space, permute_dofs,
                                             rcm_dof_permutation)


class BlockedPkHyperbolicProblem(PkHyperbolicProblem):
    """PkHyperbolicProblem with all hot kernels in blocked-window form."""

    def __init__(self, *args, nb: int = 128, **kwargs):
        self._nb = nb
        super().__init__(*args, **kwargs)
        dtype = jnp.dtype(self.cfg.dtype)
        self.plan = bpk.make_blocked_pk_plan(
            self.space, nb=nb, dtype=dtype,
            precise=getattr(self.cfg, "blocked_precise", False))
        self.M_ell = self.M          # kept for the h_cg mass projection
        self._L_mass = bpk.pk_mass_locals(self.plan, dtype)
        self.M = blocked.assemble_matrix_components(self.plan, self._L_mass)

    def _make_space(self, host_mesh, degree):
        space = build_space(host_mesh, degree)
        self.dof_perm = rcm_dof_permutation(space)
        return permute_dofs(space, self.dof_perm)

    # -- layout plumbing ------------------------------------------------------

    def _linear_op(self, D):
        # bf16 sweep copy cast ONCE here (cf. blocked.sweep_form); the
        # Jacobi diag stays full-width
        Ds = blocked.sweep_form(self.plan, D)
        return (lambda x: blocked.spmv(self.plan, Ds, x),
                blocked.diag_of(self.plan, D))

    @property
    def h_cg(self):
        if self._h_cg is None:
            import jax

            from conservation_fem_tpu.models.advection_ho import \
                get_nodal_h_pk

            val = get_nodal_h_pk(self.mesh, self.M_ell)
            if isinstance(val, jax.core.Tracer):
                return val      # mid-trace: never cache (tracer leak)
            self._h_cg = val
        return self._h_cg

    @property
    def K_bc(self):
        """SI stiffness with bc semantics, blocked windows."""
        if self._K_bc is None and self.cfg.stabilization == "si":
            K = blocked.assemble_matrix_components(
                self.plan,
                bpk.pk_stiffness_locals(self.plan, self.u0.dtype))
            self._K_bc = blocked.apply_bc_matrix(self.plan, K)
        return self._K_bc

    @property
    def _fpxy(self):
        xy = getattr(self, "flux_prime_xy", None)
        if xy is not None:
            return xy
        return (lambda v: self.flux_prime(v)[..., 0],
                lambda v: self.flux_prime(v)[..., 1])

    # -- step pieces in blocked form ------------------------------------------

    def _nonlinear_rhs(self, u):
        fpx, fpy = self._fpxy
        return bpk.pk_conv_plus_locals_rhs(self.plan, u, fpx, fpy)

    def _newton_cn(self, u_n, eps, g):
        """Keps-free blocked CN Newton (cf. blocked_hyperbolic
        ._newton_cn_assembled): the eps-stiffness action rides in the
        residual's quadrature pass; the Jacobian is assembled from summed
        locals in one factored contraction."""
        p = self.plan
        dt = self.dt
        bc = self.mesh.boundary_mask
        fpx, fpy = self._fpxy
        L_keps = bpk.pk_eps_locals(p, eps)
        L_cn = self._L_mass + 0.5 * dt * L_keps
        NK = lambda v: bpk.pk_conv_plus_locals_rhs(p, v, fpx, fpy, L_keps)
        NK_un = NK(u_n)
        Ms = blocked.sweep_form(p, self.M)            # cast once per step
        M_mv = lambda x: blocked.spmv(p, Ms, x)

        def residual(v):
            F = M_mv(v - u_n) + 0.5 * dt * (NK(v) + NK_un)
            return constrain_residual(F, v, g, bc)

        def jacobian(u):
            L_J = L_cn + 0.5 * dt * bpk.pk_flux_jacobian_locals(
                p, u, fpx, fpy)
            J = blocked.assemble_matrix_components(p, L_J)
            Jb = blocked.sweep_form(p, J)   # once per Newton iteration
            matvec = lambda v: jnp.where(bc, v, blocked.spmv(
                p, Jb, jnp.where(bc, 0.0, v)))
            pre = jacobi_preconditioner(
                jnp.where(bc, 1.0, blocked.diag_of(p, J)))
            return matvec, pre

        u_init = jnp.where(bc, g, u_n)
        return self._newton_dispatch(residual, jacobian, u_init)

    def _epsilon(self, u_n, RH):
        cfg = self.cfg
        if cfg.stabilization == "rv":
            return blocked.rv_epsilon_nonlinear(
                self.plan, cfg.Cvel, cfg.CRV, u_n, u_n,
                self.flux_prime_norm, RH, self.h_cg)
        elif cfg.stabilization == "si":
            beta = self.flux_prime_norm(u_n)
            alpha = blocked.si_alpha(self.plan, self.K_bc, u_n,
                                     eps_floor=cfg.si_eps)
            psi = stab.sigmoid_activation(alpha)
            return psi * cfg.Cm * self.h_cg * beta
        else:
            return jnp.zeros_like(u_n)

    def _smooth(self, u):
        return blocked.smooth_vector(self.plan, u, self.cfg.smooth_l)

    # -- jit-state plumbing (big buffers as jit ARGUMENTS, cf. base class) ----

    def _jit_state(self):
        _ = self.h_cg
        if self.cfg.stabilization == "si":
            _ = self.K_bc
        return {"plan": self.plan, "M": self.M, "K_bc": self._K_bc,
                "h_cg": self._h_cg, "L_mass": self._L_mass}

    def _bind_jit_state(self, state):
        token = (self.plan, self.M, self._K_bc, self._h_cg, self._L_mass)
        self.plan = state["plan"]
        self.M = state["M"]
        self._K_bc = state["K_bc"]
        self._h_cg = state["h_cg"]
        self._L_mass = state["L_mass"]
        return token

    def _restore_jit_state(self, token):
        (self.plan, self.M, self._K_bc, self._h_cg, self._L_mass) = token
