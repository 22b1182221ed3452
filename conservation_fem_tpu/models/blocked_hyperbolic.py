"""Blocked-window instantiation of the scalar hyperbolic solver.

Same math as HyperbolicProblem (identical to summation-order roundoff —
tests/test_blocked_model.py), different data layout: after RCM reordering
every sparse op (SpMV, cell gather/scatter, assembly, patch reductions)
runs as batched dense contractions via ops/blocked.py, with zero XLA
gathers/scatters in the hot path. Combined with fixed-iteration solvers
(cfg.cg_iters / newton_iters) it serves the reference's unstructured gmsh
meshes (ref Code/KPP/KPP_NodeRV.py setting). Whether it beats the
gather-ELL step on the H100 is not measured.
"""

from __future__ import annotations

import jax.numpy as jnp

from conservation_fem_tpu.models.scalar_hyperbolic import HyperbolicProblem
from conservation_fem_tpu.ops import assembly, blocked
from conservation_fem_tpu.ops import stabilization as stab
from conservation_fem_tpu.ops.bc import constrain_residual
from conservation_fem_tpu.ops.helpers import get_nodal_h
from conservation_fem_tpu.ops.krylov import jacobi_preconditioner


class BlockedHyperbolicProblem(HyperbolicProblem):
    """HyperbolicProblem with all unstructured kernels in blocked form.

    The mesh must be RCM-ordered (ops/mesh.reorder_mesh(rcm_permutation))
    for a small bandwidth; the plan builder asserts window consistency.
    """

    def __init__(self, *args, nb: int = 128, **kwargs):
        super().__init__(*args, **kwargs)
        dtype = jnp.dtype(self.cfg.dtype)
        if self.cfg.ell_matvec_backend == "blocked2d":
            # 2D tiled windows (ops/tiling): W independent of N — the
            # large-N unstructured path. The host_mesh must be a
            # tiling.tile_mesh slot mesh (kpp.build does this).
            self.plan = blocked.make_tiled_plan(
                self.host_mesh, nb=nb, dtype=dtype,
                precise=getattr(self.cfg, "blocked_precise", False),
                need_patch_sum=self.cfg.smooth_l > 0)
        else:
            self.plan = blocked.make_blocked_plan(
                self.host_mesh, nb=nb, dtype=dtype,
                precise=getattr(self.cfg, "blocked_precise", False))
        self._area_flat = self.plan.area_b.reshape(-1)
        self._grads_flat = self.plan.grads_b.reshape(-1, 3, 2)
        self.M_ell = self.M          # kept for the h_cg mass projection
        self._L_mass = assembly.local_mass(self._area_flat).reshape(
            self.plan.blocks, self.plan.C, 3, 3)
        self._L_mass9 = blocked.mass_locals_components(self.plan)
        self.M = self._assemble(assembly.local_mass(self._area_flat))

    # -- layout plumbing -----------------------------------------------------

    def _assemble(self, local_mats):
        """(blocks*C, 3, 3) local matrices -> blocked operator."""
        p = self.plan
        return blocked.assemble_matrix(
            p, local_mats.reshape(p.blocks, p.C, 3, 3))

    def _linear_op(self, D):
        # sweep copy cast ONCE here (closure build, outside solver loops);
        # the diag for the Jacobi preconditioner stays full-width
        Ds = blocked.sweep_form(self.plan, D)
        return (lambda x: blocked.spmv(self.plan, Ds, x),
                blocked.diag_of(self.plan, D))

    @property
    def h_cg(self):
        if self._h_cg is None:
            self._h_cg = get_nodal_h(self.mesh, mass_ell=self.M_ell)
        return self._h_cg

    @property
    def K_bc(self):
        """SI stiffness with bc semantics, blocked (cf. base K_bc)."""
        if self._K_bc is None and self.cfg.stabilization == "si":
            K = self._assemble(
                assembly.local_stiffness(self._area_flat, self._grads_flat))
            self._K_bc = blocked.apply_bc_matrix(self.plan, K)
        return self._K_bc

    # -- step pieces in blocked form ------------------------------------------
    # All hot quadratures run COMPONENTWISE on (blocks, C) planes
    # (ops/blocked.*_components) instead of the (M, 6)/(M, 3, 2) shaped
    # kernels of ops/assembly, whose tiny trailing dims pad badly in
    # device layouts.

    @property
    def _fpxy(self):
        """Componentwise flux derivative (fpx, fpy). Models attach
        flux_prime_xy after build (kpp.py / burgers.py); fall back to
        slicing the stacked flux_prime (correct, lane-padded)."""
        xy = getattr(self, "flux_prime_xy", None)
        if xy is not None:
            return xy
        return (lambda v: self.flux_prime(v)[..., 0],
                lambda v: self.flux_prime(v)[..., 1])

    def _nonlinear_rhs(self, u):
        fpx, fpy = self._fpxy
        return blocked.conv_rhs_components(self.plan, u, fpx, fpy)

    def _assemble_keps(self, eps):
        return blocked.assemble_matrix_components(
            self.plan, blocked.eps_locals_components(self.plan, eps))

    def _assemble_flux_jacobian(self, u):
        fpx, fpy = self._fpxy
        return blocked.assemble_matrix_components(
            self.plan,
            blocked.flux_jacobian_locals_components(self.plan, u, fpx, fpy))

    def _local_keps(self, eps):
        """(blocks, C, 3, 3) per-cell eps-stiffness locals (not assembled)."""
        p = self.plan
        ec = blocked.gather_cells(p, eps)
        return assembly.local_eps_stiffness(
            self._area_flat, self._grads_flat,
            ec.reshape(-1, 3)).reshape(p.blocks, p.C, 3, 3)

    def _local_flux_jacobian(self, u):
        p = self.plan
        uc = blocked.gather_cells(p, u)
        return assembly.local_flux_jacobian(
            self._area_flat, self._grads_flat, uc.reshape(-1, 3),
            self.flux_prime).reshape(p.blocks, p.C, 3, 3)

    def _newton_cn(self, u_n, eps, g):
        """Blocked CN Newton. Default (assembled): the eps-stiffness is
        NEVER assembled — its action K_eps v rides in the same
        gather/quadrature/scatter pass as the convection rhs
        (ops/blocked.conv_plus_locals_rhs_components), and the Newton
        Jacobian J = M + dt/2 (K_eps + C'(u)) is assembled from the SUMMED
        locals in ONE one-hot GEMM (assembly is linear in the locals;
        identity with the split form is summation-order roundoff). Same
        math as the base solve (ref Code/KPP/KPP_NodeRV.py:149-163); cuts
        one of the two per-step windowed-assembly GEMMs.

        blocked_matrix_free=True keeps even the Jacobian as per-cell
        locals applied via gather->einsum->scatter (ops/blocked.
        local_apply) — FLOP-cheap but each matvec re-streams the one-hots
        from HBM, so it pays only when operators are applied few times."""
        if not self.cfg.blocked_matrix_free:
            return self._newton_cn_assembled(u_n, eps, g)
        p = self.plan
        dt = self.dt
        bc = self.mesh.boundary_mask
        L_keps = self._local_keps(eps)
        L_cn = self._L_mass + 0.5 * dt * L_keps   # M + dt/2 Keps, local form
        N_un = self._nonlinear_rhs(u_n)
        Ms = blocked.sweep_form(p, self.M)            # cast once per step
        M_mv = lambda x: blocked.spmv(p, Ms, x)       # assembled once
        K_mv = lambda x: blocked.local_apply(p, L_keps, x)
        Keps_un = K_mv(u_n)

        def residual(v):
            F = (
                M_mv(v - u_n)
                + 0.5 * dt * (self._nonlinear_rhs(v) + N_un)
                + 0.5 * dt * (K_mv(v) + Keps_un)
            )
            return constrain_residual(F, v, g, bc)

        def jacobian(u):
            L_J = L_cn + 0.5 * dt * self._local_flux_jacobian(u)
            J_mv = lambda v: blocked.local_apply(p, L_J, v)
            matvec = lambda v: jnp.where(bc, v, J_mv(jnp.where(bc, 0.0, v)))
            J_diag = blocked.local_diag(p, L_J)
            pre = jacobi_preconditioner(jnp.where(bc, 1.0, J_diag))
            return matvec, pre

        u_init = jnp.where(bc, g, u_n)
        return self._newton_dispatch(residual, jacobian, u_init)

    def _newton_cn_assembled(self, u_n, eps, g):
        """Assembled-Jacobian blocked Newton (default; see _newton_cn)."""
        p = self.plan
        dt = self.dt
        bc = self.mesh.boundary_mask
        fpx, fpy = self._fpxy
        L_keps = blocked.eps_locals_components(p, eps)
        L_cn = self._L_mass9 + 0.5 * dt * L_keps
        NK = lambda v: blocked.conv_plus_locals_rhs_components(
            p, v, fpx, fpy, L_keps)
        NK_un = NK(u_n)
        Ms = blocked.sweep_form(p, self.M)            # cast once per step
        M_mv = lambda x: blocked.spmv(p, Ms, x)

        def residual(v):
            F = M_mv(v - u_n) + 0.5 * dt * (NK(v) + NK_un)
            return constrain_residual(F, v, g, bc)

        def jacobian(u):
            L_J = L_cn + 0.5 * dt * \
                blocked.flux_jacobian_locals_components(p, u, fpx, fpy)
            J = blocked.assemble_matrix_components(p, L_J)
            Jb = blocked.sweep_form(p, J)   # once per Newton iteration
            matvec = lambda v: jnp.where(bc, v, blocked.spmv(
                p, Jb, jnp.where(bc, 0.0, v)))
            J_diag = blocked.diag_of(p, J)
            pre = jacobi_preconditioner(jnp.where(bc, 1.0, J_diag))
            return matvec, pre

        u_init = jnp.where(bc, g, u_n)
        return self._newton_dispatch(residual, jacobian, u_init)

    def _epsilon(self, u_n, RH):
        cfg = self.cfg
        if cfg.stabilization == "rv":
            return blocked.rv_epsilon_nonlinear(
                self.plan, cfg.Cvel, cfg.CRV, u_n, u_n,
                self.flux_prime_norm, RH, self.h_cg,
                precise=cfg.precise_reductions,
                valid=self.plan.row_valid)
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

    # -- jit-state plumbing (see base class): the plan's one-hot operators
    # are ~O(N*(nb+2B)) floats — closure-captured they would be embedded in
    # the program as constants, so they ride through jit as arguments.

    def _jit_state(self):
        # force lazy members that the traced step will read
        _ = self.h_cg
        if self.cfg.stabilization == "si":
            _ = self.K_bc
        return {"plan": self.plan, "M": self.M, "K_bc": self._K_bc,
                "h_cg": self._h_cg, "L_mass9": self._L_mass9}

    def _bind_jit_state(self, state):
        token = (self.plan, self.M, self._K_bc, self._h_cg, self._L_mass9)
        self.plan = state["plan"]
        self.M = state["M"]
        self._K_bc = state["K_bc"]
        self._h_cg = state["h_cg"]
        self._L_mass9 = state["L_mass9"]
        return token

    def _restore_jit_state(self, token):
        (self.plan, self.M, self._K_bc, self._h_cg,
         self._L_mass9) = token
