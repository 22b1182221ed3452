"""Generic nonlinear scalar conservation law u_t + div f(u) = 0 in 2D,
P1 FEM + Crank-Nicolson + Newton, RV/SI shock capturing.

This is the framework core that the reference re-implements as a repeated
script skeleton (ref Code/KPP/KPP_NodeRV.py:127-172 and
Code/Burgers_equation/Exact_Burger_RV.py:169-231 are structurally
identical); KPP and Burgers below are thin instantiations.

Per time step (all inside one jitted lax.scan):
  1. BDF2 residual projection (ref KPP_NodeRV.py:131-145):
       M RH = M (3 u_n - 4 u_old + u_old_old)/(2 dt) + N(u_n),  RH|bc = 0
     where N(u)_a = int (f'(u) . grad u) phi_a dx. The reference wraps this
     linear problem in a NewtonSolver (1 effective iteration == exact LU
     solve); here it is a single mass CG solve to 1e-12 — equivalent.
  2. epsilon: RV patch kernel (ref RV.py:56-90) or SI kernel
     (ref SI.py:38-67, stiffness re-applied with current bc each step as in
     Exact_Burger_SI.py:169-172).
  3. stabilized CN Newton solve (ref KPP_NodeRV.py:149-163):
       F(v) = M(v - u_n) + dt/2 [N(v) + N(u_n)] + dt/2 Keps (v + u_n),
       v|bc = g(t);  NewtonSolver semantics: criterion 'residual',
       rtol 1e-4, inner solves exact (here BiCGStab at 1e-12).
  4. optional post-solve patch smoothing (ref Exact_Burger_SI.py:193).
  5. history shift x3 (ref KPP_NodeRV.py:167-169).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from conservation_fem_tpu.ops import assembly
from conservation_fem_tpu.ops.bc import constrained_matvec, constrain_residual, ell_with_bc
from conservation_fem_tpu.ops.helpers import get_nodal_h
from conservation_fem_tpu.ops.krylov import (cg, cg_fixed, chebyshev_fixed,
                                             jacobi_preconditioner)
from conservation_fem_tpu.ops.mesh import Mesh
from conservation_fem_tpu.ops.newton import newton_fixed, newton_solve
from conservation_fem_tpu.ops.spmv import ell_diag, ell_matvec
from conservation_fem_tpu.ops import stabilization as stab


@dataclasses.dataclass(frozen=True)
class HyperbolicConfig:
    stabilization: str = "rv"      # rv | si | gfem
    residual_scheme: str = "bdf2"  # bdf2 (ref KPP_NodeRV.py:131) | bdf1
                                   # (ref Burger_RV.py:144, RV_cell.py:169)
    Cvel: float = 0.5
    CRV: float = 4.0
    Cm: float = 1.0
    si_eps: float = 1e-8
    newton_rtol: float = 1e-4      # ref KPP_NodeRV.py:158
    newton_atol: float = 1e-10     # dolfinx NewtonSolver default
    newton_max_it: int = 100
    krylov_rtol: float = 1e-12
    # inner Newton linear-solve tolerance; None = krylov_rtol. Inexact
    # Newton (e.g. 1e-3) cuts BiCGStab iterations sharply while the
    # outer residual criterion still guarantees newton_rtol accuracy.
    newton_linear_rtol: float | None = None
    # modified Newton: one Jacobian assembly per step instead of per
    # iteration (same residual tolerance; used by the bench config)
    modified_newton: bool = False
    # FIXED iteration counts (throughput paths): when set, the adaptive
    # while-loop solvers are replaced by fixed-count ones
    # (ops/krylov.cg_fixed), whose loop needs no data-dependent exit.
    # Counts must be validated per workload against the adaptive solvers;
    # the Newton residual norm is still checked and surfaced in metrics.
    cg_iters: int | None = None          # residual-projection mass solve
    newton_iters: int | None = None      # outer Newton iterations
    newton_linear_iters: int = 8         # inner BiCGStab iterations
    # inner_solver="cheby": the fixed-iteration inner solves run as
    # DOT-FREE Chebyshev semi-iterations (krylov.chebyshev_fixed) instead
    # of CG/BiCGStab. No inner products means no psum collectives in
    # distributed inner solves (halo exchanges remain the only per-
    # iteration communication). Bounds cover the Jacobi-preconditioned
    # spectra: mass via Wathen [1/2, 2] (any triangulation); the CN
    # Jacobian measured [0.52, 1.96] (|im|<=0.1) on the KPP shock state,
    # padded. Chebyshev uses 1 matvec/iter vs BiCGStab's 2 — double
    # newton_linear_iters for matvec parity.
    inner_solver: str = "bicgstab"       # bicgstab | cheby
    # skip the residual evaluation at the final Newton iterate (fixed-
    # iteration path only): the eval feeds only the converged flag — one
    # whole quadrature pass per step; the flag then reports the residual
    # before the last correction (still a stagnation signal)
    newton_final_residual: bool = True
    cheby_mass_bounds: tuple = (0.5, 2.0)
    cheby_lin_bounds: tuple = (0.4, 2.2)
    # structured backend: stream the mass / frozen-Jacobian 7-plane
    # operators through the fixed-iteration sweeps as bfloat16 copies
    # (structured.sweep_form). Residual and quadrature passes stay f32;
    # no-op off f32 and on non-structured backends. Default OFF: its
    # accuracy at mesh 256 is not measured on the H100.
    xla_bf16_planes: bool = False
    # blocked backend quality mode (f32 one-hots + HIGHEST-precision
    # contractions, blocked.make_blocked_plan). Default OFF here: the
    # shock-dominated KPP/Burgers horizons stay at their f32-floor
    # accuracy gates with bf16 streams, which are ~2x cheaper on HBM
    blocked_precise: bool = False
    # f64-ACCUMULATED dots/means on both the single-device and sharded
    # paths (ops/precision.dot_acc64 family; inputs stay f32). Shrinks
    # the reduction-order seed that sharded-vs-single f32 trajectories
    # chaos-amplify from f32-eps (~1e-3 end-state gap) to f64-eps
    # (~1e-9); requires jax_enable_x64 to have effect. Asserted by
    # dryrun_multichip's f32 blocked path at 1e-5.
    precise_reductions: bool = False
    # fixed-iteration solver bodies: True = straight-line unrolled XLA;
    # False = lax.fori_loop (~linear_iters x smaller program; see
    # ops/newton.newton_fixed). Which is faster on the H100 is not
    # measured.
    solver_unroll: bool = True
    smooth_l: float = 0.0          # >0: post-solve smoothing strength
    # unstructured operator application: "gather" (XLA gather ELL SpMV) or
    # "banded" (RCM diagonals, gather-free — requires an RCM-ordered mesh
    # for a small bandwidth)
    ell_matvec_backend: str = "gather"
    # blocked backend only: apply the per-step operators (eps-stiffness,
    # flux Jacobian) MATRIX-FREE from per-cell 3x3 locals
    # (ops/blocked.local_apply) instead of materializing the windowed
    # operator via the two-sided one-hot contraction. Identical
    # contributions, summation order differs by roundoff
    # (tests/test_blocked.py asserts 1e-12). Default OFF: each one-hot
    # matvec streams the Gcell+Sv operators from device memory while an
    # assembled window spmv reads one window, and a step makes ~30
    # matvecs (the trade is not measured on the H100).
    blocked_matrix_free: bool = False
    dtype: str = "float64"
    record_metrics: bool = False


class HyperbolicProblem:
    """Holds the static setup; step/solve are jitted methods over arrays.

    flux_prime: u -> (..., 2) pointwise f'(u)
    flux_prime_norm: u -> |f'(u)| pointwise
    bc_value: (points, t) -> (N,) Dirichlet data (full vector, used on bc)
    """

    def __init__(
        self,
        cfg: HyperbolicConfig,
        host_mesh: Mesh,
        flux_prime: Callable,
        flux_prime_norm: Callable,
        bc_value: Callable,
        u0_fn: Callable,
        dt: float,
        num_steps: int,
    ):
        self.cfg = cfg
        self.host_mesh = host_mesh
        dtype = jnp.dtype(cfg.dtype)
        m = host_mesh.device_arrays(dtype)
        self.mesh = m
        self.flux_prime = flux_prime
        self.flux_prime_norm = flux_prime_norm
        self.bc_value = bc_value
        self.dt = float(dt)
        self.num_steps = int(num_steps)
        self._M = None
        self._bplan = None
        self._latplan = None
        if cfg.ell_matvec_backend == "banded":
            from conservation_fem_tpu.ops.banded import make_banded_plan

            self._bplan = make_banded_plan(host_mesh)
        elif cfg.ell_matvec_backend == "lattice":
            self._init_lattice(np.asarray(host_mesh.points), m)
        self._bc_points = m.points
        self.u0 = u0_fn(m.points[:, 0], m.points[:, 1]).astype(dtype)
        self._h_cg = None
        self._K_bc = None
        self._solve_jit = None

    @property
    def M(self):
        """ELL consistent mass, built lazily. The stencil backend never
        reads it, and at mesh 512 the eager (M,3,3) local-mass
        intermediate alone is large (M = 8.4M cells)."""
        if self._M is None:
            val = assembly.assemble_mass(self.mesh)
            if isinstance(val, jax.core.Tracer):
                return val      # mid-trace: never cache (tracer leak)
            self._M = val
        return self._M

    @M.setter
    def M(self, val):           # checkpoint restore assigns it directly
        self._M = val

    @property
    def h_cg(self):
        """Nodal h (mass-solve projection), computed lazily — the stencil
        backend never touches the ELL version (uniform-mesh h is exact)."""
        if self._h_cg is None:
            val = get_nodal_h(self.mesh, mass_ell=self.M)
            if isinstance(val, jax.core.Tracer):
                return val      # mid-trace: never cache (tracer leak)
            self._h_cg = val
        return self._h_cg

    @property
    def K_bc(self):
        if self._K_bc is None and self.cfg.stabilization == "si":
            K = assembly.assemble_stiffness(self.mesh)
            val = ell_with_bc(self.mesh, K, self.mesh.boundary_mask)
            if isinstance(val, jax.core.Tracer):
                return val      # mid-trace: never cache (tracer leak)
            self._K_bc = val
        return self._K_bc

    def _force_lazy_operators(self):
        """Force the lazily-built static operators BEFORE tracing. Computed
        inside a jit trace they (a) cache outer-trace tracers that poison
        any later re-trace and (b) get inlined into the scan BODY — the
        h_cg mass CG solve and the bc-stiffness assembly then re-execute
        every time step (this was silently part of every ELL/Pk per-step
        cost until round 3). The stencil backend overrides this to a no-op
        (its kernels use sd coefficient fields, not the ELL operators)."""
        _ = self.M
        if self.cfg.stabilization in ("rv", "si"):
            _ = self.h_cg
        if self.cfg.stabilization == "si":
            _ = self.K_bc

    def _init_lattice(self, coords, space_like):
        """Lattice-stencil application backend (ops/lattice.py): dofs on a
        regular lattice (structured rectangle meshes, any degree) — SpMV
        becomes shifted elementwise MACs, gather-free. The relayout of a
        (possibly per-step) operator's values is one scatter per
        _linear_op call; matvecs then cost one gather+scatter pair for the
        dof<->grid view instead of an (N,K) patch gather each."""
        from conservation_fem_tpu.ops import lattice as lat

        self._latplan = lat.build_plan(coords)
        self._latconv = lat.ell_to_planes_fn(self._latplan, space_like)

    def _linear_op(self, A_ell):
        """(matvec, diag) for an assembled ELL operator, honoring the
        configured application backend (gather vs banded diagonals vs
        lattice planes)."""
        if self._bplan is not None:
            from conservation_fem_tpu.ops.banded import banded_matvec, ell_to_banded

            band = ell_to_banded(self._bplan, A_ell)
            return (lambda x: banded_matvec(band, x)), band[self._bplan.bandwidth]
        if self._latplan is not None:
            from conservation_fem_tpu.ops import lattice as lat

            plan, op = self._latplan, self._latconv(A_ell)
            return (lambda x: lat.from_grid(plan, op(lat.to_grid(plan, x)))), \
                ell_diag(self.mesh, A_ell)
        return (lambda x: ell_matvec(self.mesh, A_ell, x)), ell_diag(self.mesh, A_ell)

    # -- step pieces --------------------------------------------------------

    def _nonlinear_rhs(self, u):
        """N(u)_a = int (f'(u) . grad u) phi_a dx. Overridden by the sharded
        problem (parallel/sharded.py) with a cell-partitioned kernel."""
        return assembly.convection_rhs_flux(self.mesh, u, self.flux_prime)

    def _assemble_keps(self, eps):
        """eps-weighted stiffness in ELL form; overridable (sharded path)."""
        return assembly.assemble_eps_stiffness(self.mesh, eps)

    def _assemble_flux_jacobian(self, u):
        return assembly.assemble_flux_jacobian(self.mesh, u, self.flux_prime)

    def _residual_bdf2(self, u_n, u_old, u_old_old):
        """BDF1/BDF2 residual projection with RH|bc = 0
        (ref KPP_NodeRV.py:131-145 bdf2; Burger_RV.py:144 bdf1)."""
        m, dt = self.mesh, self.dt
        bc = m.boundary_mask
        if self.cfg.residual_scheme == "bdf1":
            du = (u_n - u_old) / dt
        else:
            du = (3.0 * u_n - 4.0 * u_old + u_old_old) / (2.0 * dt)
        M_mv, M_diag = self._linear_op(self.M)
        rhs = M_mv(du) + self._nonlinear_rhs(u_n)
        rhs = jnp.where(bc, 0.0, rhs)
        diag = jnp.where(bc, 1.0, M_diag)
        op = lambda x: jnp.where(bc, x, M_mv(jnp.where(bc, 0.0, x)))
        pre = jacobi_preconditioner(diag)
        if self.cfg.cg_iters is not None:
            if self.cfg.inner_solver == "cheby":
                lo, hi = self.cfg.cheby_mass_bounds
                return chebyshev_fixed(op, rhs, precond=pre,
                                       iters=self.cfg.cg_iters,
                                       lmin=lo, lmax=hi,
                                       unroll=self.cfg.solver_unroll).x
            return cg_fixed(op, rhs, precond=pre,
                            iters=self.cfg.cg_iters, dot=self._dot,
                            unroll=self.cfg.solver_unroll).x
        return cg(op, rhs, precond=pre, rtol=self.cfg.krylov_rtol,
                  dot=self._dot).x

    def _epsilon(self, u_n, RH):
        cfg = self.cfg
        if cfg.stabilization == "rv":
            return stab.rv_epsilon_nonlinear(
                self.mesh, cfg.Cvel, cfg.CRV, u_n, u_n,
                self.flux_prime_norm, RH, self.h_cg,
            )
        elif cfg.stabilization == "si":
            beta = self.flux_prime_norm(u_n)
            return stab.si_epsilon(
                self.mesh, cfg.Cm, self.K_bc, u_n, beta, self.h_cg,
                eps_floor=cfg.si_eps,
            ).epsilon
        else:  # gfem — no stabilization (ref Exact_Burger_GFEM.py)
            return jnp.zeros_like(u_n)

    def _newton_cn(self, u_n, eps, g):
        """Stabilized CN Newton solve with u|bc = g."""
        m, dt = self.mesh, self.dt
        bc = m.boundary_mask
        Keps = self._assemble_keps(eps)
        N_un = self._nonlinear_rhs(u_n)
        M_mv, _ = self._linear_op(self.M)
        K_mv, _ = self._linear_op(Keps)
        Keps_un = K_mv(u_n)

        def residual(v):
            F = (
                M_mv(v - u_n)
                + 0.5 * dt * (self._nonlinear_rhs(v) + N_un)
                + 0.5 * dt * (K_mv(v) + Keps_un)
            )
            return constrain_residual(F, v, g, bc)

        base = self.M + 0.5 * dt * Keps

        def jacobian(u):
            """Assembled exact Jacobian J = M + dt/2 (C'(u) + Keps) as an
            ELL matrix: inner Krylov iterations become single SpMVs
            (the jvp path would re-quadrature the flux every iteration)."""
            Cu = self._assemble_flux_jacobian(u)
            J = base + 0.5 * dt * Cu
            J_mv, J_diag = self._linear_op(J)
            matvec = lambda v: jnp.where(bc, v, J_mv(jnp.where(bc, 0.0, v)))
            pre = jacobi_preconditioner(jnp.where(bc, 1.0, J_diag))
            return matvec, pre

        u_init = jnp.where(bc, g, u_n)
        return self._newton_dispatch(residual, jacobian, u_init)

    def _newton_dispatch(self, residual, jacobian, u_init):
        """Shared solver-selection tail of the CN Newton solve: fixed
        iterations (throughput path) or adaptive
        while-loop Newton, per config. Backends that build their own
        residual/jacobian operators (e.g. the matrix-free blocked path)
        call this directly."""
        if self.cfg.newton_iters is not None:
            return newton_fixed(
                residual, u_init,
                iters=self.cfg.newton_iters,
                linear_iters=self.cfg.newton_linear_iters,
                jacobian_fn=jacobian,
                freeze_jacobian=self.cfg.modified_newton,
                rtol=self.cfg.newton_rtol, atol=self.cfg.newton_atol,
                linear_solver=self.cfg.inner_solver,
                cheby_bounds=self.cfg.cheby_lin_bounds,
                final_residual=self.cfg.newton_final_residual,
                dot=self._dot,
                unroll=self.cfg.solver_unroll,
            )
        return newton_solve(
            residual, u_init,
            rtol=self.cfg.newton_rtol, atol=self.cfg.newton_atol,
            max_it=self.cfg.newton_max_it,
            criterion="residual",
            linear_rtol=self.cfg.newton_linear_rtol or self.cfg.krylov_rtol,
            jacobian_fn=jacobian,
            freeze_jacobian=self.cfg.modified_newton,
            dot=self._dot,
        )

    @property
    def _dot(self):
        """Inner product for the solver stack: f64-accumulated when
        cfg.precise_reductions (ops/precision.dot_acc64), else jnp.vdot."""
        if self.cfg.precise_reductions:
            from conservation_fem_tpu.ops.precision import dot_acc64

            return dot_acc64
        return jnp.vdot

    def _smooth(self, u):
        """Post-solve patch smoothing (ref Exact_Burger_SI.py:193)."""
        return stab.smooth_vector(self.mesh, u, self.cfg.smooth_l)

    # -- jit-state plumbing ---------------------------------------------------
    # Large device buffers cross jit boundaries as ARGUMENTS: closure-
    # captured buffers would be embedded in the program as constants
    # (the blocked backend's one-hot operators reach hundreds of MB).
    # Subclasses with big
    # static operators override _jit_state/_bind_jit_state; drivers wrap
    # traced regions in `with problem.bound_jit_state(state): ...`.

    def _jit_state(self):
        """Pytree of device buffers to pass through jit (None = nothing).
        Always called OUTSIDE the traced region — also the hook that
        forces lazy operators onto the device before tracing starts."""
        self._force_lazy_operators()
        return None

    def _bind_jit_state(self, state):
        """Swap in tracer-valued buffers during tracing; returns a restore
        token for _restore_jit_state."""
        return None

    def _restore_jit_state(self, token):
        pass

    def bound_jit_state(self, state):
        """Context manager binding `state` (e.g. inside a traced fn)."""
        import contextlib

        @contextlib.contextmanager
        def _cm():
            tok = self._bind_jit_state(state)
            try:
                yield
            finally:
                self._restore_jit_state(tok)

        return _cm()

    def step(self, carry, t):
        """One full stabilized time step; carry = (u_n, u_old, u_old_old)."""
        u_n, u_old, u_old_old = carry
        RH = self._residual_bdf2(u_n, u_old, u_old_old)
        eps = self._epsilon(u_n, RH)
        g = self.bc_value(self._bc_points, t)
        res = self._newton_cn(u_n, eps, g)
        uh = res.u
        if self.cfg.smooth_l > 0:
            uh = self._smooth(uh)
        metrics = None
        if self.cfg.record_metrics:
            metrics = {
                "eps_max": eps.max(),
                "newton_iters": res.iters,
                "newton_converged": res.converged,
                "residual_norm": res.residual_norm,
                "u_min": uh.min(),
                "u_max": uh.max(),
            }
        return (uh, u_n, u_old), metrics

    # -- driver -------------------------------------------------------------

    def solve(self, checkpoint_path: str | None = None,
              checkpoint_every: int = 0, resume: bool = False,
              stream=None):
        """Run the time loop. With checkpoint_path + checkpoint_every the
        scan runs in chunks and the solver carry (u_n, u_old, u_old_old)
        plus the step index are snapshotted between chunks; resume=True
        restarts from the stored snapshot (the reference has no resume —
        SURVEY.md section 5).

        stream: optional utils.streaming.StreamingSink — the per-step
        solution is posted to the host from inside the jitted scan via an
        ordered io_callback (the reference's in-loop xdmf.write_function,
        ref linear_advection.py:176)."""
        if checkpoint_path and checkpoint_every > 0:
            if stream is not None:
                raise ValueError(
                    "stream= is not supported together with checkpointing "
                    "(the chunked scan would bypass the streaming sink); "
                    "run with one or the other")
            return self._solve_checkpointed(
                checkpoint_path, checkpoint_every, resume
            )
        if stream is not None:

            @jax.jit
            def _run_stream(state, u0):
                with self.bound_jit_state(state):
                    ts = (jnp.arange(self.num_steps, dtype=u0.dtype) + 1.0) * self.dt

                    def step_emit(carry, t):
                        carry2, m = self.step(carry, t)
                        stream.emit(carry2[0], t)
                        return carry2, m

                    (u, _, _), metrics = jax.lax.scan(
                        step_emit, (u0, u0, u0), ts)
                return u, metrics

            u, metrics = _run_stream(self._jit_state(), self.u0)
            import jax as _jax

            _jax.block_until_ready(u)
            return SolveResult(u=u, metrics=metrics, dt=self.dt,
                               num_steps=self.num_steps)
        if self._solve_jit is None:

            @jax.jit
            def _run(state, u0):
                with self.bound_jit_state(state):
                    ts = (jnp.arange(self.num_steps, dtype=u0.dtype) + 1.0) * self.dt
                    carry0 = (u0, u0, u0)
                    (u, u_n, _), metrics = jax.lax.scan(self.step, carry0, ts)
                return u, metrics

            self._solve_jit = _run
        u, metrics = self._solve_jit(self._jit_state(), self.u0)
        return SolveResult(u=u, metrics=metrics, dt=self.dt, num_steps=self.num_steps)

    def _solve_checkpointed(self, path, every, resume):
        import os

        from conservation_fem_tpu.utils.checkpoint import (
            load_checkpoint,
            save_checkpoint,
        )

        @partial(jax.jit, static_argnums=3)
        def _chunk(state, carry, start_step, n):
            with self.bound_jit_state(state):
                ts = (start_step + jnp.arange(n, dtype=carry[0].dtype) + 1.0) * self.dt
                carry, _ = jax.lax.scan(
                    lambda c, t: (self.step(c, t)[0], None), carry, ts
                )
            return carry

        step0 = 0
        carry = (self.u0, self.u0, self.u0)
        if resume and os.path.exists(path):
            ck = load_checkpoint(path)
            step0 = ck.step
            carry = tuple(
                jnp.asarray(ck.arrays[k], self.u0.dtype)
                for k in ("u_n", "u_old", "u_old_old")
            )
        s = step0
        while s < self.num_steps:
            n = min(every, self.num_steps - s)
            carry = _chunk(self._jit_state(), carry,
                           jnp.asarray(s, self.u0.dtype), n)
            s += n
            save_checkpoint(path, step=s, t=s * self.dt,
                            u_n=carry[0], u_old=carry[1], u_old_old=carry[2])
        return SolveResult(u=carry[0], metrics=None, dt=self.dt,
                           num_steps=self.num_steps)


class SolveResult(NamedTuple):
    u: object
    metrics: object
    dt: float
    num_steps: int
