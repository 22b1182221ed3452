"""Distributed blocked-window Pk solver: the fast higher-order path
(ops/blocked_pk.py) sharded over a device mesh.

Same SPMD scheme as parallel/blocked_sharded.DistributedBlocked (which
this subclasses for the band-halo window machinery): contiguous block
ranges per device, one B-row ppermute halo per side, psum dots; every
one-hot scatter writes only the device's own rows because cells are
duplicated into every owning block at plan-build time. The Pk quadrature
kernels run on a LOCAL VIEW of the plan (per-device shards of the
geometry planes) with the halo'd window gather injected
(blocked_pk kernels' gather/scatter overrides).

Covers rv | si | gfem stabilization, bdf1 | bdf2 residual, time-dependent
Dirichlet data, patch smoothing, adaptive or fixed-iteration solvers
(assembled Jacobian path). Agreement with the single-device
BlockedPkHyperbolicProblem: 1e-9 f64 over full runs
(tests/test_blocked_pk_sharded.py).

ref: the reference's higher-order scripts (higher_order_SI.py,
GFEM_pol.py) are MPI-distributable via DOLFINx; this is that capability
on the blocked Pk path.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh as DeviceMesh, NamedSharding, PartitionSpec as P

from conservation_fem_tpu.ops import blocked as blocked_ops
from conservation_fem_tpu.ops import stabilization as stab
from conservation_fem_tpu.ops import blocked_pk as bpk
from conservation_fem_tpu.ops.krylov import (cg, cg_fixed, chebyshev_fixed,
                                             jacobi_preconditioner)
from conservation_fem_tpu.ops.newton import newton_fixed, newton_solve
from conservation_fem_tpu.parallel.blocked_sharded import DistributedBlocked


class DistributedBlockedPk(DistributedBlocked):
    """Wrap a BlockedPkHyperbolicProblem; solve() matches its API."""

    def __init__(self, problem, device_mesh: DeviceMesh, axis: str = "i"):
        padb, pad_rows = self._setup_layout(problem, device_mesh, axis)
        plan = problem.plan
        sh = lambda spec: NamedSharding(device_mesh, spec)
        total = self.blocks_pad * plan.nb

        self.Gcell_s = padb(plan.Gcell)
        self.Sv_s = padb(plan.Sv)
        self.Abool_s = padb(plan.A_bool, False)
        self.detjq_s = padb(plan.detjq)
        self.gxq_s = padb(plan.gxq)
        self.gyq_s = padb(plan.gyq)
        self.h_s = pad_rows(problem.h_cg)
        pts = jnp.pad(jnp.asarray(problem._bc_points),
                      ((0, total - plan.n), (0, 0)))
        self.pts_s = jax.device_put(
            pts.reshape(self.blocks_pad, plan.nb, 2),
            sh(P(axis, None, None)))
        self.M_s = padb(problem.M)
        self.Kbc_s = padb(problem.K_bc
                          if problem.cfg.stabilization == "si"
                          else problem.M)
        self._L_mass_s = padb(problem._L_mass)

    def make_step(self):
        p = self.p
        cfg = p.cfg
        plan = self.plan
        dt = p.dt
        nb, B = plan.nb, plan.B
        Lb = self.Lb
        axis = self.axis
        fpx, fpy = p._fpxy
        fprime_norm = p.flux_prime_norm
        bc_value = p.bc_value

        prec = blocked_ops.plan_precision(plan)

        def step_local(Mb, Kbc, Gcell, Sv, Abool, detjq, gxq, gyq, Lmass,
                       bc_row, patch_deg, h2, pts, valid2, u2, uo2, uoo2,
                       t):
            # LOCAL VIEW of the plan: per-device geometry shards; the
            # window gather is the halo'd one (injected below)
            lplan = dataclasses.replace(
                plan, blocks=Lb, Gcell=Gcell, Sv=Sv, detjq=detjq,
                gxq=gxq, gyq=gyq, A_bool=None, A_float=None, bc_row=None,
                bc_win=None, diag_eye=None, patch_deg=None)
            pin2 = bc_row | ~valid2
            pin = pin2.reshape(-1)
            bc = bc_row.reshape(-1)
            validf = valid2.reshape(-1)
            h = h2.reshape(-1)
            pdot = lambda a, b: jax.lax.psum(jnp.vdot(a, b), axis)

            def gather(x):
                w = self._windows(x)
                uc = blocked_ops._oh_apply(Gcell, w, 2, self.dtype,
                                           precision=prec)
                return uc.reshape(Lb, plan.nd, plan.C)

            def scatter(v3):
                v = v3.reshape(Lb, plan.nd * plan.C)
                return blocked_ops._oh_apply(
                    Sv, v, 1, self.dtype, precision=prec).reshape(-1)

            def spmv(D, x):
                return blocked_ops.spmv_windows(
                    D, self._windows(x), precision=prec).reshape(-1)

            def c_mv(D):
                def mv(x):
                    x_in = jnp.where(pin, 0.0, x)
                    return jnp.where(pin, x, spmv(D, x_in))
                return mv

            # bf16 sweep copies, cast ONCE outside the solver loops — the
            # exact single-device scheme (one shared definition of the
            # bf16 stream semantics), so f32 sharded-vs-single
            # trajectories stay in lockstep
            sweep = lambda D: blocked_ops.sweep_form_arrays(Gcell.dtype, D)

            Mbs = sweep(Mb)

            def diag_of(D):
                d = jnp.diagonal(D, offset=B, axis1=1, axis2=2)
                return d[:, :nb].reshape(-1)

            def patch_reduce(x, reducer, pad_val):
                w = self._windows(jnp.where(validf, x, pad_val))
                v = jnp.where(Abool, w[:, None, :], pad_val)
                return reducer(v, axis=2).reshape(-1)

            def nl_rhs(x, L=None):
                return bpk.pk_conv_plus_locals_rhs(
                    lplan, x, fpx, fpy, L, gather=gather, scatter=scatter)

            u = u2.reshape(-1)
            uo = uo2.reshape(-1)
            uoo = uoo2.reshape(-1)

            # 1. residual projection
            if cfg.residual_scheme == "bdf1":
                du = (u - uo) / dt
            else:
                du = (3.0 * u - 4.0 * uo + uoo) / (2.0 * dt)
            rhs = jnp.where(pin, 0.0, spmv(Mbs, du) + nl_rhs(u))
            preM = jacobi_preconditioner(jnp.where(pin, 1.0, diag_of(Mb)))
            if cfg.cg_iters is not None and cfg.inner_solver == "cheby":
                RH = chebyshev_fixed(c_mv(Mbs), rhs, precond=preM,
                                     iters=cfg.cg_iters,
                                     lmin=cfg.cheby_mass_bounds[0],
                                     lmax=cfg.cheby_mass_bounds[1]).x
            elif cfg.cg_iters is not None:
                RH = cg_fixed(c_mv(Mbs), rhs, precond=preM,
                              iters=cfg.cg_iters, dot=pdot).x
            else:
                RH = cg(c_mv(Mbs), rhs, precond=preM,
                        rtol=cfg.krylov_rtol, dot=pdot).x

            # 2. epsilon
            tiny = jnp.asarray(
                1e-300 if u.dtype == jnp.float64 else 1e-30, u.dtype)
            if cfg.stabilization == "rv":
                nvalid = jax.lax.psum(validf.sum(), axis)
                mean_u = jax.lax.psum(
                    jnp.where(validf, u, 0.0).sum(), axis) / nvalid
                abs_term = jax.lax.pmax(
                    jnp.abs(jnp.where(validf, u - mean_u, 0.0)).max(), axis)
                u_max = patch_reduce(u, jnp.max, -jnp.inf)
                u_min = patch_reduce(u, jnp.min, jnp.inf)
                n_i = jnp.abs((u_max - u_min) - abs_term)
                Rh_i = patch_reduce(jnp.abs(RH), jnp.max, 0.0)
                beta = patch_reduce(fprime_norm(u), jnp.max, -jnp.inf)
                eps = jnp.minimum(
                    cfg.Cvel * h * beta,
                    cfg.CRV * h**2 * jnp.abs(Rh_i / jnp.maximum(n_i, tiny)))
            elif cfg.stabilization == "si":
                w = self._windows(u)
                u_r = w[:, B:B + nb]
                duw = w[:, None, :] - u_r[:, :, None]
                num = jnp.abs(jnp.einsum("brw,brw->br", Kbc, duw,
                                         precision=prec))
                den = jnp.einsum("brw,brw->br", jnp.abs(Kbc),
                                 jnp.abs(duw), precision=prec)
                alpha = (num / jnp.maximum(den, cfg.si_eps)).reshape(-1)
                psi = stab.sigmoid_activation(alpha)
                eps = psi * cfg.Cm * h * fprime_norm(u)
            else:
                eps = jnp.zeros_like(u)
            eps = jnp.where(validf, eps, 0.0)

            # 3. Newton CN (Keps-free: eps action fused into the residual
            # quadrature; Jacobian from summed locals, one contraction —
            # cf. models/blocked_pk_hyperbolic._newton_cn)
            L_keps = bpk.pk_eps_locals(lplan, eps, gather=gather)
            L_cn = Lmass + 0.5 * dt * L_keps
            NK_un = nl_rhs(u, L_keps)
            g2 = bc_value(pts.reshape(-1, 2), t)

            def residual(v):
                F = spmv(Mbs, v - u) + 0.5 * dt * (nl_rhs(v, L_keps) + NK_un)
                return jnp.where(pin, v - jnp.where(bc, g2, 0.0), F)

            def jacobian(v):
                L_J = L_cn + 0.5 * dt * bpk.pk_flux_jacobian_locals(
                    lplan, v, fpx, fpy, gather=gather)
                J = blocked_ops.assemble_matrix_components(lplan, L_J)
                pre = jacobi_preconditioner(
                    jnp.where(pin, 1.0, diag_of(J)))
                return c_mv(sweep(J)), pre

            u_init = jnp.where(pin, jnp.where(bc, g2, 0.0), u)
            if cfg.newton_iters is not None:
                res = newton_fixed(
                    residual, u_init,
                    iters=cfg.newton_iters,
                    linear_iters=cfg.newton_linear_iters,
                    jacobian_fn=jacobian,
                    freeze_jacobian=cfg.modified_newton,
                    rtol=cfg.newton_rtol, atol=cfg.newton_atol,
                    dot=pdot, linear_solver=cfg.inner_solver,
                    cheby_bounds=cfg.cheby_lin_bounds,
                    final_residual=cfg.newton_final_residual)
            else:
                res = newton_solve(
                    residual, u_init,
                    rtol=cfg.newton_rtol, atol=cfg.newton_atol,
                    max_it=cfg.newton_max_it, criterion="residual",
                    linear_rtol=cfg.newton_linear_rtol or cfg.krylov_rtol,
                    jacobian_fn=jacobian,
                    freeze_jacobian=cfg.modified_newton,
                    dot=pdot)
            uh = res.u
            if cfg.smooth_l > 0:
                total = spmv(jnp.where(Abool, 1.0, 0.0).astype(uh.dtype), uh)
                dsz = jnp.maximum(patch_deg.reshape(-1) - 1.0, 1.0)
                l = cfg.smooth_l
                uh = (total - uh + (l - 1.0) * dsz * uh) / (l * dsz)
                uh = jnp.where(validf, uh, 0.0)
            return (uh.reshape(Lb, nb), u2, uo2)

        ax = self.axis
        return shard_map(
            step_local,
            mesh=self.dmesh,
            in_specs=(
                P(ax, None, None), P(ax, None, None),       # Mb, Kbc
                P(ax, None, None), P(ax, None, None),       # Gcell, Sv
                P(ax, None, None),                           # Abool
                P(ax, None, None), P(ax, None, None, None),  # detjq, gxq
                P(ax, None, None, None),                     # gyq
                P(ax, None, None),                           # Lmass
                P(ax, None), P(ax, None),                    # bc_row, pdeg
                P(ax, None), P(ax, None, None),              # h2, pts
                P(ax, None),                                 # valid
                P(ax, None), P(ax, None), P(ax, None),       # u, uo, uoo
                P(),                                         # t
            ),
            out_specs=(P(ax, None),) * 3,
        )

    def solve(self):
        p = self.p
        step = self.make_step()

        @jax.jit
        def _run(u0):
            def body(carry, t):
                u, uo, uoo = carry
                return step(self.M_s, self.Kbc_s, self.Gcell_s, self.Sv_s,
                            self.Abool_s, self.detjq_s, self.gxq_s,
                            self.gyq_s, self._L_mass_s, self.bcrow_s,
                            self.patchdeg_s, self.h_s, self.pts_s,
                            self.valid_s, u, uo, uoo, t), None

            ts = (jnp.arange(p.num_steps, dtype=u0.dtype) + 1.0) * p.dt
            (u, _, _), _ = jax.lax.scan(body, (u0, u0, u0), ts)
            return u

        u = _run(self.u0_s)
        return np.asarray(u).reshape(-1)[: self.plan.n]
