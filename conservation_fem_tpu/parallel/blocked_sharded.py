"""Distributed blocked-window unstructured solver: the FAST unstructured
path (ops/blocked.py, 18x over gather-ELL on the reference gmsh mesh),
sharded.

Why this is almost free: the blocked plan reads x ONLY through contiguous
row windows [b*nb - B, b*nb + nb + B), and every scatter/assembly one-hot
writes ONLY a block's own nb rows (cells are duplicated into every block
that owns one of their nodes at plan-build time). Partitioning CONTIGUOUS
block ranges per device therefore needs exactly one communication
primitive: a B-row band halo (ppermute) on each side of the local row
range — plus psum dots in the Krylov/Newton solves and psum/pmax for the
RV normalization. No reverse accumulation, no sparse halo tables.

Covers the full scalar-law feature set (rv | si | gfem stabilization,
bdf1 | bdf2 residual, time-dependent Dirichlet data, patch smoothing) —
the blocked twin of DistributedHyperbolic. Agreement with the
single-device BlockedHyperbolicProblem: 1e-9 over full runs
(tests/test_blocked_sharded.py).

ref: every reference script is MPI-distributable for free via DOLFINx
(Code/Linear_advection/linear_advection.py:40-42,165,170); this is that
capability on the blocked path.
"""

from __future__ import annotations

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh as DeviceMesh, NamedSharding, PartitionSpec as P

from conservation_fem_tpu.ops import assembly
from conservation_fem_tpu.ops import blocked as blocked_ops
from conservation_fem_tpu.ops import stabilization as stab
from conservation_fem_tpu.ops.krylov import (cg, cg_fixed, chebyshev_fixed,
                                             jacobi_preconditioner)
from conservation_fem_tpu.ops.newton import newton_fixed, newton_solve


class DistributedBlocked:
    """Wrap a BlockedHyperbolicProblem; solve() matches its public API."""

    def _setup_layout(self, problem, device_mesh, axis):
        """Common block-range partition layout + padding helpers shared
        with the Pk and advection twins. Returns (padb, pad_rows):
        block-leading-array and row-vector shard-padding functions."""
        self.p = problem
        self.dmesh = device_mesh
        self.axis = axis
        plan = problem.plan
        self.plan = plan
        n_dev = device_mesh.shape[axis]
        self.n_dev = n_dev
        Lb = -(-plan.blocks // n_dev)
        self.Lb = Lb
        self.blocks_pad = Lb * n_dev
        self.rows_local = Lb * plan.nb
        # halo rows each side: the 1D band window reads B rows past the
        # local range; the 2D tiled window (plan.run_off set) reads up to
        # (T+k) BLOCKS past it — still one contiguous band, because the
        # tile-slot ordering is strip-major (ops/tiling), so the same
        # ppermute band-halo machinery covers both
        self.halo = (-plan.run_off[0] * plan.nb
                     if getattr(plan, "run_off", None) is not None
                     else plan.B)
        if n_dev > 1 and self.rows_local < self.halo:
            raise ValueError(
                f"window halo {self.halo} rows exceeds a device's "
                f"{self.rows_local} rows — use fewer devices or a larger "
                "mesh")
        self.dtype = problem.u0.dtype
        pad_b = self.blocks_pad - plan.blocks
        sh = lambda spec: NamedSharding(device_mesh, spec)
        total = self.blocks_pad * plan.nb

        def padb(a, fill=0.0):
            """Pad a block-leading array with inert blocks and shard it."""
            a = jnp.asarray(a)
            widths = [(0, pad_b)] + [(0, 0)] * (a.ndim - 1)
            out = jnp.pad(a, widths, constant_values=fill)
            return jax.device_put(out, sh(P(axis, *([None] * (a.ndim - 1)))))

        def pad_rows(vec, fill=0.0):
            v = jnp.asarray(vec, self.dtype)
            v = jnp.pad(v, (0, total - v.shape[0]), constant_values=fill)
            return jax.device_put(v.reshape(self.blocks_pad, plan.nb),
                                  sh(P(axis, None)))

        if getattr(plan, "row_valid", None) is not None:
            # tiled slot layout: phantom padding slots are invalid
            rv = jnp.pad(jnp.asarray(plan.row_valid),
                         (0, total - plan.n), constant_values=False)
            self.valid_s = jax.device_put(
                rv.reshape(self.blocks_pad, plan.nb), sh(P(axis, None)))
        else:
            self.valid_s = jax.device_put(
                (jnp.arange(total) < plan.n).reshape(self.blocks_pad,
                                                     plan.nb),
                sh(P(axis, None)))
        self.bcrow_s = padb(plan.bc_row, False)
        self.patchdeg_s = padb(plan.patch_deg, 1.0)
        self.u0_s = pad_rows(problem.u0)
        return padb, pad_rows

    def __init__(self, problem, device_mesh: DeviceMesh, axis: str = "i"):
        padb, pad_rows = self._setup_layout(problem, device_mesh, axis)
        plan = problem.plan
        sh = lambda spec: NamedSharding(device_mesh, spec)
        total = self.blocks_pad * plan.nb

        self.Gcell_s = padb(plan.Gcell)
        self.Sv_s = padb(plan.Sv)
        self.Abool_s = padb(plan.A_bool, False)
        self.area_s = padb(plan.area_b)
        self.grads_s = padb(plan.grads_b)
        # replicated small statics
        self.diag_eye = jax.device_put(plan.diag_eye, sh(P(None, None)))

        m = problem.mesh
        self.h_s = pad_rows(problem.h_cg)
        pts = jnp.pad(m.points, ((0, total - plan.n), (0, 0)))
        self.pts_s = jax.device_put(
            pts.reshape(self.blocks_pad, plan.nb, 2), sh(P(axis, None, None)))
        # operators (blocked layout), padded along blocks
        self.M_s = padb(problem.M)
        self.Kbc_s = padb(problem.K_bc if problem.cfg.stabilization == "si"
                          else problem.M)

    # ---- local primitives (inside shard_map) ----------------------------

    def _band_halo(self, x_flat):
        """x (rows_local,) -> (left, right) halo bands from neighbors."""
        B, n = self.halo, self.n_dev
        ax = self.axis
        if n == 1:
            z = jnp.zeros((B,), x_flat.dtype)
            return z, z
        left = jax.lax.ppermute(x_flat[-B:], ax,
                                [(d, d + 1) for d in range(n - 1)])
        right = jax.lax.ppermute(x_flat[:B], ax,
                                 [(d, d - 1) for d in range(1, n)])
        idx = jax.lax.axis_index(ax)
        left = jnp.where(idx == 0, 0.0, left)
        right = jnp.where(idx == n - 1, 0.0, right)
        return left, right

    def _windows(self, x_flat):
        """(Lb*nb,) local rows -> (Lb, Wpad) halo'd windows
        (cf. ops/blocked.windows; same math, band halos instead of pad)."""
        pl = self.plan
        Lb = self.Lb
        left, right = self._band_halo(x_flat)
        if getattr(pl, "run_off", None) is not None:
            # tiled 3-run windows (blocked.windows tiled branch, with the
            # band halos standing in for the single-device edge padding)
            xp = jnp.concatenate([left, x_flat, right])
            span = Lb * pl.nb
            w = jnp.concatenate([
                jax.lax.slice(
                    xp, (self.halo + (o + q) * pl.nb,),
                    (self.halo + (o + q) * pl.nb + span,)).reshape(Lb,
                                                                   pl.nb)
                for o in pl.run_off for q in range(pl.rw)
            ], axis=1)
            if pl.Wpad > pl.W:
                w = jnp.pad(w, ((0, 0), (0, pl.Wpad - pl.W)))
            return w
        extra = (pl.Wpad // pl.nb - 1) * pl.nb - 2 * pl.B
        xp = jnp.concatenate(
            [left, x_flat, right, jnp.zeros((extra,), x_flat.dtype)])
        span = Lb * pl.nb
        chunks = [
            jax.lax.slice(xp, (q * pl.nb,), (q * pl.nb + span,))
            .reshape(Lb, pl.nb)
            for q in range(pl.Wpad // pl.nb)
        ]
        return jnp.concatenate(chunks, axis=1)

    # ---- the SPMD step ---------------------------------------------------

    def make_step(self):
        p = self.p
        cfg = p.cfg
        plan = self.plan
        dt = p.dt
        nb, B = plan.nb, plan.B
        Lb = self.Lb
        axis = self.axis
        fprime = p.flux_prime
        fpx, fpy = p._fpxy
        fprime_norm = p.flux_prime_norm
        bc_value = p.bc_value

        prec = blocked_ops.plan_precision(plan)

        def step_local(Mb, Kbc, Gcell, Sv, Abool, area_b,
                       grads_b, bc_row, patch_deg, diag_eye, h2, pts,
                       valid2, u2, uo2, uoo2, t):
            area_f = area_b.reshape(-1)
            grads_f = grads_b.reshape(-1, 3, 2)
            # LOCAL VIEW of the plan for the componentwise kernels (the
            # same code as the single-device step — identical summation
            # order, only the window gather is the halo'd one)
            lplan = dataclasses.replace(
                plan, blocks=Lb, Gcell=Gcell, Sv=Sv, area_b=area_b,
                grads_b=grads_b,
                gx3=grads_b[:, :, :, 0].transpose(0, 2, 1),
                gy3=grads_b[:, :, :, 1].transpose(0, 2, 1),
                Rrow=None, Ccol=None, A_bool=None, A_float=None,
                bc_row=None, bc_win=None, diag_eye=None, patch_deg=None,
                row_valid=None)
            pin2 = bc_row | ~valid2
            pin = pin2.reshape(-1)
            bc = bc_row.reshape(-1)
            validf = valid2.reshape(-1)
            h = h2.reshape(-1)
            if cfg.precise_reductions:
                from conservation_fem_tpu.ops.precision import pdot_acc64

                pdot = pdot_acc64(axis)
            else:
                pdot = lambda a, b: jax.lax.psum(jnp.vdot(a, b), axis)

            def spmv(D, x):
                return blocked_ops.spmv_windows(
                    D, self._windows(x), precision=prec).reshape(-1)

            # bf16 sweep copies, cast ONCE outside the solver loops — the
            # exact single-device scheme (one shared definition of the
            # bf16 stream semantics), so f32 sharded-vs-single
            # trajectories stay in lockstep
            sweep = lambda D: blocked_ops.sweep_form_arrays(Gcell.dtype, D)

            Mbs = sweep(Mb)

            def c_mv(D):
                def mv(x):
                    x_in = jnp.where(pin, 0.0, x)
                    return jnp.where(pin, x, spmv(D, x_in))
                return mv

            def diag_of(D):
                d = jnp.diagonal(D, offset=B, axis1=1, axis2=2)
                return d[:, :nb].reshape(-1)

            def gather3(x):
                """halo'd window gather -> (Lb, 3, C) component planes"""
                w = self._windows(x)
                uc = blocked_ops._oh_apply(Gcell, w, 2, self.dtype,
                                           precision=prec)
                return uc.reshape(Lb, 3, plan.C)

            def scatter3(v3):
                v = v3.reshape(Lb, 3 * plan.C)
                return blocked_ops._oh_apply(
                    Sv, v, 1, self.dtype, precision=prec).reshape(-1)

            # (cells, 3)-interleaved views for the assembly.local_*
            # kernels of the matrix-free branch
            def gather_cells(x):
                return gather3(x).transpose(0, 2, 1).reshape(-1, 3)

            def scatter_vec(vals):
                return scatter3(vals.reshape(Lb, plan.C, 3).transpose(
                    0, 2, 1))

            def patch_reduce(x, reducer, pad_val):
                w = self._windows(jnp.where(validf, x, pad_val))
                v = jnp.where(Abool, w[:, None, :], pad_val)
                return reducer(v, axis=2).reshape(-1)

            def nl_rhs(x, L9=None):
                return blocked_ops.conv_plus_locals_rhs_components(
                    lplan, x, fpx, fpy, L9, gather=gather3,
                    scatter=scatter3)

            # matrix-free twins (cfg.blocked_matrix_free): per-cell 3x3
            # locals applied gather->einsum->scatter, never assembled to
            # windowed form (cf. ops/blocked.local_apply — the windowed
            # one-hot assembly is ~16 GFLOP at the reference-mesh size).
            # SPMD-safe as-is: cells are duplicated into every block that
            # owns one of their nodes, gathers read halo'd windows, and
            # scatter_vec writes only the device's own rows.
            def local_apply(L, x):
                uc = gather_cells(x)                    # (Lb*C, 3)
                yc = jnp.einsum("cad,cd->ca", L, uc, precision=prec)
                return scatter_vec(yc)

            def local_diag(L):
                return scatter_vec(jnp.einsum("caa->ca", L))

            def local_keps(eps):
                return assembly.local_eps_stiffness(
                    area_f, grads_f, gather_cells(eps))

            def local_jac(x):
                return assembly.local_flux_jacobian(
                    area_f, grads_f, gather_cells(x), fprime)

            def c_op(mv):
                def wrapped(x):
                    x_in = jnp.where(pin, 0.0, x)
                    return jnp.where(pin, x, mv(x_in))
                return wrapped

            u = u2.reshape(-1)
            uo = uo2.reshape(-1)
            uoo = uoo2.reshape(-1)

            # 1. residual projection
            if cfg.residual_scheme == "bdf1":
                du = (u - uo) / dt
            else:
                du = (3.0 * u - 4.0 * uo + uoo) / (2.0 * dt)
            rhs = jnp.where(pin, 0.0, spmv(Mbs, du) + nl_rhs(u))
            diagM = jnp.where(pin, 1.0, diag_of(Mb))
            preM = jacobi_preconditioner(diagM)
            if cfg.cg_iters is not None and cfg.inner_solver == "cheby":
                # dot-free: the distributed inner solve needs NO psum
                # collectives — band halos are the only communication
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
                if cfg.precise_reductions:
                    from conservation_fem_tpu.ops.precision import (
                        psum_acc64, sum_acc64)

                    mean_u = psum_acc64(
                        sum_acc64(jnp.where(validf, u, 0.0)), axis) / nvalid
                else:
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

            # 3. Newton CN with u|bc = g(x, t)
            g2 = bc_value(pts.reshape(-1, 2), t)
            if cfg.blocked_matrix_free:
                N_un = nl_rhs(u)
                L_keps = local_keps(eps)
                L_cn = assembly.local_mass(area_f) + 0.5 * dt * L_keps
                K_mv = lambda v: local_apply(L_keps, v)
                Kc_un = K_mv(u)

                def residual(v):
                    F = (spmv(Mbs, v - u)
                         + 0.5 * dt * (nl_rhs(v) + N_un)
                         + 0.5 * dt * (K_mv(v) + Kc_un))
                    return jnp.where(pin, v - jnp.where(bc, g2, 0.0), F)

                def jacobian(v):
                    L_J = L_cn + 0.5 * dt * local_jac(v)
                    pre = jacobi_preconditioner(
                        jnp.where(pin, 1.0, local_diag(L_J)))
                    return c_op(lambda x: local_apply(L_J, x)), pre
            else:
                # Keps-free: the eps-stiffness action rides inside the
                # convection quadrature pass; the Jacobian is assembled
                # from SUMMED locals in one factored contraction — the
                # exact single-device scheme (blocked_hyperbolic
                # ._newton_cn_assembled), so f32 trajectories agree.
                L_keps = blocked_ops.eps_locals_components(
                    lplan, eps, gather=gather3)
                L_cn = (blocked_ops.mass_locals_components(lplan)
                        + 0.5 * dt * L_keps)
                NK_un = nl_rhs(u, L_keps)

                def residual(v):
                    F = (spmv(Mbs, v - u)
                         + 0.5 * dt * (nl_rhs(v, L_keps) + NK_un))
                    return jnp.where(pin, v - jnp.where(bc, g2, 0.0), F)

                def jacobian(v):
                    L_J = L_cn + 0.5 * dt * (
                        blocked_ops.flux_jacobian_locals_components(
                            lplan, v, fpx, fpy, gather=gather3))
                    J = blocked_ops.assemble_matrix_components(lplan, L_J)
                    pre = jacobi_preconditioner(
                        jnp.where(pin, 1.0, diag_of(J)))
                    return c_mv(sweep(J)), pre

            u_init = jnp.where(pin, jnp.where(bc, g2, 0.0), u)
            if cfg.newton_iters is not None:
                # fixed-iteration Newton (inner_solver="cheby" leaves only
                # the two residual-norm psums per step)
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
        smapped = shard_map(
            step_local,
            mesh=self.dmesh,
            in_specs=(
                P(ax, None, None), P(ax, None, None),   # Mb, Kbc
                P(ax, None, None), P(ax, None, None),   # Gcell, Sv
                P(ax, None, None),                       # Abool
                P(ax, None), P(ax, None, None, None),    # area_b, grads_b
                P(ax, None), P(ax, None),                # bc_row, patch_deg
                P(None, None),                           # diag_eye
                P(ax, None), P(ax, None, None),          # h2, pts
                P(ax, None),                             # valid
                P(ax, None), P(ax, None), P(ax, None),   # u, uo, uoo
                P(),                                     # t
            ),
            out_specs=(P(ax, None),) * 3,
        )
        return smapped

    def solve(self):
        p = self.p
        step = self.make_step()

        @jax.jit
        def _run(u0):
            def body(carry, t):
                u, uo, uoo = carry
                return step(self.M_s, self.Kbc_s, self.Gcell_s, self.Sv_s,
                            self.Abool_s,
                            self.area_s, self.grads_s, self.bcrow_s,
                            self.patchdeg_s, self.diag_eye, self.h_s,
                            self.pts_s, self.valid_s, u, uo, uoo, t), None

            ts = (jnp.arange(p.num_steps, dtype=u0.dtype) + 1.0) * p.dt
            (u, _, _), _ = jax.lax.scan(body, (u0, u0, u0), ts)
            return u

        u = _run(self.u0_s)
        return np.asarray(u).reshape(-1)[: self.plan.n]
