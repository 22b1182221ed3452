"""Domain-decomposed stencil solver: grid rows sharded over a device mesh
with one-row halo exchange — the equivalent of the reference's MPI
mesh partitioning (SURVEY.md section 2.8: DOLFINx ghost nodes +
``b.ghostUpdate(ADD, REVERSE)``, ref Code/Linear_advection/
linear_advection.py:165).

Decomposition: the (n1x, n1y) node grid of the structured backend
(ops/structured.py) is split into contiguous row blocks, one per device on
a 1D jax Mesh axis "i" (rows padded to a multiple of the device count;
padding rows are inert Dirichlet rows). Everything runs inside one
``shard_map``:

  * stencil matvec: one-row halo exchange via ``jax.lax.ppermute`` (the
    ghost update), then shifted-slice MACs on the extended block;
  * cell kernels (flux residual, Keps/Jacobian assembly): each device owns
    the quad rows starting at its node rows; boundary-row contributions are
    shipped to the next device with ppermute and accumulated — exactly the
    ADD/REVERSE ghost pattern;
  * Krylov dot products and the RV normalization reductions use
    ``psum``/``pmax`` over the axis;
  * the whole stabilized time step (residual CG -> RV epsilon -> Newton CN
    with assembled stencil Jacobians) runs SPMD, so the lax.scan time loop
    is a single jitted multi-device program.

Correctness contract (tested on a virtual 8-device CPU mesh): bit-level
agreement with the single-device stencil backend up to f64 roundoff.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh as DeviceMesh, NamedSharding, PartitionSpec as P

from conservation_fem_tpu.ops import structured as st
from conservation_fem_tpu.ops.krylov import cg, jacobi_preconditioner
from conservation_fem_tpu.ops.newton import newton_solve

OFFSETS = st.OFFSETS
CORNERS = st.CORNERS


class ShardedStructuredKPP:
    """Sharded KPP-style RV solver over a structured grid.

    Built from an existing StructuredHyperbolicProblem; public solve()
    matches the single-device API (flat global vectors in/out).
    """

    def __init__(self, problem, device_mesh: DeviceMesh, axis: str = "i"):
        self.p = problem
        self.dmesh = device_mesh
        self.axis = axis
        sd = problem.sd
        self.nx, self.ny = sd.nx, sd.ny
        n1x, n1y = self.nx + 1, self.ny + 1
        n_dev = device_mesh.shape[axis]
        self.n_dev = n_dev
        L = -(-n1x // n_dev)          # rows per device
        self.L = L
        self.pad_rows = L * n_dev - n1x
        self.n1y = n1y
        dtype = problem.u0.dtype
        self.dtype = dtype

        def pad_global(x2, fill=0.0):
            return jnp.pad(x2, ((0, self.pad_rows), (0, 0)),
                           constant_values=fill)

        self._pad_global = pad_global
        shard = NamedSharding(device_mesh, P(axis, None))
        # static per-device data
        bc2 = pad_global(sd.bc2, True)         # padded rows pinned
        self.bc2_s = jax.device_put(bc2, shard)
        # store coefs as (rows, 7, n1y) so the row axis is shardable first
        self.Mc_s = jax.device_put(jnp.moveaxis(jnp.stack(
            [pad_global(sd.M_coef[k]) for k in range(len(OFFSETS))]), 0, 1), shard)
        self.h_s = jax.device_put(pad_global(sd.h_cg2), shard)
        # valid-node mask (excludes padding rows)
        valid = pad_global(jnp.ones((n1x, n1y), dtype), 0.0)
        self.valid_s = jax.device_put(valid, shard)
        # dof coordinates (padded, row-sharded) so bc_value callables can be
        # evaluated per device block (time-dependent Dirichlet data)
        pts2 = problem.mesh.points.reshape(n1x, n1y, 2)
        pts_pad = jnp.pad(pts2, ((0, self.pad_rows), (0, 0), (0, 0)))
        self.pts_s = jax.device_put(
            pts_pad, NamedSharding(device_mesh, P(axis, None, None)))
        self.shard = shard
        self._chunk_jit = None

    # -- halo primitives (inside shard_map) ----------------------------------

    def _halo(self, x, fill=0.0):
        """(L, n1y) -> (L+2, n1y) with halo rows from neighbors; grid ends
        get `fill`."""
        ax, n = self.axis, self.n_dev
        up = jax.lax.ppermute(x[-1:], ax, [(d, d + 1) for d in range(n - 1)])
        down = jax.lax.ppermute(x[:1], ax, [(d, d - 1) for d in range(1, n)])
        idx = jax.lax.axis_index(ax)
        up = jnp.where(idx == 0, fill, up)
        down = jnp.where(idx == n - 1, fill, down)
        return jnp.concatenate([up, x, down], axis=0)

    def _matvec(self, coef, x):
        """coef (L, 7, n1y), x (L, n1y) -> (L, n1y)."""
        L, n1y = x.shape
        xe = jnp.pad(self._halo(x), ((0, 0), (1, 1)))
        out = jnp.zeros_like(x)
        for k, (di, dj) in enumerate(OFFSETS):
            out = out + coef[:, k, :] * jax.lax.dynamic_slice(
                xe, (1 + di, 1 + dj), (L, n1y)
            )
        return out

    def _quad_row_mask(self):
        """(L,) True where the local quad row exists globally (< nx)."""
        idx = jax.lax.axis_index(self.axis)
        g = idx * self.L + jnp.arange(self.L)
        return g < self.nx

    def _cell_planes(self, x):
        """x (L, n1y) -> per-corner (L, ny) planes, planes[t][a].

        Componentwise layout (ops/structured nonlinear_rhs rationale):
        the corner dim stays a Python list so no (..., 3) trailing dim is
        ever materialized with a padded device layout.
        """
        xe = self._halo(x)                     # rows offset +1
        L, ny = self.L, self.ny
        return [
            [jax.lax.dynamic_slice(xe, (1 + di, dj), (L, ny))
             for (di, dj) in CORNERS[t]]
            for t in range(2)
        ]

    def _node_scatter_planes(self, vals):
        """per-corner planes vals[t][a] (L, ny) -> (L, n1y) nodal sums
        with boundary-row shipping."""
        L, ny, n1y = self.L, self.ny, self.n1y
        qm = self._quad_row_mask()[:, None]
        out = jnp.zeros((L + 1, n1y), vals[0][0].dtype)
        for t in range(2):
            for a, (di, dj) in enumerate(CORNERS[t]):
                out = out.at[di:di + L, dj:dj + ny].add(
                    jnp.where(qm, vals[t][a], 0.0))
        ship = jax.lax.ppermute(
            out[-1:], self.axis, [(d, d + 1) for d in range(self.n_dev - 1)]
        )
        idx = jax.lax.axis_index(self.axis)
        ship = jnp.where(idx == 0, 0.0, ship)
        return out[:L].at[:1].add(ship)

    def _local_to_stencil_planes(self, loc):
        """local-matrix planes loc[t][a][b] (L, ny) -> (L, 7, n1y) stencil
        planes with row shipping."""
        L, ny, n1y = self.L, self.ny, self.n1y
        qm = self._quad_row_mask()[:, None]
        coef = jnp.zeros((L + 1, len(OFFSETS), n1y), loc[0][0][0].dtype)
        for t in range(2):
            cs = CORNERS[t]
            for a in range(3):
                dai, daj = cs[a]
                for b in range(3):
                    off = (cs[b][0] - dai, cs[b][1] - daj)
                    pidx = st._PLANE[off]
                    coef = coef.at[dai:dai + L, pidx, daj:daj + ny].add(
                        jnp.where(qm, loc[t][a][b], 0.0)
                    )
        ship = jax.lax.ppermute(
            coef[-1:], self.axis, [(d, d + 1) for d in range(self.n_dev - 1)]
        )
        idx = jax.lax.axis_index(self.axis)
        ship = jnp.where(idx == 0, 0.0, ship)
        return coef[:L].at[:1].add(ship)

    # -- FEM pieces -----------------------------------------------------------

    def _pdot(self, a, b):
        return jax.lax.psum(jnp.vdot(a, b), self.axis)

    def _fp_xy(self):
        return st._fp_comp(self.p.flux_prime,
                           getattr(self.p, "flux_prime_xy", None))

    def _nonlinear_rhs(self, x, sd_phi, sd_qw, grads, area):
        """Componentwise plane-form quadrature (ops/structured twin)."""
        fx, fy = self._fp_xy()
        c = self._cell_planes(x)
        nq = sd_qw.shape[0]
        two_area = 2.0 * area
        vals = [[None] * 3 for _ in range(2)]
        for t in range(2):
            gux = sum(grads[t, a, 0] * c[t][a] for a in range(3))
            guy = sum(grads[t, a, 1] * c[t][a] for a in range(3))
            for q in range(nq):
                uq = sum(sd_phi[q, a] * c[t][a] for a in range(3))
                conv = fx(uq) * gux + fy(uq) * guy
                for a in range(3):
                    w = two_area * sd_qw[q] * sd_phi[q, a]
                    vals[t][a] = (conv * w if vals[t][a] is None
                                  else vals[t][a] + conv * w)
        return self._node_scatter_planes(vals)

    def _keps(self, eps, grads, area):
        c = self._cell_planes(eps)
        loc = [[[None] * 3 for _ in range(3)] for _ in range(2)]
        for t in range(2):
            ae = area / 3.0 * (c[t][0] + c[t][1] + c[t][2])
            for a in range(3):
                for b in range(3):
                    gg = (grads[t, a, 0] * grads[t, b, 0]
                          + grads[t, a, 1] * grads[t, b, 1])
                    loc[t][a][b] = gg * ae
        return self._local_to_stencil_planes(loc)

    def _flux_jac(self, x, sd_phi, sd_qw, grads, area):
        fx, fy = self._fp_xy()
        c = self._cell_planes(x)
        nq = sd_qw.shape[0]
        two_area = 2.0 * area
        loc = [[[None] * 3 for _ in range(3)] for _ in range(2)]
        for t in range(2):
            gux = sum(grads[t, a, 0] * c[t][a] for a in range(3))
            guy = sum(grads[t, a, 1] * c[t][a] for a in range(3))
            for q in range(nq):
                uq = sum(sd_phi[q, a] * c[t][a] for a in range(3))
                ones = jnp.ones_like(uq)
                fpx, fppx = jax.jvp(fx, (uq,), (ones,))
                fpy, fppy = jax.jvp(fy, (uq,), (ones,))
                t1 = fppx * gux + fppy * guy
                gb = [fpx * grads[t, b, 0] + fpy * grads[t, b, 1]
                      for b in range(3)]
                for a in range(3):
                    wqa = sd_qw[q] * sd_phi[q, a]
                    for b in range(3):
                        contrib = (two_area * wqa) * (
                            t1 * sd_phi[q, b] + gb[b])
                        loc[t][a][b] = (contrib if loc[t][a][b] is None
                                        else loc[t][a][b] + contrib)
        return self._local_to_stencil_planes(loc)

    def _patch_reduce(self, x, reducer, pad_val, valid):
        x_masked = jnp.where(valid > 0, x, pad_val)
        xe = jnp.pad(self._halo(x_masked, fill=pad_val), ((0, 0), (1, 1)),
                     constant_values=pad_val)
        L, n1y = x.shape
        acc = x_masked
        for (di, dj) in OFFSETS[1:]:
            acc = reducer(acc, jax.lax.dynamic_slice(xe, (1 + di, 1 + dj), (L, n1y)))
        return acc

    # -- step -----------------------------------------------------------------

    def make_step(self):
        p, cfg = self.p, self.p.cfg
        sd = p.sd
        dt = p.dt
        phi, qw = sd.phi, sd.qw
        grads, area = sd.grads, sd.area
        axis = self.axis

        def step_local(bc2, Mc, h2, valid, pts, u, uo, uoo, t):
            pdot = self._pdot
            # residual projection
            if cfg.residual_scheme == "bdf1":
                du = (u - uo) / dt
            else:
                du = (3.0 * u - 4.0 * uo + uoo) / (2.0 * dt)
            rhs = self._matvec(Mc, du) + self._nonlinear_rhs(u, phi, qw, grads, area)
            rhs = jnp.where(bc2, 0.0, rhs)
            diagM = jnp.where(bc2, 1.0, Mc[:, 0, :])

            def c_mv(coef):
                def mv(x):
                    x_in = jnp.where(bc2, 0.0, x)
                    return jnp.where(bc2, x, self._matvec(coef, x_in))
                return mv

            RH = cg(c_mv(Mc), rhs, precond=jacobi_preconditioner(diagM),
                    rtol=cfg.krylov_rtol, dot=pdot).x
            # RV epsilon with psum'd global normalization
            nvalid = jax.lax.psum(valid.sum(), axis)
            mean_u = jax.lax.psum((u * valid).sum(), axis) / nvalid
            abs_term = jax.lax.pmax(
                jnp.abs(jnp.where(valid > 0, u - mean_u, 0.0)).max(), axis
            )
            u_max = self._patch_reduce(u, jnp.maximum, -jnp.inf, valid)
            u_min = self._patch_reduce(u, jnp.minimum, jnp.inf, valid)
            n_i = jnp.abs((u_max - u_min) - abs_term)
            Rh_i = self._patch_reduce(jnp.abs(RH), jnp.maximum, -jnp.inf, valid)
            tiny = jnp.asarray(
                1e-300 if u.dtype == jnp.float64 else 1e-30, u.dtype
            )
            beta = self._patch_reduce(
                p.flux_prime_norm(u), jnp.maximum, -jnp.inf, valid
            )
            eps = jnp.minimum(
                cfg.Cvel * h2 * beta,
                cfg.CRV * h2**2 * jnp.abs(Rh_i / jnp.maximum(n_i, tiny)),
            )
            eps = jnp.where(valid > 0, eps, 0.0)
            # Newton CN
            Kc = self._keps(eps, grads, area)
            N_un = self._nonlinear_rhs(u, phi, qw, grads, area)
            Kc_un = self._matvec(Kc, u)
            base = Mc + 0.5 * dt * Kc
            g2 = p.bc_value(pts.reshape(-1, 2), t).reshape(u.shape)

            def residual(v):
                F = (
                    self._matvec(Mc, v - u)
                    + 0.5 * dt * (self._nonlinear_rhs(v, phi, qw, grads, area) + N_un)
                    + 0.5 * dt * (self._matvec(Kc, v) + Kc_un)
                )
                return jnp.where(bc2, v - g2, F)

            def jacobian(v):
                J = base + 0.5 * dt * self._flux_jac(v, phi, qw, grads, area)
                pre = jacobi_preconditioner(jnp.where(bc2, 1.0, J[:, 0, :]))
                return c_mv(J), pre

            u_init = jnp.where(bc2, g2, u)
            res = newton_solve(
                residual, u_init,
                rtol=cfg.newton_rtol, atol=cfg.newton_atol,
                max_it=cfg.newton_max_it, criterion="residual",
                linear_rtol=cfg.newton_linear_rtol or cfg.krylov_rtol,
                jacobian_fn=jacobian, freeze_jacobian=cfg.modified_newton,
                dot=pdot,
            )
            return res.u, u, uo

        smapped = shard_map(
            step_local,
            mesh=self.dmesh,
            in_specs=(P(self.axis, None),) * 4
            + (P(self.axis, None, None),)
            + (P(self.axis, None),) * 3 + (P(),),
            out_specs=(P(self.axis, None),) * 3,
        )
        return smapped

    # -- checkpoint / resume (orbax, sharded-array + mesh-reshape safe) ------

    def init_carry(self):
        u0 = self._pad_global(self.p.u0.reshape(self.nx + 1, self.n1y))
        u0 = jax.device_put(u0, self.shard)
        return (u0, u0, u0)

    def run_chunk(self, carry, start_step: int, n: int):
        """Advance the sharded carry n steps from step index start_step."""
        if self._chunk_jit is None:
            step = self.make_step()

            def _chunk(carry, start, n):
                ts = (start + jnp.arange(n, dtype=self.dtype) + 1.0) * self.p.dt

                def body(c, t):
                    u, uo, uoo = c
                    return step(self.bc2_s, self.Mc_s, self.h_s,
                                self.valid_s, self.pts_s, u, uo, uoo, t), None

                carry, _ = jax.lax.scan(body, carry, ts)
                return carry

            self._chunk_jit = jax.jit(_chunk, static_argnums=2)
        return self._chunk_jit(carry, jnp.asarray(start_step, self.dtype), n)

    def save_carry(self, path: str, step: int, carry):
        """Orbax save of the sharded carry (at this mesh's row padding)."""
        from conservation_fem_tpu.utils.checkpoint import save_orbax

        state = {"step": np.asarray(step, np.int64),
                 "u": carry[0], "uo": carry[1], "uoo": carry[2]}
        return save_orbax(path, state)

    def restore_carry(self, path: str):
        """Orbax restore onto THIS object's device mesh, which may have a
        different device count than the saving mesh: the stored row count
        (saving mesh's padding) is read from checkpoint metadata; when the
        new device count divides it, orbax reshards directly onto the new
        mesh, otherwise it restores replicated. Rows are then re-padded for
        this mesh. Returns (step, padded sharded carry)."""
        from conservation_fem_tpu.utils.checkpoint import (
            load_orbax,
            orbax_metadata,
        )

        meta = orbax_metadata(path)
        rows_saved = meta.item_metadata.tree["u"].shape[0]
        if rows_saved % self.n_dev == 0:
            spec = P(self.axis, None)          # sharded restore
        else:
            spec = P()                          # replicated fallback
        shard = NamedSharding(self.dmesh, spec)
        like = {
            "step": np.asarray(0, np.int64),
            **{k: jax.ShapeDtypeStruct((rows_saved, self.n1y), self.dtype,
                                       sharding=shard)
               for k in ("u", "uo", "uoo")},
        }
        st_ = load_orbax(path, like)
        n1x = self.nx + 1

        def repad(x):
            return jax.device_put(self._pad_global(x[:n1x]), self.shard)

        return int(st_["step"]), tuple(repad(st_[k]) for k in ("u", "uo", "uoo"))

    def solve_checkpointed(self, path: str, every: int, resume: bool = False):
        """Chunked sharded run with orbax snapshots every `every` steps;
        resume=True restarts from the stored snapshot (works across a
        device-mesh reshape, e.g. save on 8 devices, resume on 4)."""
        import os

        p = self.p
        if resume and os.path.exists(path):
            s, carry = self.restore_carry(path)
        else:
            s, carry = 0, self.init_carry()
        while s < p.num_steps:
            n = min(every, p.num_steps - s)
            carry = self.run_chunk(carry, s, n)
            s += n
            self.save_carry(path, s, carry)
        u = carry[0][: self.nx + 1].reshape(-1)
        return u

    def solve(self):
        p = self.p
        step = self.make_step()
        u0 = self._pad_global(p.u0.reshape(self.nx + 1, self.n1y))
        u0 = jax.device_put(u0, self.shard)

        @jax.jit
        def _run(u0):
            ts = (jnp.arange(p.num_steps, dtype=u0.dtype) + 1.0) * p.dt

            def body(carry, t):
                u, uo, uoo = carry
                return step(self.bc2_s, self.Mc_s, self.h_s, self.valid_s,
                            self.pts_s, u, uo, uoo, t), None

            (u, _, _), _ = jax.lax.scan(body, (u0, u0, u0), ts,
                                        length=p.num_steps)
            return u

        u = _run(u0)
        u = u[: self.nx + 1].reshape(-1)
        return u


def shard_structured(problem, device_mesh: DeviceMesh, axis="i"):
    return ShardedStructuredKPP(problem, device_mesh, axis)
