"""Multi-device execution: cell-partitioned kernels over a jax device mesh.

Replacement for the reference's MPI domain decomposition
(SURVEY.md section 2.8: DOLFINx partitions the mesh across ranks and
accumulates shared-node contributions with ``b.ghostUpdate(ADD, REVERSE)``,
ref Code/Linear_advection/linear_advection.py:40-42,165).

v1 decomposition ("owner-cells, replicated nodes"):
  * nodal vectors (u, residuals, ELL operators) are replicated;
  * the cell-wise hot kernels — nonlinear flux residual assembly and
    eps-weighted stiffness assembly, the reference's dominant per-step cost
    — are sharded over contiguous cell blocks with ``shard_map``; partial
    nodal accumulations are combined with ``jax.lax.psum``, which
    is exactly the ghostUpdate(ADD) pattern expressed as an XLA collective.

Cell arrays are padded with degenerate zero-area cells (node index 0) so
blocks divide evenly; padding contributes exact zeros. A fully
node-partitioned path with halo index exchange is the planned v2
(parallel/partition.py holds the block partitioner).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh as DeviceMesh
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from conservation_fem_tpu.models.scalar_hyperbolic import HyperbolicProblem
from conservation_fem_tpu.ops.assembly import _quad_basis, _DUN4_W
from conservation_fem_tpu.ops.precision import einsum_exact as _einsum


def _pad_cell_arrays(mesh_arrays, n_dev: int):
    """Pad (cells, area, grads, cell_slots) with zero-area dummy cells so the
    leading dim divides n_dev."""
    cells = np.asarray(mesh_arrays.cells)
    area = np.asarray(mesh_arrays.area)
    grads = np.asarray(mesh_arrays.grads)
    slots = np.asarray(mesh_arrays.cell_slots)
    M = cells.shape[0]
    pad = (-M) % n_dev
    if pad:
        cells = np.concatenate([cells, np.zeros((pad, 3), cells.dtype)])
        area = np.concatenate([area, np.zeros(pad, area.dtype)])
        grads = np.concatenate([grads, np.zeros((pad, 3, 2), grads.dtype)])
        slots = np.concatenate([slots, np.zeros((pad, 3, 3), slots.dtype)])
    return cells, area, grads, slots


class ShardedHyperbolicProblem(HyperbolicProblem):
    """HyperbolicProblem whose cell-heavy kernels run cell-partitioned
    across a device mesh. Construct via ``shard_problem``."""

    def init_sharding(self, device_mesh: DeviceMesh, axis: str = "fem"):
        self.device_mesh = device_mesh
        self.axis = axis
        n_dev = device_mesh.shape[axis]
        dtype = self.u0.dtype
        cells, area, grads, slots = _pad_cell_arrays(self.mesh, n_dev)
        cell_sharding = NamedSharding(device_mesh, P(axis))
        rep = NamedSharding(device_mesh, P())
        self._s_cells = jax.device_put(jnp.asarray(cells, jnp.int32), cell_sharding)
        self._s_area = jax.device_put(jnp.asarray(area, dtype), cell_sharding)
        self._s_grads = jax.device_put(jnp.asarray(grads, dtype), cell_sharding)
        self._rep = rep
        n = int(self.mesh.patch_cols.shape[0])
        K = int(self.mesh.patch_cols.shape[1])
        # per-cell flat ELL targets row*K + slot (for Keps scatter)
        rows = np.repeat(np.asarray(cells), 3, axis=1).reshape(-1, 3, 3)
        flat_tgt = rows * K + slots
        self._s_tgt = jax.device_put(
            jnp.asarray(flat_tgt, jnp.int32), cell_sharding
        )
        self._nK = (n, K)

        mesh_axes = device_mesh, axis
        phi = _quad_basis().astype(dtype)
        qw = _DUN4_W.astype(dtype) * 0.5
        flux_prime = self.flux_prime

        @partial(
            shard_map, mesh=device_mesh,
            in_specs=(P(axis), P(axis), P(axis), P()),
            out_specs=P(),
        )
        def _conv_rhs(cells_blk, area_blk, grads_blk, u):
            u_cell = u[cells_blk]                        # (mb,3)
            u_q = _einsum("ma,qa->mq", u_cell, phi)      # (mb,Q)
            fp_q = flux_prime(u_q)                       # (mb,Q,2)
            grad_u = _einsum("ma,mad->md", u_cell, grads_blk)
            conv_q = _einsum("mqd,md->mq", fp_q, grad_u)
            r = _einsum("mq,qa->ma", conv_q * qw[None, :], phi)
            r = 2.0 * area_blk[:, None] * r
            out = jnp.zeros(n, dtype).at[cells_blk.reshape(-1)].add(r.reshape(-1))
            return jax.lax.psum(out, axis)

        @partial(
            shard_map, mesh=device_mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis), P()),
            out_specs=P(),
        )
        def _keps(cells_blk, area_blk, grads_blk, tgt_blk, eps):
            gg = _einsum("mad,mbd->mab", grads_blk, grads_blk)
            scale = area_blk * eps[cells_blk].mean(axis=1)
            vals = (scale[:, None, None] * gg).reshape(-1)
            flat = jnp.zeros(n * K, dtype).at[tgt_blk.reshape(-1)].add(vals)
            return jax.lax.psum(flat, axis).reshape(n, K)

        self._conv_rhs_sharded = _conv_rhs
        self._keps_sharded = _keps
        return self

    # overrides ------------------------------------------------------------

    def _nonlinear_rhs(self, u):
        return self._conv_rhs_sharded(self._s_cells, self._s_area, self._s_grads, u)

    def _assemble_keps(self, eps):
        return self._keps_sharded(
            self._s_cells, self._s_area, self._s_grads, self._s_tgt, eps
        )


def shard_problem(problem: HyperbolicProblem, device_mesh: DeviceMesh, axis="fem"):
    """Upgrade a built HyperbolicProblem to multi-chip execution in place."""
    problem.__class__ = ShardedHyperbolicProblem
    return problem.init_sharding(device_mesh, axis)
