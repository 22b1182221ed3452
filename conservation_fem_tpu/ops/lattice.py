"""Generalized lattice-stencil operators: ELL matrices -> offset planes.

Any function space whose dofs lie on a regular 2-D lattice (P1 on a
structured rectangle mesh; Pk on the same mesh — the Lagrange dofs of
degree k form the k-times-refined lattice; the P2-P1 Taylor-Hood pair in
models/stokes.py) admits a gather-free SpMV: for each geometric offset o
present in the sparsity, a coefficient plane P_o with

    (A x)[i, j] = sum_o  P_o[i, j] * x[i + oi, j + oj]

i.e. a shifted multiply-accumulate — the same gather-free form as the
hand-built P1 stencil in ops/structured.py, but derived automatically
from ANY assembled ELL matrix. This is the "generalized lattice-stencil
converter" that gives Stokes (P2 velocity / P1 pressure solves) and
higher-order advection their stencil backend.

Conversion runs host-side once (numpy); application is pure static
slicing + elementwise MACs (no gathers), so XLA fuses it. Identity with ell_matvec is tested to f64 roundoff
(tests/test_lattice.py).

ref: the reference gets its operators as PETSc CSR from FEniCSx and
MatMult is gather-bound (SURVEY.md L0); there is no reference analog of
this conversion (SURVEY §7 hard part #2).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


class LatticePlan(NamedTuple):
    """Host-built map from a dof vector to a dense (nI, nJ) grid.

    ``full`` is True when every lattice point is a dof (then grid <-> vec
    conversions are pure reshuffles and every grid point carries a row).
    For non-full lattices the hole positions are masked out of matvecs.
    """

    nI: int
    nJ: int
    idx: np.ndarray        # (N,) flat lattice index of each dof
    dof_at: np.ndarray     # (nI*nJ,) dof id at lattice point, -1 in holes
    full: bool


def build_plan(coords, tol=1e-8) -> LatticePlan:
    """Infer the lattice from dof coordinates (must quantize exactly)."""
    coords = np.asarray(coords, np.float64)

    def axis_quant(v):
        u = np.unique(np.round(v / tol) * tol)
        if u.size == 1:
            return u[0], 1.0, np.zeros_like(v, np.int64)
        h = np.diff(u).min()
        i = np.rint((v - u[0]) / h).astype(np.int64)
        if not np.allclose(u[0] + i * h, v, atol=tol * 10):
            raise ValueError("dof coordinates are not on a regular lattice")
        return u[0], h, i

    _, _, i = axis_quant(coords[:, 0])
    _, _, j = axis_quant(coords[:, 1])
    nI, nJ = int(i.max()) + 1, int(j.max()) + 1
    flat = i * nJ + j
    if np.unique(flat).size != flat.size:
        raise ValueError("two dofs share a lattice point")
    dof_at = np.full(nI * nJ, -1, np.int64)
    dof_at[flat] = np.arange(flat.size)
    return LatticePlan(nI=nI, nJ=nJ, idx=flat, dof_at=dof_at,
                       full=bool(flat.size == nI * nJ))


def to_planes(plan: LatticePlan, patch_cols, A, patch_mask=None):
    """ELL matrix -> (offsets, planes) in lattice form (host-side).

    offsets: list of (di, dj); planes: (P, nI, nJ) numpy array with
    planes[k][i, j] = A[row_at(i, j), slot-with-offset-k] (0 elsewhere).
    """
    A = np.asarray(A)
    patch_cols = np.asarray(patch_cols)
    N, K = A.shape
    ii = plan.idx // plan.nJ
    jj = plan.idx % plan.nJ
    rows = np.repeat(np.arange(N), K)
    cols = patch_cols.reshape(-1)
    vals = A.reshape(-1)
    # keep nonzero entries plus every diagonal slot, so identity-like rows
    # (e.g. pure Dirichlet rows whose off-diagonals are exact zeros) still
    # pin down the (0,0) plane; ELL padding slots alias the diagonal with
    # value 0, so accumulation below must be duplicate-safe (np.add.at)
    diag = cols == rows
    keep = (vals != 0.0) | diag
    if patch_mask is not None:
        keep &= np.asarray(patch_mask).reshape(-1) | diag
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    di = ii[cols] - ii[rows]
    dj = jj[cols] - jj[rows]
    key = (di - di.min()) * (2 * plan.nJ + 1) + (dj - dj.min())
    uniq, inv = np.unique(key, return_inverse=True)
    P = uniq.size
    planes = np.zeros((P, plan.nI, plan.nJ), A.dtype)
    np.add.at(planes, (inv, ii[rows], jj[rows]), vals)
    off_di = np.zeros(P, np.int64)
    off_dj = np.zeros(P, np.int64)
    off_di[inv] = di
    off_dj[inv] = dj
    offsets = [(int(a), int(b)) for a, b in zip(off_di, off_dj)]
    return offsets, planes


def _shift_read(x2, di, dj):
    """y[i,j] = x2[i+di, j+dj], zero out of bounds (static slices+pads)."""
    nI, nJ = x2.shape
    lo_i, hi_i = max(di, 0), nI + min(di, 0)
    lo_j, hi_j = max(dj, 0), nJ + min(dj, 0)
    core = x2[lo_i:hi_i, lo_j:hi_j]
    return jnp.pad(core, ((max(-di, 0), max(di, 0)),
                          (max(-dj, 0), max(dj, 0))))


def matvec(offsets, planes, x2):
    """(A x) on the grid: sum_k planes[k] * shift(x2, offsets[k])."""
    if not offsets:
        return jnp.zeros_like(x2)
    y = None
    for k, (di, dj) in enumerate(offsets):
        t = planes[k] * _shift_read(x2, di, dj)
        y = t if y is None else y + t
    return y


def to_grid(plan: LatticePlan, x, fill=0.0):
    """dof vector -> (nI, nJ) grid (single scatter; holes get ``fill``)."""
    g = jnp.full(plan.nI * plan.nJ, fill, dtype=x.dtype)
    g = g.at[jnp.asarray(plan.idx)].set(x)
    return g.reshape(plan.nI, plan.nJ)


def from_grid(plan: LatticePlan, x2):
    """(nI, nJ) grid -> dof vector (single gather)."""
    return x2.reshape(-1)[jnp.asarray(plan.idx)]


class LatticeOp(NamedTuple):
    """Device-ready lattice operator: offsets static, planes on device."""

    offsets: tuple
    planes: object         # (P, nI, nJ) jnp array

    def __call__(self, x2):
        return matvec(self.offsets, self.planes, x2)


def lattice_op(plan: LatticePlan, space_like, A, dtype=None) -> LatticeOp:
    """Build a LatticeOp from an ELL matrix on ``space_like`` (anything
    with .patch_cols; SpaceArrays or MeshArrays duck-type)."""
    offsets, planes = to_planes(
        plan, np.asarray(space_like.patch_cols), A)
    planes = jnp.asarray(planes, dtype or jnp.asarray(A).dtype)
    return LatticeOp(offsets=tuple(offsets), planes=planes)


def embed_plan(plan: LatticePlan, factor: int, nI: int, nJ: int) -> LatticePlan:
    """View a coarse plan's dofs on a ``factor``-times finer grid
    (coarse (i, j) -> fine (factor*i, factor*j)); the result has holes."""
    i = plan.idx // plan.nJ
    j = plan.idx % plan.nJ
    idx = (i * factor) * nJ + j * factor
    dof_at = np.full(nI * nJ, -1, np.int64)
    dof_at[idx] = np.arange(idx.size)
    return LatticePlan(nI=nI, nJ=nJ, idx=idx, dof_at=dof_at, full=False)


def to_planes_coo(row_plan: LatticePlan, col_plan: LatticePlan,
                  rows, cols, vals, dtype=np.float64):
    """COO matrix -> (offsets, planes) for rectangular operators between
    two dof sets viewed on the SAME (nI, nJ) grid (use embed_plan for the
    coarse side). Duplicate (row, col) entries accumulate.

        (A x)[at row_plan] = sum_o P_o * shift(x_on_grid, o)
    """
    if (row_plan.nI, row_plan.nJ) != (col_plan.nI, col_plan.nJ):
        raise ValueError("row/col plans must share a grid")
    nI, nJ = row_plan.nI, row_plan.nJ
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals, dtype)
    rf = row_plan.idx[rows]
    cf = col_plan.idx[cols]
    ri, rj = rf // nJ, rf % nJ
    di = cf // nJ - ri
    dj = cf % nJ - rj
    key = di.astype(np.int64) * (4 * nJ + 1) + dj
    uniq, first, inv = np.unique(key, return_index=True, return_inverse=True)
    planes = np.zeros((uniq.size, nI, nJ), dtype)
    np.add.at(planes, (inv, ri, rj), vals)
    offsets = [(int(di[f]), int(dj[f])) for f in first]
    return offsets, planes


class EllToPlanes(NamedTuple):
    """Traced ELL-values -> coefficient-planes converter.

    The sparsity PATTERN is fixed at build time (host side); only VALUES
    flow through, so per-step rebuilt operators (eps-weighted stiffness,
    assembled Jacobians) can be re-laid-out inside jit: one scatter per
    rebuild, then every Krylov matvec is gather-free.
    """

    offsets: tuple
    plane_of: object      # (N, K) int32 plane index per slot (garbage on pads)
    row_i: object         # (N,) lattice i of each row
    row_j: object         # (N,)
    valid: object         # (N, K) bool: real entry (not ELL padding)
    nI: int
    nJ: int

    def __call__(self, A):
        P = len(self.offsets)
        k = jnp.where(self.valid, self.plane_of, P)       # pads -> dump slot
        planes = jnp.zeros((P + 1, self.nI, self.nJ), A.dtype)
        N, K = A.shape
        ri = jnp.broadcast_to(self.row_i[:, None], (N, K))
        rj = jnp.broadcast_to(self.row_j[:, None], (N, K))
        planes = planes.at[k, ri, rj].add(A, mode="drop")
        return LatticeOp(offsets=self.offsets, planes=planes[:-1])


def ell_to_planes_fn(plan: LatticePlan, space_like) -> EllToPlanes:
    """Host-side pattern analysis for EllToPlanes (run once per space)."""
    patch_cols = np.asarray(space_like.patch_cols)
    N, K = patch_cols.shape
    ii = plan.idx // plan.nJ
    jj = plan.idx % plan.nJ
    di = ii[patch_cols] - ii[:, None]                     # (N, K)
    dj = jj[patch_cols] - jj[:, None]
    # padding slots repeat the row index (offset 0) but may hold zeros of
    # real entries too; mark validity from patch_mask when available,
    # else treat every slot as valid (scatter-add of zeros is harmless)
    mask = getattr(space_like, "patch_mask", None)
    if mask is None:
        valid = np.ones((N, K), bool)
    else:
        valid = np.asarray(mask)
    key = di.astype(np.int64) * (4 * plan.nJ + 1) + dj
    uniq, first, inv = np.unique(key[valid], return_index=True,
                                 return_inverse=True)
    plane_of = np.zeros((N, K), np.int32)
    plane_of[valid] = inv.astype(np.int32)
    offsets = list(zip(di[valid][first].tolist(), dj[valid][first].tolist()))
    return EllToPlanes(
        offsets=tuple(offsets),
        plane_of=jnp.asarray(plane_of),
        row_i=jnp.asarray(ii, jnp.int32),
        row_j=jnp.asarray(jj, jnp.int32),
        valid=jnp.asarray(valid),
        nI=plan.nI, nJ=plan.nJ)
