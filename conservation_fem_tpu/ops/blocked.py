"""Blocked-window unstructured backend: sparse FEM ops as dense contractions.

Why this exists: it replaces every gather/scatter of the unstructured hot
path with batched dense einsums over static windows, for accelerators on
which XLA gathers and scatters are slow. On the H100, gathers and
segment_sum are native, and which backend is faster is not measured:

After RCM reordering (ops/mesh.rcm_permutation) all matrix/patch structure
lies within bandwidth B of the diagonal. Rows are split into blocks of
``nb``; each block's entire world is the contiguous x-window
[b*nb - B, b*nb + nb + B), extracted with *static slices* (no gather):

  * SpMV: operator stored as (blocks, nb, Wpad) dense row-windows;
    y = einsum('bnw,bw->bn') — a batched GEMV.
  * cell gathers u[cells] and cell->node scatters: precomputed one-hot
    matrices (exact 0/1 values) applied as einsums.
  * matrix assembly (cell 3x3 locals -> global): two-sided one-hot
    contraction out[b,r,w] = sum_s Rrow[b,s,r] * vals[b,s] * Ccol[b,s,w].
  * patch reductions (RV/SI epsilon, smoothing): masked window max/min/sum.

It stands in for the reference's compiled CSR row loops
(ref Burger_CPP/main.cpp:196-269 compute_alphaij, :420-466 hot loop) for
unstructured meshes. Device-memory cost of the one-hot operators is
O(N * (nb + 2B)) — sized for the reference's gmsh meshes (N ~ 5-50k);
larger meshes should use the structured/stencil backend or gather-ELL.

Everything here is exactly equal (to summation-order roundoff) to the ELL
backend — tests/test_blocked.py asserts identity on f64.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from conservation_fem_tpu.ops.mesh import Mesh


@dataclasses.dataclass(frozen=True, eq=False)
class BlockedPlan:
    """Host-precomputed blocked-window structure for one RCM-ordered mesh.

    eq=False: identity hashing so a plan rides through jit as static
    metadata (arrays become baked constants / donated operands).
    """

    n: int          # true node count
    nb: int         # rows per block
    B: int          # matrix bandwidth after RCM
    blocks: int
    W: int          # window width nb + 2B
    Wpad: int       # W padded to the 128-lane multiple of nb
    C: int          # padded cells per block
    pad_hi: int     # right padding of x for window extraction
    # device arrays
    Gcell: object   # (blocks, ndC, Wpad) one-hot: window -> cell-local u
    Sv: object      # (blocks, ndC, nb)  one-hot: cell-local vec -> rows
    A_bool: object  # (blocks, nb, Wpad) bool patch adjacency (incl self)
    A_float: object  # same as 0/1 float
    area_b: object  # (blocks, C)
    grads_b: object  # (blocks, C, 3, 2)
    gx3: object     # (blocks, 3, C) basis-gradient x components
    gy3: object     # (blocks, 3, C)
    bc_row: object  # (blocks, nb) bool
    bc_win: object  # (blocks, Wpad) bool (global column is bc)
    diag_eye: object  # (nb, Wpad) 1 at (r, r+B)
    patch_deg: object  # (blocks, nb) float: patch size incl self (>=1)
    h_cell_b: object = None  # (blocks, C) cell diameters (rv_cell)
    nd: int = 3     # local dofs per cell (3 = P1; Pk plans use BlockedPkPlan)
    # precise=True: f32 one-hot storage + Precision.HIGHEST contractions
    # (see make_blocked_plan / plan_precision) — the quality mode for
    # long smooth-transport horizons where bf16 operand streams visibly
    # diffuse the solution
    precise: bool = False
    # the nd^2C-wide assembly one-hots are DEAD since the factored
    # assembly (assemble_matrix_components) — kept as always-None fields
    # for pytree compatibility (~165 MB HBM saved on the reference mesh)
    Rrow: object = None
    Ccol: object = None
    # 2D TILED window mode (ops/tiling + make_tiled_plan): the window is
    # 3 contiguous runs of rw blocks at block offsets run_off (instead of
    # the single [b*nb - B, ...) band), so W = 3*rw*nb is CONSTANT in N.
    # In this mode B holds the window DIAGONAL OFFSET (rw + k)*nb — the
    # only B semantics diag_of/rows_of/apply_bc_matrix ever relied on —
    # and row_valid masks the phantom padding slots of the tiled layout
    # out of global reductions (rv_epsilon_* valid argument).
    run_off: tuple | None = None
    rw: int = 0
    row_valid: object = None


_PLAN_ARRAY_FIELDS = (
    "Gcell", "Sv", "Rrow", "Ccol", "A_bool", "A_float", "area_b", "grads_b",
    "gx3", "gy3", "bc_row", "bc_win", "diag_eye", "patch_deg", "h_cell_b",
    "row_valid",
)
_PLAN_STATIC_FIELDS = ("n", "nb", "B", "blocks", "W", "Wpad", "C", "pad_hi",
                       "nd", "precise", "run_off", "rw")


def _plan_flatten(p):
    return (tuple(getattr(p, f) for f in _PLAN_ARRAY_FIELDS),
            tuple(getattr(p, f) for f in _PLAN_STATIC_FIELDS))


def _plan_unflatten(aux, children):
    return BlockedPlan(**dict(zip(_PLAN_STATIC_FIELDS, aux)),
                       **dict(zip(_PLAN_ARRAY_FIELDS, children)))


# Registered as a pytree so a plan can cross jit boundaries as an ARGUMENT.
# This matters: closure-captured buffers are embedded in the program as
# constants (~350 MB on the reference mesh), while arguments stay on
# device.
jax.tree_util.register_pytree_node(BlockedPlan, _plan_flatten, _plan_unflatten)


def _onehot_device(idx, mask, width, dtype):
    """Materialize a (blocks, S, width) one-hot operator ON DEVICE from
    (blocks, S) int32 indices + bool mask (the parts _plan_struct emits).
    One fused compare-and-select pass writes the dense operator directly
    at its storage dtype and at device memory bandwidth — the
    multi-hundred-MB operators never exist host-side at all."""
    iota = jnp.arange(width, dtype=jnp.int32)
    return ((idx[..., None] == iota) & mask[..., None]).astype(dtype)


_onehot_device = jax.jit(_onehot_device, static_argnums=(2, 3))


def build_onehot(parts, dtype):
    """parts = (idx, mask, width) from _plan_struct's onehot()."""
    idx, mask, width = parts
    return _onehot_device(jnp.asarray(idx), jnp.asarray(mask), width,
                          np.dtype(dtype).name)


def _plan_struct(n, cells, cols, pmask, bc, nb, build_rc=True):
    """Structural (degree-agnostic) part of a blocked plan from a dof map:
    window geometry, per-block cell lists, component-major one-hot
    operators, patch adjacency and bc masks — all host NumPy.

    cells: (M, nd) dof indices per cell (nd = 3 for P1, 6 for P2, ...).
    build_rc=False skips the 9C-wide Rrow/Ccol assembly one-hots (the
    factored assembly in assemble_matrix_components only needs Gcell/Sv;
    Pk plans never build them)."""
    nd = cells.shape[1]
    offs = cols - np.arange(n)[:, None]
    B = int(np.abs(offs[pmask]).max())
    blocks = -(-n // nb)
    W = nb + 2 * B
    lane = 128
    Wpad = -(-W // lane) * lane
    assert Wpad % nb == 0, "nb must divide the 128-lane padded width"
    k_chunks = Wpad // nb
    pad_hi = (blocks + k_chunks - 1) * nb - B - n
    assert pad_hi >= 0

    # --- per-block cell lists (a cell joins every block owning >=1 dof) ---
    cell_blk = cells // nb                       # (M,nd)
    m_idx = np.repeat(np.arange(cells.shape[0]), nd)
    pairs = np.unique(np.stack([cell_blk.reshape(-1), m_idx], 1), axis=0)
    blk_of, m_of = pairs[:, 0], pairs[:, 1]
    counts = np.bincount(blk_of, minlength=blocks)
    C = int(-(-counts.max() // 8) * 8)           # pad to sublane multiple
    cell_id = np.full((blocks, C), -1, dtype=np.int64)
    # pairs are sorted by (blk, m); per-block slots are consecutive
    off = np.concatenate([[0], np.cumsum(counts)])
    slot = np.arange(len(blk_of)) - off[blk_of]
    cell_id[blk_of, slot] = m_of
    valid = cell_id >= 0
    safe_id = np.where(valid, cell_id, 0)

    # --- one-hot operators ---
    win_start = (np.arange(blocks) * nb - B)[:, None, None]   # (blocks,1,1)
    nodes = np.where(valid[:, :, None], cells[safe_id], -10**9)  # (b,C,nd)
    wpos = nodes - win_start                                  # window coord
    rpos = nodes - (np.arange(blocks) * nb)[:, None, None]    # local row
    own = (rpos >= 0) & (rpos < nb) & valid[:, :, None]
    in_win = (wpos >= 0) & (wpos < W) & valid[:, :, None]
    assert bool(in_win[valid].all()), "cell dof outside its block window"

    def onehot(idx, mask, width):
        """(blocks, S) index + mask -> PARTS for build_onehot. The dense
        (blocks, S, width) operator is materialized ON DEVICE from these
        few-MB integer arrays: host-touching the multi-GB f32 zeros +
        fancy-scatter + dtype-convert + upload dominated plan build
        (measured on a 1-core host at N=19.9k: 174 s total, ~all here)."""
        return (np.where(mask, idx, 0).astype(np.int32),
                np.ascontiguousarray(mask), int(width))

    # COMPONENT-MAJOR contribution ordering: s = a*C + c (vectors) and
    # s2 = (nd*a + a2)*C + c (matrices). An (S, nd)-interleaved
    # layout forces nd-wide (padded) arrays through every
    # quadrature op — component-major keeps all cell fields as clean
    # (blocks, C) planes (see gather_components / the *_components
    # kernels below).
    cm = lambda arr: arr.transpose(0, 2, 1).reshape(blocks, -1)
    Gcell = onehot(cm(wpos), cm(in_win), Wpad)
    Sv = onehot(cm(np.where(own, rpos, 0)), cm(own), nb)
    Rrow = Ccol = None
    if build_rc:
        # contributions (c, nd*a + a2): row from dof a, column from dof a2
        r2 = cm(np.repeat(rpos, nd, axis=2))        # r of a at slot nd*a+a2
        own2 = cm(np.repeat(own, nd, axis=2))
        w2 = cm(np.tile(wpos, (1, 1, nd)))          # col of a2
        inw2 = cm(np.tile(in_win, (1, 1, nd)))
        both = own2 & inw2
        Rrow = onehot(np.where(both, r2, 0), both, nb)
        Ccol = onehot(np.where(both, w2, 0), both, Wpad)

    # --- patch adjacency in window coords ---
    A = np.zeros((blocks, nb, Wpad), dtype=bool)
    rows_global = np.arange(blocks * nb).reshape(blocks, nb)
    row_ok = rows_global < n
    safe_rows = np.where(row_ok, rows_global, 0)
    pc = cols[safe_rows]                     # (blocks, nb, K)
    pm = pmask[safe_rows] & row_ok[:, :, None]
    wcol = pc - (np.arange(blocks) * nb - B)[:, None, None]
    bb, rr, kk = np.nonzero(pm)
    A[bb, rr, wcol[bb, rr, kk]] = True
    patch_deg = np.maximum(A.sum(axis=2), 1).astype(np.float64)

    bc_row = np.where(row_ok, bc[safe_rows], False)
    wg = (np.arange(blocks) * nb - B)[:, None] + np.arange(Wpad)[None, :]
    in_range = (wg >= 0) & (wg < n)
    bc_win = np.where(in_range, bc[np.where(in_range, wg, 0)], False)

    diag_eye = np.zeros((nb, Wpad))
    diag_eye[np.arange(nb), np.arange(nb) + B] = 1.0

    return dict(n=n, nd=nd, nb=nb, B=B, blocks=blocks, W=W, Wpad=Wpad,
                C=C, pad_hi=pad_hi, valid=valid, safe_id=safe_id,
                Gcell=Gcell, Sv=Sv, Rrow=Rrow, Ccol=Ccol, A=A,
                patch_deg=patch_deg, bc_row=bc_row, bc_win=bc_win,
                diag_eye=diag_eye)


class WindowCoverageError(ValueError):
    """A dof/patch column fell outside the tiled 3-run window — the tile
    neighbourhood halfwidth k is too small for this mesh/layout."""


def _plan_struct_tiled(n_slots, cells, cols, pmask, bc, nb, T, k):
    """Tiled-window twin of _plan_struct (see ops/tiling for the layout).

    Window of block b = 3 runs of rw = 2k+1 blocks at block offsets
    run_off = (-T-k, -k, T-k); window coord of global row g is
    r*rw*nb + (g - (b + run_off[r])*nb) for the first covering run r.
    W = 3*rw*nb, independent of N. Raises WindowCoverageError when any
    cell dof or patch column of a block is not covered (k too small).
    """
    nd = cells.shape[1]
    assert n_slots % nb == 0, "tiled layout must be slot-padded to nb"
    blocks = n_slots // nb
    rw = 2 * k + 1
    if T <= rw:
        raise WindowCoverageError(
            f"tile stride T={T} <= run width {rw}: mesh too small for the "
            f"tiled layout — use the 1D RCM blocked backend")
    run_off = (-T - k, -k, T - k)
    W = 3 * rw * nb
    lane = 128
    Wpad = -(-W // lane) * lane
    B_diag = (rw + k) * nb                     # window diagonal offset

    def wcoord(b, g):
        """Window coords (same shapes broadcast); -1 = not covered."""
        blk = np.floor_divide(g, nb)
        delta = blk - b
        pos = np.full(np.broadcast(b, g).shape, -1, dtype=np.int64)
        for r, o in enumerate(run_off):
            sel = (delta >= o) & (delta <= o + rw - 1) & (pos < 0)
            pos = np.where(sel, r * rw * nb + g - (b + o) * nb, pos)
        return pos

    # --- per-block cell lists (identical to _plan_struct) ---
    cell_blk = cells // nb
    m_idx = np.repeat(np.arange(cells.shape[0]), nd)
    pairs = np.unique(np.stack([cell_blk.reshape(-1), m_idx], 1), axis=0)
    blk_of, m_of = pairs[:, 0], pairs[:, 1]
    counts = np.bincount(blk_of, minlength=blocks)
    C = int(-(-counts.max() // 8) * 8)
    cell_id = np.full((blocks, C), -1, dtype=np.int64)
    off = np.concatenate([[0], np.cumsum(counts)])
    slot = np.arange(len(blk_of)) - off[blk_of]
    cell_id[blk_of, slot] = m_of
    valid = cell_id >= 0
    safe_id = np.where(valid, cell_id, 0)

    # --- one-hot operators (window coords via wcoord) ---
    barr = np.arange(blocks)[:, None, None]
    nodes = np.where(valid[:, :, None], cells[safe_id], -(10 ** 9))
    wpos = wcoord(barr, nodes)
    rpos = nodes - np.arange(blocks)[:, None, None] * nb
    own = (rpos >= 0) & (rpos < nb) & valid[:, :, None]
    in_win = (wpos >= 0) & valid[:, :, None]
    if not bool((wpos[valid] >= 0).all()):
        raise WindowCoverageError(
            f"cell dof outside the 3-run window at k={k}")

    def onehot(idx, mask, width):
        return (np.where(mask, idx, 0).astype(np.int32),
                np.ascontiguousarray(mask), int(width))

    cm = lambda arr: arr.transpose(0, 2, 1).reshape(blocks, -1)
    Gcell = onehot(cm(wpos), cm(in_win), Wpad)
    Sv = onehot(cm(np.where(own, rpos, 0)), cm(own), nb)

    # --- patch adjacency in window coords ---
    A = np.zeros((blocks, nb, Wpad), dtype=bool)
    rows_global = np.arange(blocks * nb).reshape(blocks, nb)
    pc = cols[rows_global]                   # (blocks, nb, K)
    pm = pmask[rows_global]
    wcol = wcoord(np.arange(blocks)[:, None, None], pc)
    if not bool((wcol[pm] >= 0).all()):
        raise WindowCoverageError(
            f"patch column outside the 3-run window at k={k}")
    bb, rr, kk = np.nonzero(pm)
    A[bb, rr, wcol[bb, rr, kk]] = True
    patch_deg = np.maximum(A.sum(axis=2), 1).astype(np.float64)

    bc_row = bc[rows_global]
    # global row of each window column: col -> (run, chunk, lane)
    col = np.arange(Wpad)
    r_of = np.minimum(col // (rw * nb), 2)
    base = (np.asarray(run_off)[r_of] * nb + (col - r_of * rw * nb))
    wg = np.arange(blocks)[:, None] * nb + base[None, :]
    in_range = (wg >= 0) & (wg < n_slots) & (col[None, :] < W)
    bc_win = np.where(in_range, bc[np.where(in_range, wg, 0)], False)

    diag_eye = np.zeros((nb, Wpad))
    diag_eye[np.arange(nb), np.arange(nb) + B_diag] = 1.0

    return dict(n=n_slots, nd=nd, nb=nb, B=B_diag, blocks=blocks, W=W,
                Wpad=Wpad, C=C, pad_hi=0, valid=valid, safe_id=safe_id,
                Gcell=Gcell, Sv=Sv, Rrow=None, Ccol=None, A=A,
                patch_deg=patch_deg, bc_row=bc_row, bc_win=bc_win,
                diag_eye=diag_eye, run_off=run_off, rw=rw)


def make_tiled_plan(mesh: Mesh, nb: int = 128, dtype=jnp.float32,
                    precise: bool = False, k: int | None = None,
                    need_patch_sum: bool = False) -> BlockedPlan:
    """Build the 2D tiled-window P1 plan (see ops/tiling + the tiled
    fields of BlockedPlan). The mesh must come from tiling.tile_mesh /
    pad_mesh_to_slots (slot numbering, mesh.tile_T/slot_valid set).

    k (tile neighbourhood halfwidth) is auto-raised 1->3 until every
    cell dof and patch column is covered; jittered-Delaunay meshes of
    near-uniform density need k=1-2.
    """
    if not mesh.tile_T:
        raise ValueError("make_tiled_plan needs a tiling.tile_mesh mesh "
                         "(tile_T/slot_valid set)")
    cells = np.asarray(mesh.cells, dtype=np.int64)
    ks = (k,) if k is not None else (1, 2, 3)
    st = None
    for kk in ks:
        try:
            st = _plan_struct_tiled(
                mesh.n_nodes, cells, mesh.patch_cols, mesh.patch_mask,
                mesh.boundary_mask, nb, int(mesh.tile_T), kk)
            break
        except WindowCoverageError:
            if kk == ks[-1]:
                raise
    valid, safe_id = st["valid"], st["safe_id"]
    area_b = np.where(valid, mesh.area[safe_id], 0.0)
    grads_b = np.where(valid[:, :, None, None], mesh.grads[safe_id], 0.0)
    h_cell_b = np.where(valid, np.asarray(mesh.h_cell)[safe_id], 0.0)
    f = lambda x: jnp.asarray(x, dtype)
    precise = bool(precise) and jnp.dtype(dtype) == jnp.float32
    oh_dtype = (jnp.bfloat16 if jnp.dtype(dtype) == jnp.float32
                and not precise else jnp.float32)
    return BlockedPlan(
        n=st["n"], nb=nb, B=st["B"], blocks=st["blocks"], W=st["W"],
        Wpad=st["Wpad"], C=st["C"], pad_hi=st["pad_hi"], precise=precise,
        run_off=st["run_off"], rw=st["rw"],
        row_valid=jnp.asarray(np.asarray(mesh.slot_valid)),
        Gcell=build_onehot(st["Gcell"], oh_dtype),
        Sv=build_onehot(st["Sv"], oh_dtype),
        Rrow=None, Ccol=None,
        # A_float (patch_sum / smooth_vector only) is a W-wide f32
        # operator — ~1.8 GiB at N=400k; skip it unless smoothing is on
        A_bool=jnp.asarray(st["A"]),
        A_float=f(st["A"]) if need_patch_sum else None,
        area_b=f(area_b), grads_b=f(grads_b),
        gx3=f(grads_b[:, :, :, 0].transpose(0, 2, 1)),
        gy3=f(grads_b[:, :, :, 1].transpose(0, 2, 1)),
        bc_row=jnp.asarray(st["bc_row"]), bc_win=jnp.asarray(st["bc_win"]),
        diag_eye=f(st["diag_eye"]), patch_deg=f(st["patch_deg"]),
        h_cell_b=f(h_cell_b),
    )


def make_blocked_plan(mesh: Mesh, nb: int = 128, dtype=jnp.float32,
                      precise: bool = False) -> BlockedPlan:
    """Build the P1 plan (host NumPy, runs once per mesh).

    The mesh should be RCM-ordered (ops/mesh.reorder_mesh(rcm_permutation))
    so the bandwidth B — and with it every one-hot operator — stays
    O(sqrt(N)).

    precise=True (f32 compute only): store the one-hots at f32 and run
    every contraction at Precision.HIGHEST, so the device matches
    plain-f32 CPU arithmetic instead of rounding dot operands (bf16
    one-hots; TF32 at default precision on the H100). Long smooth-
    transport horizons (the 569-step rotation on the reference disk mesh)
    are diffused by bf16 streams and need it; shock-dominated short-
    horizon runs (KPP, Burgers) stay within their accuracy gates at bf16,
    which remains the throughput default there.
    """
    st = _plan_struct(mesh.n_nodes, np.asarray(mesh.cells, dtype=np.int64),
                      mesh.patch_cols, mesh.patch_mask, mesh.boundary_mask,
                      nb, build_rc=False)
    valid, safe_id = st["valid"], st["safe_id"]
    area_b = np.where(valid, mesh.area[safe_id], 0.0)
    grads_b = np.where(valid[:, :, None, None], mesh.grads[safe_id], 0.0)
    h_cell_b = np.where(valid, np.asarray(mesh.h_cell)[safe_id], 0.0)

    f = lambda x: jnp.asarray(x, dtype)
    # One-hot operators hold exact 0/1 values — bfloat16 represents them
    # exactly, so storing them at half the bytes halves the dominant
    # streams (Gcell+Sv+Rrow+Ccol = 437 MB f32 on the reference mesh).
    # The operand they multiply is rounded to bf16 too (_oh_apply), so an
    # f32 blocked run differs from a plain f32 einsum at ~1e-3 per step;
    # the f32 runs are gated against f64 anchors instead (chip_smoke.py
    # irr140). For f64 compute the one-hots stay f32: promotion into a
    # f64 einsum is exact, keeping the 1e-12 ELL-identity tests intact —
    # do not identity-compare f32 blocked runs.
    # precise=True opts out of bf16 entirely (f32 one-hots + HIGHEST
    # dots) on BOTH backends — the long-smooth-horizon quality mode.
    precise = bool(precise) and jnp.dtype(dtype) == jnp.float32
    oh_dtype = (jnp.bfloat16 if jnp.dtype(dtype) == jnp.float32
                and not precise else jnp.float32)
    return BlockedPlan(
        n=st["n"], nb=nb, B=st["B"], blocks=st["blocks"], W=st["W"],
        Wpad=st["Wpad"], C=st["C"], pad_hi=st["pad_hi"], precise=precise,
        Gcell=build_onehot(st["Gcell"], oh_dtype),
        Sv=build_onehot(st["Sv"], oh_dtype),
        Rrow=None, Ccol=None,
        A_bool=jnp.asarray(st["A"]), A_float=f(st["A"]),
        area_b=f(area_b), grads_b=f(grads_b),
        gx3=f(grads_b[:, :, :, 0].transpose(0, 2, 1)),
        gy3=f(grads_b[:, :, :, 1].transpose(0, 2, 1)),
        bc_row=jnp.asarray(st["bc_row"]), bc_win=jnp.asarray(st["bc_win"]),
        diag_eye=f(st["diag_eye"]), patch_deg=f(st["patch_deg"]),
        h_cell_b=f(h_cell_b),
    )


# ---------------------------------------------------------------------------
# window extraction (static slices — the gather-free primitive)
# ---------------------------------------------------------------------------


def windows(plan: BlockedPlan, x):
    """x (n,) -> (blocks, Wpad) with w[b, i] = x[b*nb - B + i] (0 outside).

    Tiled plans (run_off set): w[b] is instead the concatenation of the
    3 runs x[(b + o_r)*nb : (b + o_r + rw)*nb] — still nothing but
    static slices of a padded x, at a width independent of N."""
    if getattr(plan, "run_off", None) is not None:
        lpad = -plan.run_off[0] * plan.nb
        xp = jnp.pad(x, (lpad, lpad))
        span = plan.blocks * plan.nb
        chunks = [
            jax.lax.slice(xp, ((lpad + (o + q) * plan.nb),),
                          (lpad + (o + q) * plan.nb + span,))
            .reshape(plan.blocks, plan.nb)
            for o in plan.run_off for q in range(plan.rw)
        ]
        w = jnp.concatenate(chunks, axis=1)
        if plan.Wpad > plan.W:
            w = jnp.pad(w, ((0, 0), (0, plan.Wpad - plan.W)))
        return w
    xp = jnp.pad(x, (plan.B, plan.pad_hi))
    k = plan.Wpad // plan.nb
    span = plan.blocks * plan.nb
    chunks = [
        jax.lax.slice(xp, (q * plan.nb,), (q * plan.nb + span,))
        .reshape(plan.blocks, plan.nb)
        for q in range(k)
    ]
    return jnp.concatenate(chunks, axis=1)


def rows_of(plan: BlockedPlan, w):
    """The (blocks, nb) view of the owned rows inside windows."""
    return jax.lax.slice(w, (0, plan.B), (plan.blocks, plan.B + plan.nb))


def unblock(plan: BlockedPlan, y):
    """(blocks, nb) -> (n,)."""
    return y.reshape(-1)[: plan.n]


# ---------------------------------------------------------------------------
# operator application / assembly
# ---------------------------------------------------------------------------


def plan_precision(plan):
    """Dot precision for a plan's contractions.

    precise plans (f32 one-hots) need Precision.HIGHEST — default
    precision may round f32 dot operands (TF32 on the H100), which would
    silently undo the f32 storage (see make_blocked_plan). Returns None
    (default precision) for bf16 and f64 plans: bf16 plans take the
    explicit half-width branches, and f64 contractions are never
    rounded."""
    return (jax.lax.Precision.HIGHEST
            if getattr(plan, "precise", False) else None)


def sweep_form(plan: BlockedPlan, D):
    """Half-width (bf16) copy of an assembled operator for Krylov sweeps.

    Storing the operator at bf16 halves the sweep's bytes — the dominant
    per-iteration stream once N*(nb+2B) floats stop fitting in caches —
    at bf16 rounding of the operator (the f32 runs' anchor gates cover
    it).
    Cast ONCE where the operator is built (outside the solver loop), never
    inside a matvec closure body — a per-matvec convert re-reads f32 and
    cancels the saving. f64 compute (all identity tests) returns D
    unchanged. f32 runs differ from plain-f32 sweeps at ~bf16 eps, like
    the bf16 one-hots above."""
    return sweep_form_arrays(plan.Gcell.dtype, D)


def sweep_form_arrays(oh_dtype, D):
    """Array-level sweep_form: the dtype gate keyed on the plan's
    one-hot dtype. Shared with the sharded twins, which close over
    unsharded plan ARRAYS inside shard_map rather than plan objects —
    one definition of the bf16 stream semantics for all four modules."""
    if oh_dtype == jnp.bfloat16 and D.dtype == jnp.float32:
        return D.astype(jnp.bfloat16)
    return D


def spmv_windows(D, w, precision=None):
    """y[b] = D[b] @ w[b] on already-extracted (blocks, Wpad) windows —
    the array-level contraction core of spmv, shared with the sharded
    twins. A bf16 D (sweep_form) keeps both operand streams at half
    width; f32 with precision=HIGHEST is the precise-plan mode."""
    if D.dtype == jnp.bfloat16:
        return jax.lax.dot_general(
            D, w.astype(jnp.bfloat16), (((2,), (1,)), ((0,), (0,))),
            preferred_element_type=w.dtype)
    return jnp.einsum("bnw,bw->bn", D, w, precision=precision)


def spmv(plan: BlockedPlan, D, x):
    """y = A x with A in (blocks, nb, Wpad) dense row-window storage.
    A bf16 A (sweep_form) keeps both operand streams at half width."""
    return unblock(plan, spmv_windows(D, windows(plan, x),
                                      plan_precision(plan)))


def diag_of(plan: BlockedPlan, D):
    """Matrix diagonal: window position of col i on row i is r + B."""
    d = jnp.diagonal(D, offset=plan.B, axis1=1, axis2=2)
    return unblock(plan, d[:, : plan.nb])


def _oh_apply(A, x, contract_dim, out_dtype, precision=None):
    """Batched one-hot GEMV y[b, free] = sum_k A[b, ..k..] x[b, k],
    contracting A's `contract_dim` with x's dim 1 (batch dim 0).

    When A is stored bf16 (f32 compute), x is rounded to bf16 so BOTH
    operand streams stay at half width (a bf16 product with f32
    accumulation). For wider A (f64 compute / precise f32
    plans) this is a plain einsum-equivalent dot with exact promotion;
    precise plans pass Precision.HIGHEST here (plan_precision)."""
    if A.dtype == jnp.bfloat16:
        x = x.astype(jnp.bfloat16)
        precision = None
    else:
        out_dtype = jnp.promote_types(A.dtype, x.dtype)
        A = A.astype(out_dtype)
        x = x.astype(out_dtype)
    return jax.lax.dot_general(
        A, x, (((contract_dim,), (1,)), ((0,), (0,))),
        preferred_element_type=out_dtype, precision=precision)


def gather_components(plan: BlockedPlan, x):
    """u[cells] componentwise: (blocks, 3, C); padded cells give 0.

    The native form of the component-major one-hots — each local basis
    slot a is a clean (blocks, C) lane plane, so quadrature kernels never
    touch 3-wide trailing dims (which device layouts pad)."""
    w = windows(plan, x)
    uc = _oh_apply(plan.Gcell, w, 2, x.dtype,
                   precision=plan_precision(plan))   # "bsw,bw->bs"
    return uc.reshape(plan.blocks, plan.nd, plan.C)


def scatter_components(plan: BlockedPlan, v3):
    """(blocks, nd, C) componentwise local vectors -> (n,) accumulation."""
    v = v3.reshape(plan.blocks, plan.nd * plan.C)
    y = _oh_apply(plan.Sv, v, 1, v3.dtype,
                  precision=plan_precision(plan))    # "bsn,bs->bn"
    return unblock(plan, y)


def gather_cells(plan: BlockedPlan, x):
    """u[cells] in blocked layout: (blocks, C, 3); padded cells give 0."""
    return gather_components(plan, x).transpose(0, 2, 1)


def scatter_cell_vectors(plan: BlockedPlan, vals):
    """(blocks, C, 3) local vectors -> (n,) nodal accumulation."""
    return scatter_components(plan, vals.transpose(0, 2, 1))


def assemble_from_onehots(Rrow, Ccol, v, out_dtype):
    """out[b,r,w] = sum_s Rrow[b,s,r] v[b,s] Ccol[b,s,w] — the two-sided
    one-hot assembly GEMM, shared with the sharded twin. bf16 one-hots
    keep both GEMM streams at half HBM width (see _oh_apply)."""
    if Rrow.dtype == jnp.bfloat16:
        lhs = Rrow * v[:, :, None].astype(jnp.bfloat16)
        return jax.lax.dot_general(
            lhs, Ccol, (((1,), (1,)), ((0,), (0,))),
            preferred_element_type=out_dtype)
    return jnp.einsum("bsr,bsw->brw", Rrow * v[:, :, None], Ccol)


def assemble_matrix_components(plan: BlockedPlan, L9):
    """(blocks, 9, C) componentwise locals (slot 3a+b = row a, col b) ->
    (blocks, nb, Wpad) assembled operator.

    Uses the FACTORED contraction: the 9C-wide Rrow/Ccol one-hots are
    component tiles of Sv/Gcell (row(s) for slot (3a+b)C+c is Sv's
    component-a one-hot; col(s) is Gcell's component-b), so
      D = sum_b dot(T_b, Gc_b)  with  T_b = sum_a Sv_a * L_ab
    runs as 3 GEMMs with 3x fewer MACs and ~30% less HBM than the single
    9C-wide GEMM (T folds the row-component sum elementwise). Same
    contributions; summation order differs by roundoff."""
    C, nd, dt_ = plan.C, plan.nd, L9.dtype
    bf = plan.Sv.dtype == jnp.bfloat16
    L = L9.astype(jnp.bfloat16) if bf else L9
    Sv = plan.Sv if bf else plan.Sv.astype(dt_)
    Gc = plan.Gcell if bf else plan.Gcell.astype(dt_)
    prec = None if bf else plan_precision(plan)
    out = 0.0
    for b in range(nd):
        T = sum(Sv[:, a * C:(a + 1) * C] * L[:, nd * a + b][:, :, None]
                for a in range(nd))                   # (blocks, C, nb)
        out = out + jax.lax.dot_general(
            T, Gc[:, b * C:(b + 1) * C],
            (((1,), (1,)), ((0,), (0,))),
            preferred_element_type=dt_,
            precision=prec)                           # (blocks, nb, Wpad)
    return out


def assemble_matrix(plan: BlockedPlan, cellmats):
    """(blocks, C, 3, 3) local matrices -> (blocks, nb, Wpad) operator."""
    return assemble_matrix_components(
        plan, cellmats.transpose(0, 2, 3, 1).reshape(plan.blocks, 9, plan.C))


def local_apply(plan: BlockedPlan, L, x):
    """Matrix-free operator application y = A(L) x from per-cell local
    matrices L (blocks, C, 3, 3): gather x to cells, apply the 3x3 locals,
    scatter back. Same contributions as assemble_matrix+spmv (summation
    order differs by roundoff only — tests assert 1e-12 f64 identity).
    FLOP-cheap but bandwidth-heavy: every call re-streams Gcell+Sv while
    an assembled window spmv reads one window, so it only pays when an
    operator is applied a couple of times; per-step Krylov operators are
    assembled by default (HyperbolicConfig.blocked_matrix_free, off)."""
    uc = gather_cells(plan, x)                       # (blocks, C, 3)
    yc = jnp.einsum("zcad,zcd->zca", L, uc,
                    precision=plan_precision(plan))
    return scatter_cell_vectors(plan, yc)


# ---------------------------------------------------------------------------
# componentwise quadrature kernels (the blocked-path hot quadratures)
#
# Twins of assembly.local_convection_rhs / local_eps_stiffness /
# local_flux_jacobian operating on (blocks, C) component planes instead of
# (M, 3)/(M, Q)-shaped arrays. Same math, same Dunavant rule; the point is
# layout: device layouts pad small trailing dims, so (M, 6) quad-point
# and (M, 3, 2) gradient arrays cost a multiple of their data.
# Componentwise planes keep the trailing dim at C (a 128-multiple-friendly
# cell count). Summation order differs from the (M,3) kernels only within
# einsum reductions (identity tests hold at 1e-12 f64).
# ---------------------------------------------------------------------------


def _quad_consts(dtype):
    # host NumPy throughout (callable mid-trace: _quad_basis() would emit
    # traced ops on the module constants and leak tracers)
    from conservation_fem_tpu.ops import assembly

    pts = np.asarray(assembly._DUN4_P, np.float64)           # (Q, 2)
    x, y = pts[:, 0], pts[:, 1]
    phi = np.stack([1.0 - x - y, x, y], axis=1)              # (Q, 3)
    qw = np.asarray(assembly._DUN4_W, np.float64) * 0.5      # ref area 1/2
    return phi, qw


def conv_rhs_components(plan: BlockedPlan, u, fpx, fpy, gather=None,
                        scatter=None):
    """N(u)_a = int (f'(u_h) . grad u_h) phi_a dx -> (n,) nodal vector.

    Componentwise twin of assembly.convection_rhs_flux (ref
    Code/KPP/KPP_NodeRV.py:53-55 velocity_field / the convection form);
    fpx/fpy are the componentwise flux derivative (models expose
    flux_prime_xy). gather/scatter: sharded overrides (halo'd windows on
    a per-device local plan view)."""
    return conv_plus_locals_rhs_components(plan, u, fpx, fpy, None,
                                           gather, scatter)


def mass_locals_components(plan: BlockedPlan, dtype=None):
    """P1 mass locals -> (blocks, 9, C): L_ab = area * (1 + delta_ab)/12
    (twin of assembly.local_mass in component-major slot order 3a+b)."""
    area = plan.area_b if dtype is None else plan.area_b.astype(dtype)
    rows = [area * ((2.0 if a == b else 1.0) / 12.0)
            for a in range(3) for b in range(3)]
    return jnp.stack(rows, axis=1)


def conv_plus_locals_rhs_components(plan: BlockedPlan, u, fpx, fpy,
                                    L9=None, gather=None, scatter=None):
    """(N(u) + A(L9) u)_a in ONE gather/scatter pass -> (n,).

    The CN residual needs the eps-stiffness ACTION K_eps v alongside the
    convection quadrature N(v); both read the same gathered cell values,
    so fusing them saves the whole windowed Keps assembly GEMM (the
    operator form is never needed: the Newton Jacobian is assembled from
    the summed LOCALS instead, see blocked_hyperbolic._newton_cn)."""
    phi, qw = _quad_consts(u.dtype)
    f = lambda c: jnp.asarray(c, u.dtype)
    gather = gather or (lambda v: gather_components(plan, v))
    scatter = scatter or (lambda v3: scatter_components(plan, v3))
    uc = gather(u)                                   # (blocks, 3, C)
    ua = [uc[:, a] for a in range(3)]
    gx = [plan.gx3[:, a] for a in range(3)]
    gy = [plan.gy3[:, a] for a in range(3)]
    gu_x = sum(ua[a] * gx[a] for a in range(3))
    gu_y = sum(ua[a] * gy[a] for a in range(3))
    r = [0.0, 0.0, 0.0]
    for q in range(phi.shape[0]):
        u_q = sum(f(phi[q, a]) * ua[a] for a in range(3))
        conv_q = fpx(u_q) * gu_x + fpy(u_q) * gu_y
        for a in range(3):
            r[a] = r[a] + f(qw[q] * phi[q, a]) * conv_q
    area2 = 2.0 * plan.area_b
    v3 = jnp.stack(
        [area2 * r[a]
         + (sum(L9[:, 3 * a + b] * ua[b] for b in range(3))
            if L9 is not None else 0.0)
         for a in range(3)], axis=1)
    return scatter(v3)


def eps_locals_components(plan: BlockedPlan, eps, gather=None):
    """eps-weighted stiffness locals -> (blocks, 9, C) (slot 3a+b).

    Twin of assembly.local_eps_stiffness: L_ab = area * mean(eps_cell)
    * (g_a . g_b)."""
    gather = gather or (lambda v: gather_components(plan, v))
    ec = gather(eps)                                 # (blocks, 3, C)
    scale = plan.area_b * (ec[:, 0] + ec[:, 1] + ec[:, 2]) / 3.0
    gx, gy = plan.gx3, plan.gy3
    rows = [scale * (gx[:, a] * gx[:, b] + gy[:, a] * gy[:, b])
            for a in range(3) for b in range(3)]
    return jnp.stack(rows, axis=1)


def flux_jacobian_locals_components(plan: BlockedPlan, u, fpx, fpy,
                                    gather=None):
    """Jacobian locals of the convection rhs -> (blocks, 9, C).

    Twin of assembly.local_flux_jacobian:
      J_ab = int [ (f''(u).grad u) phi_b + f'(u).grad phi_b ] phi_a dx
    with f'' from elementwise jvp of fpx/fpy."""
    phi, qw = _quad_consts(u.dtype)
    f = lambda c: jnp.asarray(c, u.dtype)
    gather = gather or (lambda v: gather_components(plan, v))
    uc = gather(u)
    ua = [uc[:, a] for a in range(3)]
    gx = [plan.gx3[:, a] for a in range(3)]
    gy = [plan.gy3[:, a] for a in range(3)]
    gu_x = sum(ua[a] * gx[a] for a in range(3))
    gu_y = sum(ua[a] * gy[a] for a in range(3))
    L = [[0.0] * 3 for _ in range(3)]
    for q in range(phi.shape[0]):
        u_q = sum(f(phi[q, a]) * ua[a] for a in range(3))
        one = jnp.ones_like(u_q)
        fx_v, fx_d = jax.jvp(fpx, (u_q,), (one,))
        fy_v, fy_d = jax.jvp(fpy, (u_q,), (one,))
        t1 = fx_d * gu_x + fy_d * gu_y
        for a in range(3):
            wphia = f(qw[q] * phi[q, a])
            for b in range(3):
                L[a][b] = L[a][b] + wphia * (
                    t1 * f(phi[q, b]) + fx_v * gx[b] + fy_v * gy[b])
    area2 = 2.0 * plan.area_b
    return jnp.stack([area2 * L[a][b]
                      for a in range(3) for b in range(3)], axis=1)


def local_diag(plan: BlockedPlan, L):
    """Diagonal of the operator assembled from local matrices L:
    diag_i = sum over cells of L[c, a, a] with cells[c, a] == i."""
    d = jnp.einsum("zcaa->zca", L)
    return scatter_cell_vectors(plan, d)


def apply_bc_matrix(plan: BlockedPlan, D):
    """DOLFINx assemble_matrix(a, bcs) semantics (cf. ops/bc.ell_with_bc):
    zero bc rows and bc columns, unit diagonal on bc rows."""
    D = jnp.where(plan.bc_row[:, :, None], 0.0, D)
    D = jnp.where(plan.bc_win[:, None, :], 0.0, D)
    return D + plan.diag_eye[None] * plan.bc_row[:, :, None].astype(D.dtype)


def constrained_matvec(plan: BlockedPlan, D, x, bc_mask):
    """y = A_bc x with bc rows/cols pinned (cf. ops/bc.constrained_matvec)."""
    x_in = jnp.where(bc_mask, 0.0, x)
    y = spmv(plan, D, x_in)
    return jnp.where(bc_mask, x, y)


# ---------------------------------------------------------------------------
# patch reductions (stabilization kernels, window form)
# ---------------------------------------------------------------------------


def patch_max(plan: BlockedPlan, x):
    w = windows(plan, x)
    v = jnp.where(plan.A_bool, w[:, None, :], -jnp.inf)
    return unblock(plan, v.max(axis=2))


def patch_min(plan: BlockedPlan, x):
    w = windows(plan, x)
    v = jnp.where(plan.A_bool, w[:, None, :], jnp.inf)
    return unblock(plan, v.min(axis=2))


def patch_abs_max(plan: BlockedPlan, x):
    w = jnp.abs(windows(plan, x))
    v = jnp.where(plan.A_bool, w[:, None, :], 0.0)
    return unblock(plan, v.max(axis=2))


def patch_sum(plan: BlockedPlan, x):
    """sum_{j in patch(i)} x_j (incl self) as a 0/1 SpMV."""
    if plan.A_float is None:
        raise ValueError(
            "this plan was built without A_float (need_patch_sum=False) "
            "— rebuild with need_patch_sum=True for smoothing/patch_sum")
    return spmv(plan, plan.A_float, x)


def rv_epsilon_nonlinear(plan: BlockedPlan, Cvel, Crv, uh, u_n,
                         fprime_norm, Rh, h, precise=False, valid=None):
    """Window-form twin of stabilization.rv_epsilon_nonlinear
    (ref Code/Utils/RV.py:56-90); same math, same quirks. precise:
    f64-accumulated mean (precision.sum_acc64) so sharded twins that
    psum f64 partials agree at f64-order eps (precise_reductions).
    valid: real-node mask for tiled slot layouts — the global mean and
    abs-deviation max must ignore the phantom padding slots."""
    if valid is not None:
        uv = jnp.where(valid, uh, 0.0)
        nreal = valid.sum().astype(uh.dtype)
        if precise:
            from conservation_fem_tpu.ops.precision import sum_acc64

            mean = sum_acc64(uv) / nreal
        else:
            mean = uv.sum() / nreal
        abs_term = jnp.abs(jnp.where(valid, uh - mean, 0.0)).max()
    else:
        if precise:
            from conservation_fem_tpu.ops.precision import sum_acc64

            mean = sum_acc64(uh) / uh.shape[0]
        else:
            mean = uh.mean()
        abs_term = jnp.abs(uh - mean).max()
    u_tilde = patch_max(plan, u_n) - patch_min(plan, u_n)
    n_i = jnp.abs(u_tilde - abs_term)
    Rh_i = patch_abs_max(plan, Rh)
    tiny = jnp.asarray(1e-300 if n_i.dtype == jnp.float64 else 1e-30,
                       n_i.dtype)
    R_i = Rh_i / jnp.maximum(n_i, tiny)
    beta = patch_max(plan, fprime_norm(uh))
    eps = jnp.minimum(Cvel * h * beta, Crv * h**2 * jnp.abs(R_i))
    if valid is not None:
        # phantom slots have empty patches: patch_max is -inf there and
        # eps becomes 0 * -inf = NaN — which would poison every one-hot
        # GEMM whose window covers the slot (0 * NaN = NaN in a dot).
        eps = jnp.where(valid, eps, 0.0)
    return eps


def rv_epsilon_linear(plan: BlockedPlan, Cvel, Crv, uh, u_n, w_norm, Rh, h,
                      precise=False):
    """Window-form twin of stabilization.rv_epsilon_linear
    (ref Code/Utils/RV.py:92-127); beta_i = |w_i| at the patch owner —
    the reference's quirk, reproduced (RV.py:113-114)."""
    if precise:
        from conservation_fem_tpu.ops.precision import sum_acc64

        mean = sum_acc64(uh) / uh.shape[0]
    else:
        mean = uh.mean()
    abs_term = jnp.abs(uh - mean).max()
    u_tilde = patch_max(plan, u_n) - patch_min(plan, u_n)
    n_i = jnp.abs(u_tilde - abs_term)
    Rh_i = patch_abs_max(plan, Rh)
    tiny = jnp.asarray(1e-300 if n_i.dtype == jnp.float64 else 1e-30,
                       n_i.dtype)
    R_i = Rh_i / jnp.maximum(n_i, tiny)
    return jnp.minimum(Cvel * h * w_norm, Crv * h**2 * jnp.abs(R_i))


def rv_epsilon_cell_max(plan: BlockedPlan, Cvel, Crv, residual_node,
                        beta_cell, valid_node):
    """Cell-based RV with the order-independent "max" node scatter —
    window twin of stabilization.rv_epsilon_cell(scatter="max")
    (ref RV_cell.py:182-195; the reference's last-cell-wins assignment
    order has no window form — documented deviation shared with
    parallel/unstructured_sharded.DistributedAdvection).

    beta_cell: (blocks, C) cell wavespeeds; valid_node: (n,) bool of real
    rows (pads excluded from the max)."""
    Rc = jnp.abs(gather_components(plan, residual_node)).max(axis=1)
    eps_k = jnp.minimum(Cvel * plan.h_cell_b * beta_cell,
                        Crv * plan.h_cell_b**2 * Rc)     # (blocks, C)
    rep = jnp.concatenate([eps_k] * plan.nd, axis=1)      # (blocks, ndC)
    own = plan.Sv > jnp.asarray(0.5, plan.Sv.dtype)
    y = jnp.where(own, rep[:, :, None], -jnp.inf).max(axis=1)
    return jnp.where(valid_node, unblock(plan, y), 0.0)


def si_alpha(plan: BlockedPlan, K_D, u, eps_floor=1e-8):
    """Window-form twin of stabilization.si_alpha (ref Code/Utils/SI.py:
    50-61): alpha_i = |sum_j b_ij du_ij| / max(sum_j |b_ij||du_ij|, eps).
    K_D entries outside the sparsity pattern are exact zeros, so no
    adjacency mask is needed (du there is multiplied by 0)."""
    w = windows(plan, u)
    u_r = rows_of(plan, w)                       # (blocks, nb)
    du = w[:, None, :] - u_r[:, :, None]         # (blocks, nb, Wpad)
    prec = plan_precision(plan)
    num = jnp.abs(jnp.einsum("brw,brw->br", K_D, du, precision=prec))
    den = jnp.einsum("brw,brw->br", jnp.abs(K_D), jnp.abs(du),
                     precision=prec)
    den = jnp.maximum(den, eps_floor)
    return unblock(plan, num / den)


def smooth_vector(plan: BlockedPlan, u, l: float):
    """Window-form twin of stabilization.smooth_vector
    (ref Code/Utils/helpers.py:40-50, Jacobi variant)."""
    neighbor_sum = patch_sum(plan, u) - u
    d = unblock(plan, plan.patch_deg) - 1.0
    d = jnp.maximum(d, 1.0)
    return (neighbor_sum + (l - 1.0) * d * u) / (l * d)
