"""Mesh data structures and mesh generation.

Replacement for the reference's gmsh + DOLFINx mesh layer
(ref: Code/Linear_advection/linear_advection.py:26-42 builds a gmsh disk,
Code/Burgers_equation/Exact_Burger_RV.py:28 a structured triangle rectangle,
Code/KPP/KPP_NodeRV.py:32-45 a gmsh rectangle).

A mesh here is nothing but dense arrays plus precomputed sparse structure:

  * ``points (N,2)`` / ``cells (M,3)``  — geometry/topology.
  * ``patch_cols (N,K)`` + ``patch_mask`` — ELL node-adjacency ("node patch",
    including self), the vectorized replacement of
    ``SI.get_patch_dictionary`` (ref Code/Utils/SI.py:12-28). The same layout
    stores assembled sparse operators, so stabilization kernels can gather
    stiffness entries without PETSc ``Mat.getValue`` calls
    (ref Code/Utils/SI.py:54).
  * per-cell geometry factors (area, P1 basis gradients, min edge length
    ``h_cell`` — ref Code/Utils/helpers.py:18-24).
  * sorted scatter orderings so per-cell assembly contributions can be
    accumulated with ``jax.ops.segment_sum(indices_are_sorted=True)`` —
    deterministic, replaces MPI ghost accumulation
    (ref linear_advection.py:165).

All construction is host-side NumPy (it runs once); everything consumed by
jitted kernels is exported via :meth:`Mesh.device_arrays`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

Array = np.ndarray


class MeshArrays(NamedTuple):
    """Device-resident mesh bundle consumed by jitted kernels.

    Float arrays are cast to the requested compute dtype; index arrays are
    int32. Static structure (N, M, K) is baked into shapes.
    """

    points: object        # (N,2) float
    cells: object         # (M,3) int32
    boundary_mask: object  # (N,) bool
    patch_cols: object    # (N,K) int32
    patch_mask: object    # (N,K) bool
    diag_slot: object     # (N,) int32
    cell_slots: object    # (M,3,3) int32 — ELL slot of local pair (a,b)
    area: object          # (M,) float
    grads: object         # (M,3,2) float
    h_cell: object        # (M,) float
    mat_perm: object      # (9M,) int32 — sort order for matrix scatter
    mat_segs: object      # (9M,) int32 — sorted flat targets row*K+slot
    vec_perm: object      # (3M,) int32 — sort order for vector scatter
    vec_segs: object      # (3M,) int32 — sorted row targets


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """An immutable 2D triangle mesh with precomputed sparse structure.

    ``eq=False``: identity hashing, so a Mesh can ride through jit as static
    metadata (same object -> cache hit)."""

    points: Array          # (N,2) f64
    cells: Array           # (M,3) i32
    boundary_mask: Array   # (N,) bool
    patch_cols: Array      # (N,K) i32, sorted cols, padded with row index
    patch_mask: Array      # (N,K) bool
    diag_slot: Array       # (N,) i32
    cell_slots: Array      # (M,3,3) i32
    area: Array            # (M,) f64
    grads: Array           # (M,3,2) f64
    h_cell: Array          # (M,) f64
    mat_perm: Array        # (9M,) i64
    mat_segs: Array        # (9M,) i64
    vec_perm: Array        # (3M,) i64
    vec_segs: Array        # (3M,) i64
    # True for meshes produced by make_periodic: cells index the surviving
    # master nodes while area/grads/h_cell keep the ORIGINAL (pre-fold)
    # coordinates, so recomputing geometry from points[cells] gives
    # stretched seam triangles. Consumers that derive geometry that way
    # (Pk build_space, plotting triangulations) must check this flag.
    periodic: bool = False
    # set by ops/tiling.pad_mesh_to_slots (the 2D tiled blocked layout):
    # slot_valid (N,) bool marks real nodes (False = phantom padding slot,
    # Dirichlet-pinned and cell-free); tile_T is the tile stride T (blocks
    # per strip) the tiled blocked plan needs. 0 = not a tiled mesh.
    slot_valid: Array = None
    tile_T: int = 0

    @property
    def n_nodes(self) -> int:
        return self.points.shape[0]

    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def max_patch(self) -> int:
        return self.patch_cols.shape[1]

    @property
    def boundary_nodes(self) -> Array:
        return np.nonzero(self.boundary_mask)[0]

    @property
    def hmin(self) -> float:
        return float(self.h_cell.min())

    def device_arrays(self, dtype=None) -> MeshArrays:
        """Export the mesh as a bundle of jax arrays at the given dtype."""
        import jax.numpy as jnp

        if dtype is None:
            dtype = jnp.float64 if jnp.zeros(0).dtype == jnp.float64 else jnp.float32
        f = lambda x: jnp.asarray(x, dtype=dtype)
        i = lambda x: jnp.asarray(x, dtype=jnp.int32)
        # lean structured meshes (rectangle_mesh_lean: patch_cols is the
        # (1,1) placeholder): the stencil path reads only points and the
        # boundary mask on device — uploading the O(M) cell arrays is
        # dead weight (GBs of host and device memory at mesh >= 2048).
        # Ship 1-element placeholders instead;
        # any generic-path consumer fails loudly on their shapes.
        lean = self.patch_cols.shape == (1, 1) and self.n_nodes > 1
        z1 = np.zeros(1, dtype=np.int64)
        return MeshArrays(
            points=f(self.points),
            cells=i(z1.reshape(1, 1) if lean else self.cells),
            boundary_mask=jnp.asarray(self.boundary_mask),
            patch_cols=i(self.patch_cols),
            patch_mask=jnp.asarray(self.patch_mask),
            diag_slot=i(self.diag_slot),
            cell_slots=i(self.cell_slots),
            area=f(z1 if lean else self.area),
            grads=f(z1.reshape(1, 1, 1) if lean else self.grads),
            h_cell=f(z1 if lean else self.h_cell),
            mat_perm=i(self.mat_perm),
            mat_segs=i(self.mat_segs),
            vec_perm=i(self.vec_perm),
            vec_segs=i(self.vec_segs),
        )


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------


def _cell_geometry(points: Array, cells: Array):
    """Per-cell area, P1 physical basis gradients and min edge length.

    Reference P1 basis on the unit triangle: N0 = 1-x-y, N1 = x, N2 = y with
    gradients [(-1,-1),(1,0),(0,1)]; physical gradients are J^{-T} @ ref_grad.
    """
    p = points[cells]                      # (M,3,2)
    e1 = p[:, 1] - p[:, 0]                 # (M,2)
    e2 = p[:, 2] - p[:, 0]
    det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    area = 0.5 * np.abs(det)
    if (area <= 0).any():
        raise ValueError("degenerate cell with non-positive area")
    # J = [e1 e2] (columns); J^{-T} = 1/det * [[ e2y, -e1y],[-e2x, e1x]]^T ...
    # direct: grad N1 = ( e2y,-e2x)/det ; grad N2 = (-e1y, e1x)/det
    g1 = np.stack([e2[:, 1], -e2[:, 0]], axis=1) / det[:, None]
    g2 = np.stack([-e1[:, 1], e1[:, 0]], axis=1) / det[:, None]
    g0 = -(g1 + g2)
    grads = np.stack([g0, g1, g2], axis=1)  # (M,3,2)
    # min edge length per cell (ref Code/Utils/helpers.py:23-24)
    l01 = np.linalg.norm(p[:, 0] - p[:, 1], axis=1)
    l02 = np.linalg.norm(p[:, 0] - p[:, 2], axis=1)
    l12 = np.linalg.norm(p[:, 1] - p[:, 2], axis=1)
    h_cell = np.minimum(np.minimum(l01, l02), l12)
    return area, grads, h_cell


def _boundary_mask(n_nodes: int, cells: Array) -> Array:
    """Nodes on edges that belong to exactly one cell."""
    edges = np.concatenate(
        [cells[:, [0, 1]], cells[:, [1, 2]], cells[:, [2, 0]]], axis=0
    )
    edges = np.sort(edges, axis=1)
    uniq, counts = np.unique(edges, axis=0, return_counts=True)
    bnd_edges = uniq[counts == 1]
    mask = np.zeros(n_nodes, dtype=bool)
    mask[bnd_edges.ravel()] = True
    return mask


def _build_patches(n_nodes: int, cells: Array):
    """ELL node adjacency (incl. self) sorted by column index.

    Vectorized equivalent of ``SI.get_patch_dictionary``
    (ref Code/Utils/SI.py:12-28), which loops cells x cell_dofs in Python.
    """
    # all ordered pairs within each cell, plus self pairs
    a = np.repeat(cells, 3, axis=1).reshape(-1)          # rows
    b = np.tile(cells, (1, 3)).reshape(-1)               # cols
    pairs = np.unique(np.stack([a, b], axis=1), axis=0)  # sorted lexicographic
    rows, cols = pairs[:, 0], pairs[:, 1]
    deg = np.bincount(rows, minlength=n_nodes)
    K = int(deg.max())
    patch_cols = np.tile(np.arange(n_nodes, dtype=np.int64)[:, None], (1, K))
    patch_mask = np.zeros((n_nodes, K), dtype=bool)
    # slot index within each row (pairs are sorted by row then col)
    offsets = np.concatenate([[0], np.cumsum(deg)])
    slot = np.arange(len(rows)) - offsets[rows]
    patch_cols[rows, slot] = cols
    patch_mask[rows, slot] = True
    # pad entries keep self index (safe gathers, masked out in reductions)
    diag_slot = np.argmax(
        (patch_cols == np.arange(n_nodes)[:, None]) & patch_mask, axis=1
    )
    return patch_cols.astype(np.int64), patch_mask, diag_slot.astype(np.int64), K


def _build_cell_slots(cells: Array, patch_cols: Array, patch_mask: Array):
    """For each cell and local pair (a,b): ELL slot k with
    patch_cols[cells[m,a], k] == cells[m,b]."""
    M = cells.shape[0]
    rows = np.repeat(cells, 3, axis=1).reshape(M, 3, 3)   # rows[m,a,b]=cells[m,a]
    colt = np.tile(cells, (1, 3)).reshape(M, 3, 3)        # colt[m,a,b]=cells[m,b]
    # binary search in each sorted row; padded cols equal row index which can
    # collide — use mask check afterwards via exact match search
    row_cols = patch_cols[rows.reshape(-1)]               # (9M, K)
    target = colt.reshape(-1, 1)
    # exact-match argmax over masked equality (rows are sorted but padding may
    # duplicate the row index; equality+mask is robust)
    row_mask = patch_mask[rows.reshape(-1)]
    eq = (row_cols == target) & row_mask
    slot = np.argmax(eq, axis=1)
    assert eq[np.arange(eq.shape[0]), slot].all(), "cell pair missing from patch"
    return slot.reshape(M, 3, 3).astype(np.int64)


def _scatter_orderings(cells: Array, cell_slots: Array, K: int):
    """Sorted permutations for deterministic segment_sum scatter-adds."""
    M = cells.shape[0]
    rows = np.repeat(cells, 3, axis=1).reshape(M, 3, 3)
    mat_target = (rows * K + cell_slots).reshape(-1)
    mat_perm = np.argsort(mat_target, kind="stable")
    mat_segs = mat_target[mat_perm]
    vec_target = cells.reshape(-1)
    vec_perm = np.argsort(vec_target, kind="stable")
    vec_segs = vec_target[vec_perm]
    return mat_perm, mat_segs, vec_perm, vec_segs


def _patches_from_csr(n_nodes, rowptr, cols):
    """Convert the native preprocessor's CSR adjacency to the ELL layout
    (identical ordering to _build_patches: sorted cols per row)."""
    deg = np.diff(rowptr)
    K = int(deg.max())
    patch_cols = np.tile(np.arange(n_nodes, dtype=np.int64)[:, None], (1, K))
    patch_mask = np.zeros((n_nodes, K), dtype=bool)
    rows = np.repeat(np.arange(n_nodes), deg)
    slot = np.arange(len(cols)) - rowptr[:-1][rows]
    patch_cols[rows, slot] = cols
    patch_mask[rows, slot] = True
    diag_slot = np.argmax(
        (patch_cols == np.arange(n_nodes)[:, None]) & patch_mask, axis=1
    )
    return patch_cols, patch_mask, diag_slot.astype(np.int64), K


def mesh_from_arrays(points: Array, cells: Array, use_native: bool | None = None) -> Mesh:
    """Build a full Mesh (with sparse structure) from raw geometry/topology.

    use_native: route the irregular graph work (adjacency, boundary) through
    the C++ preprocessor (native/mesh_preprocess.cpp). Default: on when the
    library builds, unless CFT_NATIVE=0. The NumPy path computes identical
    structures (covered by tests/test_native.py).
    """
    import os as _os

    points = np.ascontiguousarray(np.asarray(points, dtype=np.float64)[:, :2])
    cells = np.ascontiguousarray(np.asarray(cells, dtype=np.int64))
    n = points.shape[0]
    area, grads, h_cell = _cell_geometry(points, cells)
    if (area <= 0).any():
        raise ValueError("degenerate cell with non-positive area")

    if use_native is None:
        use_native = _os.environ.get("CFT_NATIVE", "1") != "0"
    native_result = None
    if use_native:
        from conservation_fem_tpu import native_ext

        native_result = native_ext.preprocess_mesh(n, cells)
    if native_result is not None:
        bnd_mask, rowptr, csr_cols, _rcm = native_result
        patch_cols, patch_mask, diag_slot, K = _patches_from_csr(
            n, rowptr, csr_cols
        )
    else:
        patch_cols, patch_mask, diag_slot, K = _build_patches(n, cells)
        bnd_mask = _boundary_mask(n, cells)
    cell_slots = _build_cell_slots(cells, patch_cols, patch_mask)
    mat_perm, mat_segs, vec_perm, vec_segs = _scatter_orderings(cells, cell_slots, K)
    return Mesh(
        points=points,
        cells=cells.astype(np.int32),
        boundary_mask=bnd_mask,
        patch_cols=patch_cols,
        patch_mask=patch_mask,
        diag_slot=diag_slot,
        cell_slots=cell_slots,
        area=area,
        grads=grads,
        h_cell=h_cell,
        mat_perm=mat_perm,
        mat_segs=mat_segs,
        vec_perm=vec_perm,
        vec_segs=vec_segs,
    )


def make_periodic(host: Mesh, axes=(0, 1), tol: float = 1e-9) -> Mesh:
    """Identify opposite-boundary nodes to make the mesh topologically
    periodic along ``axes`` (ref Burger_CPP/main.cpp:146-192
    ``PeriodicBoundaryXY1``, the reference's master-slave periodic
    mapping on the unit square — declared there but unused in its main
    path; here it is a first-class mesh transform).

    Every node on an axis' high side becomes a slave of the matching
    low-side master (corners chain through both folds). Cell CONNECTIVITY
    is renumbered onto the surviving master nodes while cell GEOMETRY
    (area, gradients, h) keeps the original coordinates, so seam cells
    integrate over their true shape. Seam edges then have two adjacent
    cells, so the periodic directions drop out of boundary_mask
    automatically; downstream assembly/stabilization kernels need no
    changes, and the convection matrix gets exact zero column sums
    (discrete mass conservation — tests/test_mesh.py).
    """
    pts = np.asarray(host.points, np.float64)
    cells = np.asarray(host.cells, np.int64)
    n = pts.shape[0]
    master_of = np.arange(n)
    for ax in axes:
        lo, hi = pts[:, ax].min(), pts[:, ax].max()
        other = [a for a in range(pts.shape[1]) if a != ax]
        is_hi = np.isclose(pts[:, ax], hi, atol=tol)
        is_lo = np.isclose(pts[:, ax], lo, atol=tol)
        key = lambda ids: [tuple(np.round(pts[i, other] / tol).astype(
            np.int64)) for i in ids]
        lo_ids = np.nonzero(is_lo)[0]
        lut = dict(zip(key(lo_ids), lo_ids))
        hi_ids = np.nonzero(is_hi)[0]
        for s, k in zip(hi_ids, key(hi_ids)):
            if k not in lut:
                raise ValueError(
                    f"periodic axis {ax}: no matching low-side node for "
                    f"point {pts[s]}")
            master_of[s] = lut[k]
    # resolve chains (corner: x-fold then y-fold)
    for _ in range(len(axes)):
        master_of = master_of[master_of]
    keep = master_of == np.arange(n)
    new_id = np.cumsum(keep) - 1
    cells_new = new_id[master_of[cells]]
    n_new = int(keep.sum())

    area, grads, h_cell = _cell_geometry(pts, cells)
    patch_cols, patch_mask, diag_slot, K = _build_patches(n_new, cells_new)
    bnd_mask = _boundary_mask(n_new, cells_new)
    cell_slots = _build_cell_slots(cells_new, patch_cols, patch_mask)
    mat_perm, mat_segs, vec_perm, vec_segs = _scatter_orderings(
        cells_new, cell_slots, K)
    return Mesh(
        periodic=True,
        points=np.ascontiguousarray(pts[keep]),
        cells=cells_new.astype(np.int32),
        boundary_mask=bnd_mask,
        patch_cols=patch_cols,
        patch_mask=patch_mask,
        diag_slot=diag_slot,
        cell_slots=cell_slots,
        area=area,
        grads=grads,
        h_cell=h_cell,
        mat_perm=mat_perm,
        mat_segs=mat_segs,
        vec_perm=vec_perm,
        vec_segs=vec_segs,
    )


def rectangle_mesh_lean(p0=(0.0, 0.0), p1=(1.0, 1.0), nx: int = 8,
                        ny: int | None = None) -> Mesh:
    """rectangle_mesh('right') WITHOUT the generic sparse structure — for
    the STENCIL backend only, which reads just points, cells (counts +
    two exemplars' geometry), per-cell geometry and the boundary mask
    (ops/structured.build_structured). The patch/scatter fields are
    1-element placeholders: any generic-path consumer fails loudly on
    their shapes.

    Why: the generic builder's patch/scatter orderings (np.unique/argsort
    over 9M int64 pairs) cost ~115 GB host RAM at mesh 2048 (M=8.4M
    cells). This constructor is O(N) flat arrays: ~2 GB
    at 2048. Geometry values are IDENTICAL to rectangle_mesh (same cell
    ordering: lowers then uppers, '/' diagonal) — tested in
    tests/test_mesh.py.
    """
    if ny is None:
        ny = nx
    x = np.linspace(p0[0], p1[0], nx + 1)
    y = np.linspace(p0[1], p1[1], ny + 1)
    X, Y = np.meshgrid(x, y, indexing="ij")
    points = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(i, j):
        return i * (ny + 1) + j

    I, J = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    I, J = I.ravel(), J.ravel()
    v00, v10 = vid(I, J), vid(I + 1, J)
    v01, v11 = vid(I, J + 1), vid(I + 1, J + 1)
    tris = np.concatenate(
        [np.stack([v00, v10, v11], 1), np.stack([v00, v11, v01], 1)],
        axis=0).astype(np.int64)
    # uniform geometry: every lower (upper) triangle is a translate of
    # cell 0 (cell nx*ny) — compute the two exemplars, broadcast views
    area0, grads2, h0 = _cell_geometry(points, tris[[0, nx * ny]])
    M = tris.shape[0]
    area = np.broadcast_to(area0[:1], (M,))
    grads = np.concatenate([
        np.broadcast_to(grads2[0][None], (nx * ny, 3, 2)),
        np.broadcast_to(grads2[1][None], (nx * ny, 3, 2))])
    h_cell = np.broadcast_to(h0[:1], (M,))
    bnd = np.zeros((nx + 1, ny + 1), dtype=bool)
    bnd[0, :] = bnd[-1, :] = True
    bnd[:, 0] = bnd[:, -1] = True
    z1 = np.zeros(1, dtype=np.int64)
    return Mesh(
        points=points, cells=tris.astype(np.int32),
        boundary_mask=bnd.reshape(-1),
        patch_cols=z1.reshape(1, 1), patch_mask=np.zeros((1, 1), bool),
        diag_slot=z1, cell_slots=z1.reshape(1, 1, 1),
        area=area, grads=grads, h_cell=h_cell,
        mat_perm=z1, mat_segs=z1, vec_perm=z1, vec_segs=z1,
    )


def rectangle_mesh(
    p0=(0.0, 0.0),
    p1=(1.0, 1.0),
    nx: int = 8,
    ny: int | None = None,
    diagonal: str = "right",
) -> Mesh:
    """Structured triangle rectangle, matching DOLFINx ``create_rectangle``
    (ref Code/Burgers_equation/Exact_Burger_RV.py:28).

    diagonal: 'right' ("/" diagonal), 'left' ("\\"), or 'crossed' (4 triangles
    per quad around a center node — ref tests/verification/stiffness.py:38).
    """
    if ny is None:
        ny = nx
    x = np.linspace(p0[0], p1[0], nx + 1)
    y = np.linspace(p0[1], p1[1], ny + 1)
    X, Y = np.meshgrid(x, y, indexing="ij")
    points = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(i, j):
        return i * (ny + 1) + j

    I, J = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    I, J = I.ravel(), J.ravel()
    v00, v10 = vid(I, J), vid(I + 1, J)
    v01, v11 = vid(I, J + 1), vid(I + 1, J + 1)
    if diagonal == "right":
        tris = np.concatenate(
            [np.stack([v00, v10, v11], 1), np.stack([v00, v11, v01], 1)], axis=0
        )
    elif diagonal == "left":
        tris = np.concatenate(
            [np.stack([v00, v10, v01], 1), np.stack([v10, v11, v01], 1)], axis=0
        )
    elif diagonal == "crossed":
        nq = nx * ny
        centers = np.stack(
            [(X[:-1, :-1] + X[1:, 1:]).ravel() * 0.5,
             (Y[:-1, :-1] + Y[1:, 1:]).ravel() * 0.5],
            axis=1,
        )
        c = points.shape[0] + np.arange(nq)
        points = np.concatenate([points, centers], axis=0)
        tris = np.concatenate(
            [
                np.stack([v00, v10, c], 1),
                np.stack([v10, v11, c], 1),
                np.stack([v11, v01, c], 1),
                np.stack([v01, v00, c], 1),
            ],
            axis=0,
        )
    else:
        raise ValueError(f"unknown diagonal {diagonal!r}")
    return mesh_from_arrays(points, tris)


def irregular_mesh(p0=(0.0, 0.0), p1=(1.0, 1.0), nx: int = 8,
                   jitter: float = 0.35, seed: int = 0) -> Mesh:
    """Deterministic genuinely-UNSTRUCTURED rectangle triangulation:
    interior lattice points jittered by ``jitter * h`` (seeded) and
    re-triangulated with scipy Delaunay; boundary points stay exact so
    the domain and Dirichlet detection are unchanged.

    Purpose: arbitrarily-sized stand-ins for gmsh meshes (the reference's
    unstructured habitat, e.g. Data/KPP_RV.h5 at N=4886) when scaling the
    unstructured fast paths past the stored mesh — same irregular valence
    distribution and non-banded sparsity, reproducible across processes
    (the committed f64 anchors depend on bit-identical meshes).
    """
    from scipy.spatial import Delaunay

    x = np.linspace(p0[0], p1[0], nx + 1)
    y = np.linspace(p0[1], p1[1], nx + 1)
    X, Y = np.meshgrid(x, y, indexing="ij")
    points = np.stack([X.ravel(), Y.ravel()], axis=1)
    h = (p1[0] - p0[0]) / nx
    interior = ((points[:, 0] > p0[0]) & (points[:, 0] < p1[0])
                & (points[:, 1] > p0[1]) & (points[:, 1] < p1[1]))
    rng = np.random.default_rng(seed)
    points[interior] += (rng.uniform(-jitter, jitter,
                                     (int(interior.sum()), 2)) * h)
    tris = Delaunay(points).simplices.astype(np.int64)
    # enforce CCW orientation (positive signed area)
    p = points[tris]
    cross = ((p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
             - (p[:, 1, 1] - p[:, 0, 1]) * (p[:, 2, 0] - p[:, 0, 0]))
    flip = cross < 0
    tris[flip] = tris[flip][:, [0, 2, 1]]
    return mesh_from_arrays(points, tris)


def disk_mesh(hmax: float, radius: float = 1.0, center=(0.0, 0.0)) -> Mesh:
    """Deterministic unit-disk triangulation from concentric rings.

    Replaces the gmsh OCC disk mesher (ref linear_advection.py:26-38, mesh
    size via CharacteristicLength min=max=hmax). Ring k (k=1..nr) holds 6k
    nodes at radius k*dr; between consecutive rings 6(2k-1) near-equilateral
    triangles are built. Quality and h are comparable to gmsh output; exact
    node placement differs (documented deviation — gmsh meshes are
    non-deterministic external artifacts).
    """
    nr = max(1, int(round(radius / hmax)))
    dr = radius / nr
    pts = [np.array([[center[0], center[1]]])]
    ring_start = [None, 1]
    for k in range(1, nr + 1):
        m = 6 * k
        th = 2 * np.pi * np.arange(m) / m
        pts.append(
            np.stack(
                [center[0] + k * dr * np.cos(th), center[1] + k * dr * np.sin(th)],
                axis=1,
            )
        )
        ring_start.append(ring_start[-1] + m)
    points = np.concatenate(pts, axis=0)

    tris = []
    # innermost fan: ring 1 (6 nodes) to center (node 0)
    for i in range(6):
        tris.append([0, 1 + i, 1 + (i + 1) % 6])
    for k in range(1, nr):
        s_in, n_in = ring_start[k], 6 * k
        s_out, n_out = ring_start[k + 1], 6 * (k + 1)
        # each of 6 sectors has k inner and k+1 outer nodes; the sector's
        # last inner node wraps into the next sector's first
        for sec in range(6):
            for j in range(k + 1):
                o0 = s_out + (sec * (k + 1) + j) % n_out
                o1 = s_out + (sec * (k + 1) + j + 1) % n_out
                i0 = s_in + (sec * k + j) % n_in
                tris.append([i0, o0, o1])
                if j < k:
                    i1 = s_in + (sec * k + j + 1) % n_in
                    tris.append([i0, o1, i1])
    return mesh_from_arrays(points, np.asarray(tris))


def rcm_permutation(mesh: Mesh) -> Array:
    """Reverse Cuthill-McKee node ordering (old -> new) for gather locality
    in the ELL SpMV hot loop. Uses the native C++ preprocessor when
    available, else scipy."""
    from conservation_fem_tpu import native_ext

    res = native_ext.preprocess_mesh(mesh.n_nodes, mesh.cells)
    if res is not None:
        return res[3].astype(np.int64)
    return rcm_from_connectivity(mesh.n_nodes, mesh.cells)


def rcm_from_connectivity(n: int, conn) -> Array:
    """Reverse Cuthill-McKee (old -> new) from an (M, nloc) connectivity
    array — shared by the mesh (P1) and FunctionSpace (Pk dof) paths."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    conn = np.asarray(conn, dtype=np.int64)
    nloc = conn.shape[1]
    rows = np.repeat(conn, nloc, axis=1).reshape(-1)
    cols = np.tile(conn, (1, nloc)).reshape(-1)
    A = sp.coo_matrix(
        (np.ones(len(rows)), (rows, cols)), shape=(n, n)
    ).tocsr()
    order = reverse_cuthill_mckee(A, symmetric_mode=True)
    perm = np.empty(n, dtype=np.int64)
    perm[order] = np.arange(n)
    return perm


def reorder_mesh(mesh: Mesh, perm: Array) -> Mesh:
    """Renumber nodes by perm (old -> new); rebuilds all derived structure."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    points = mesh.points[inv]
    cells = perm[mesh.cells.astype(np.int64)]
    return mesh_from_arrays(points, cells)


def load_h5_mesh(path: str, geometry="Mesh/mesh/geometry", topology="Mesh/mesh/topology") -> Mesh:
    """Import a DOLFINx XDMF/HDF5 mesh snapshot (ref Data/KPP_RV.h5:
    geometry (4886,2) f64, topology (9514,3) i64)."""
    import h5py

    with h5py.File(path, "r") as f:
        points = np.asarray(f[geometry])
        cells = np.asarray(f[topology])
    return mesh_from_arrays(points, cells)
