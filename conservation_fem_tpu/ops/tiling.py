"""2D locality-preserving tile ordering for the blocked-window backend.

The 1D RCM band gives the blocked plan a window W = nb + 2B with B the
matrix bandwidth — and 2D meshes have B >= O(sqrt(N)) inherently, so
one-hot operand bytes per DOF grow ~sqrt(N) and per-DOF throughput falls
~1/sqrt(N). This module implements the remedy: a locality-preserving 2D
ordering whose per-block window width is
INDEPENDENT of N.

Layout ("equal-count kd tiles"): sort nodes by y into S equal-count
strips, each strip by x into T tiles of EXACTLY nb node slots (the strip
tail is padded with phantom slots). A block of the blocked plan == one
tile; the graph neighbours of tile (s, t) live in tiles
(s + ds, t + dt), |ds| <= 1, |dt| <= k (k ~ 1-2 absorbs the x-cut
misalignment between adjacent equal-count strips). Because every strip
holds exactly T*nb slots, tile (s+ds, t+dt) is block b + ds*T + dt —
a UNIFORM stride in b — so the per-block window is 3 contiguous runs of
(2k+1) blocks each, extracted with the same static-slice machinery as
the 1D band (ops/blocked.windows, tiled branch). Window width
W = 3*(2k+1)*nb is CONSTANT in N: one-hot HBM per DOF stops growing and
per-DOF throughput stops falling.

Phantom slots ride the existing machinery: the padded mesh marks them as
boundary nodes (Dirichlet-pinned identity rows, decoupled — they belong
to no cells), and `Mesh.slot_valid` masks them out of global reductions
(the RV mean via ops/blocked.rv_epsilon_* valid argument).

ref analog: DOLFINx ghosted-CSR scale-out has no per-rank window at all
(SURVEY 2.8); this is the single-device answer —
the gather-free dense-window form kept O(nb)-wide at any N.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from conservation_fem_tpu.ops.mesh import Mesh, mesh_from_arrays


def tile_layout(points, nb: int = 128, S: int | None = None):
    """Equal-count kd tile layout.

    Returns (slot_of_node (n,) int64, n_slots, S, T): node i lives at row
    slot_of_node[i] of the padded S*T*nb slot space; slots not hit are
    phantoms.
    """
    pts = np.asarray(points)
    n = pts.shape[0]
    nblocks = -(-n // nb)
    if S is None:
        S = max(1, int(round(np.sqrt(nblocks))))
    order_y = np.argsort(pts[:, 1], kind="stable")
    bounds = np.linspace(0, n, S + 1).round().astype(np.int64)
    max_strip = int((bounds[1:] - bounds[:-1]).max())
    T = -(-max_strip // nb)
    slot = np.empty(n, dtype=np.int64)
    for s in range(S):
        idx = order_y[bounds[s]:bounds[s + 1]]
        idx = idx[np.argsort(pts[idx, 0], kind="stable")]
        slot[idx] = s * T * nb + np.arange(len(idx))
    return slot, S * T * nb, S, T


def pad_mesh_to_slots(mesh: Mesh, slot_of_node, n_slots: int,
                      tile_T: int) -> Mesh:
    """Rebuild `mesh` in the padded slot numbering.

    Phantom slots get a copy of an arbitrary real point's coordinates
    (they join no cells, so geometry never reads them), are marked
    BOUNDARY (Dirichlet-pinned identity rows in every solve), and are
    recorded in the returned mesh's ``slot_valid`` mask with the tile
    stride in ``tile_T``.
    """
    slot_of_node = np.asarray(slot_of_node, dtype=np.int64)
    valid = np.zeros(n_slots, dtype=bool)
    valid[slot_of_node] = True
    points = np.empty((n_slots, 2), dtype=np.float64)
    points[slot_of_node] = np.asarray(mesh.points)
    if (~valid).any():
        points[~valid] = points[slot_of_node[0]]
    cells = slot_of_node[np.asarray(mesh.cells, dtype=np.int64)]
    m = mesh_from_arrays(points, cells)
    bnd = np.asarray(m.boundary_mask) | ~valid
    return dataclasses.replace(m, boundary_mask=bnd,
                               slot_valid=valid, tile_T=int(tile_T))


def tile_mesh(mesh: Mesh, nb: int = 128):
    """One-call convenience: layout + padded rebuild.

    Returns (padded_mesh, slot_of_node). Solutions on the padded mesh
    live in slot numbering: ``u_native = u_slots[slot_of_node]``.
    """
    slot, n_slots, S, T = tile_layout(mesh.points, nb=nb)
    return pad_mesh_to_slots(mesh, slot, n_slots, T), slot
