"""Node partitioning + halo index structures for unstructured meshes.

Host-side preprocessing for the distributed ELL path
(parallel/unstructured_sharded.py): the equivalent of DOLFINx's mesh
partitioning with ghost nodes (SURVEY.md section 2.8; partitioners
ParMETIS/PT-SCOTCH in the reference env, ref Environment/fenicsx-env.yml).

Strategy: RCM-reorder the mesh for locality, split nodes into contiguous
equal blocks (one per device), and for each device build:

  * its row block of the ELL patch structure, with column indices remapped
    to [0, n_own + n_halo) — owned entries first, halo entries after;
  * the halo exchange table: every device publishes a fixed-size block of
    its "shared" owned nodes (those referenced by other devices); after an
    all_gather of these compact blocks each device gathers its halo values
    with a precomputed flat index. This is ghost scatter_forward
    (ref linear_advection.py:170) expressed with one collective.

Cells are assigned to the device owning their first node; scatter-add
contributions to non-owned rows ride the same shared-block mechanism in
reverse (psum over published accumulation blocks) — ghostUpdate(ADD,
REVERSE) (ref linear_advection.py:165).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from conservation_fem_tpu.ops.mesh import Mesh, rcm_permutation, reorder_mesh


class CellPartition(NamedTuple):
    """Per-device cell blocks + extended-row scatter structure for fully
    distributed assembly (ghostUpdate ADD/REVERSE for vectors and ELL
    rows). Extended row index space per device: [0, n_own) owned rows,
    [n_own, n_own + H) halo rows (same order as Partition.halo_src)."""
    n_cell_max: int            # padded cells per device
    cells_ext: np.ndarray      # (n_dev, C, 3) extended-row ids of cell nodes
    cell_valid: np.ndarray     # (n_dev, C) real-cell mask
    area: np.ndarray           # (n_dev, C)
    grads: np.ndarray          # (n_dev, C, 3, 2)
    h: np.ndarray              # (n_dev, C) cell size h_k (rv_cell epsilon)
    cell_slots: np.ndarray     # (n_dev, C, 3, 3) K-slot of each (a,b) pair
    # reverse exchange: owners pick contributions destined to their shared
    # rows out of the all_gathered (n_dev*H,) halo-accumulation table
    rev_src: np.ndarray        # (n_dev, S, R) flat indices into (n_dev*H,)
    rev_mask: np.ndarray       # (n_dev, S, R)


class Partition(NamedTuple):
    mesh: Mesh                 # RCM-reordered mesh
    n_dev: int
    n_own: int                 # owned nodes per device (padded)
    n_total: int               # n_own * n_dev (>= n_nodes)
    # halo structures, all shaped per device (leading axis n_dev):
    shared_size: int           # S: published shared-block width
    shared_idx: np.ndarray     # (n_dev, S) local-owned index each device publishes
    halo_size: int             # H: halo width (max over devices)
    halo_src: np.ndarray       # (n_dev, H) flat index into the gathered
                               # (n_dev*S,) shared table for each halo slot
    # per-device ELL row block with remapped columns:
    local_cols: np.ndarray     # (n_dev, n_own, K) in [0, n_own+H)
    local_mask: np.ndarray     # (n_dev, n_own, K)
    global_rows: np.ndarray    # (n_dev, n_own) global node id (or -1 pad)


def build_partition(mesh: Mesh, n_dev: int, reorder: bool = True) -> Partition:
    if reorder:
        mesh = reorder_mesh(mesh, rcm_permutation(mesh))
    n = mesh.n_nodes
    n_own = -(-n // n_dev)
    n_total = n_own * n_dev
    owner = np.minimum(np.arange(n_total) // n_own, n_dev - 1)

    K = mesh.max_patch
    cols = mesh.patch_cols
    mask = mesh.patch_mask

    # halo sets: for device d, referenced nodes owned elsewhere
    halo_sets = []
    for d in range(n_dev):
        lo, hi = d * n_own, min((d + 1) * n_own, n)
        c = cols[lo:hi][mask[lo:hi]]
        ext = np.unique(c[(c < lo) | (c >= hi)])
        halo_sets.append(ext)
    H = max((len(h) for h in halo_sets), default=1) or 1

    # shared sets: for device d, owned nodes referenced by others
    shared_sets = []
    for d in range(n_dev):
        lo, hi = d * n_own, min((d + 1) * n_own, n)
        refs = np.unique(np.concatenate(
            [h[(h >= lo) & (h < hi)] for h in halo_sets] or [np.empty(0, int)]
        ))
        shared_sets.append(refs)
    S = max((len(s) for s in shared_sets), default=1) or 1

    shared_idx = np.zeros((n_dev, S), dtype=np.int64)
    for d, s in enumerate(shared_sets):
        shared_idx[d, : len(s)] = s - d * n_own       # local index
        # pad repeats slot 0 (harmless duplicate publish)

    # global -> (device, shared slot) lookup for halo sources
    flat_lookup = {}
    for d, s in enumerate(shared_sets):
        for j, g in enumerate(s):
            flat_lookup[int(g)] = d * S + j

    halo_src = np.zeros((n_dev, H), dtype=np.int64)
    halo_pos = {}            # (device, global id) -> halo slot
    for d, hset in enumerate(halo_sets):
        for j, g in enumerate(hset):
            halo_src[d, j] = flat_lookup[int(g)]
            halo_pos[(d, int(g))] = j

    # local ELL blocks with remapped columns
    local_cols = np.zeros((n_dev, n_own, K), dtype=np.int64)
    local_mask = np.zeros((n_dev, n_own, K), dtype=bool)
    global_rows = np.full((n_dev, n_own), -1, dtype=np.int64)
    for d in range(n_dev):
        lo, hi = d * n_own, min((d + 1) * n_own, n)
        nrows = hi - lo
        global_rows[d, :nrows] = np.arange(lo, hi)
        cblk = cols[lo:hi].copy()
        mblk = mask[lo:hi].copy()
        own = (cblk >= lo) & (cblk < hi)
        out = np.zeros_like(cblk)
        out[own] = cblk[own] - lo
        ext = mblk & ~own
        if ext.any():
            out[ext] = n_own + np.array(
                [halo_pos[(d, int(g))] for g in cblk[ext]]
            )
        out[~mblk] = 0
        local_cols[d, :nrows] = out
        local_mask[d, :nrows] = mblk
    return Partition(
        mesh=mesh, n_dev=n_dev, n_own=n_own, n_total=n_total,
        shared_size=S, shared_idx=shared_idx,
        halo_size=H, halo_src=halo_src,
        local_cols=local_cols, local_mask=local_mask,
        global_rows=global_rows,
    )


def build_cell_partition(part: Partition) -> CellPartition:
    """Assign each cell to the device owning its first node; precompute
    extended-row scatter targets and the reverse (ADD) exchange map."""
    mesh, n_dev, n_own = part.mesh, part.n_dev, part.n_own
    cells = mesh.cells.astype(np.int64)
    owner_of = np.minimum(cells[:, 0] // n_own, n_dev - 1)
    H, S = part.halo_size, part.shared_size

    # per-device halo position lookup: global id -> halo slot
    halo_pos = []
    K = mesh.max_patch
    cols, mask = mesh.patch_cols, mesh.patch_mask
    n = mesh.n_nodes
    halo_sets = []
    for d in range(n_dev):
        lo, hi = d * n_own, min((d + 1) * n_own, n)
        c = cols[lo:hi][mask[lo:hi]]
        halo_sets.append(np.unique(c[(c < lo) | (c >= hi)]))
        halo_pos.append({int(g): j for j, g in enumerate(halo_sets[-1])})

    C = max(int((owner_of == d).sum()) for d in range(n_dev))
    cells_ext = np.zeros((n_dev, C, 3), dtype=np.int64)
    cell_valid = np.zeros((n_dev, C), dtype=bool)
    area = np.zeros((n_dev, C))
    grads = np.zeros((n_dev, C, 3, 2))
    h_c = np.zeros((n_dev, C))
    cslots = np.zeros((n_dev, C, 3, 3), dtype=np.int64)

    # global ELL slot of (row, col): exact masked match (rows are sorted on
    # their real entries but padded with the row index, so no searchsorted)
    def slot_of(row, col):
        hit = np.nonzero((cols[row] == col) & mask[row])[0]
        return int(hit[0])

    for d in range(n_dev):
        ids = np.nonzero(owner_of == d)[0]
        lo = d * n_own
        for k, cidx in enumerate(ids):
            vs = cells[cidx]
            ext = []
            for g in vs:
                if lo <= g < lo + n_own:
                    ext.append(g - lo)
                else:
                    ext.append(n_own + halo_pos[d][int(g)])
            cells_ext[d, k] = ext
            cell_valid[d, k] = True
            area[d, k] = mesh.area[cidx]
            grads[d, k] = mesh.grads[cidx]
            h_c[d, k] = mesh.h_cell[cidx]
            for a in range(3):
                for b in range(3):
                    cslots[d, k, a, b] = slot_of(int(vs[a]), int(vs[b]))

    # reverse map: contributions accumulated at (src_dev, halo_slot j) with
    # halo global id g belong to owner(g)'s shared slot for g
    shared_lookup = {}
    for d in range(n_dev):
        lo, hi = d * n_own, min((d + 1) * n_own, n)
        for j in range(S):
            g = part.shared_idx[d, j] + lo
            # padded duplicate slots map to the same g; first wins
            if (d, int(g)) not in shared_lookup:
                shared_lookup[(d, int(g))] = j
    contribs = [[[] for _ in range(S)] for _ in range(n_dev)]
    for src in range(n_dev):
        for j, g in enumerate(halo_sets[src]):
            own = min(int(g) // n_own, n_dev - 1)
            sj = shared_lookup[(own, int(g))]
            contribs[own][sj].append(src * H + j)
    R = max((len(c) for dev in contribs for c in dev), default=1) or 1
    rev_src = np.zeros((n_dev, S, R), dtype=np.int64)
    rev_mask = np.zeros((n_dev, S, R), dtype=bool)
    for d in range(n_dev):
        for sj in range(S):
            for r, f in enumerate(contribs[d][sj]):
                rev_src[d, sj, r] = f
                rev_mask[d, sj, r] = True
    return CellPartition(
        n_cell_max=C, cells_ext=cells_ext, cell_valid=cell_valid,
        area=area, grads=grads, h=h_c, cell_slots=cslots,
        rev_src=rev_src, rev_mask=rev_mask,
    )
