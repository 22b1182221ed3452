"""Pk Lagrange function spaces (k = 1, 2, 3) on triangle meshes.

Replacement for basix/dolfinx function spaces
(ref fem.functionspace(domain, ("Lagrange", degree)) — used at degree 2 in
Code/Linear_advection/RV_node.py:48, degree 3 in higher_order_RV.py:29,
degree sweeps in GFEM_pol.py:63-67, and P2-P1 Taylor-Hood in
Code/Compressible_euler/stokes.py:22-25).

A FunctionSpace is host-built arrays:
  * dof_coords (ndof,2), cell_dofs (M,nloc) with nloc=(k+1)(k+2)/2;
  * dof layout: vertex dofs first (= mesh vertex ids), then edge dofs
    (k-1 per unique edge, ordered from the lower- to the higher-index
    vertex; cells traversing an edge backwards see them reversed), then
    cell-interior dofs;
  * boundary dof mask (vertices + edge dofs on boundary edges);
  * ELL dof-adjacency (patches) + sorted scatter orderings, exactly like
    ops/mesh.py builds for P1;
  * tabulated reference basis: values/gradients at quadrature points of a
    rule exact to degree 2k (mass-matrix exactness), built by monomial
    Vandermonde inversion in f64.

Affine triangles: the Jacobian is constant per cell, so physical gradients
are J^{-T} @ ref-grad — assembly stays a pure einsum over (cells x qpoints).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from conservation_fem_tpu.ops.mesh import Mesh

# Dunavant rules on the reference triangle {x>=0,y>=0,x+y<=1};
# weights sum to 1 (multiply by area |T| = 1/2 at use sites... here we store
# weights summing to 0.5 = reference-triangle area).
_RULES = {}


def _rule(points, weights):
    w = np.asarray(weights, dtype=np.float64)
    p = np.asarray(points, dtype=np.float64)
    return p, w / w.sum() * 0.5


# degree 2 (3-point)
_RULES[2] = _rule(
    [[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]], [1, 1, 1]
)
# degree 4 (6-point)
_a1, _b1 = 0.445948490915965, 0.108103018168070
_a2, _b2 = 0.091576213509771, 0.816847572980459
_RULES[4] = _rule(
    [[_a1, _a1], [_b1, _a1], [_a1, _b1], [_a2, _a2], [_b2, _a2], [_a2, _b2]],
    [0.223381589678011] * 3 + [0.109951743655322] * 3,
)
# degree 6 (12-point, Dunavant)
_c1 = 0.063089014491502
_c2 = 0.249286745170910
_c3a, _c3b = 0.053145049844817, 0.310352451033784
_RULES[6] = _rule(
    [
        [_c1, _c1], [1 - 2 * _c1, _c1], [_c1, 1 - 2 * _c1],
        [_c2, _c2], [1 - 2 * _c2, _c2], [_c2, 1 - 2 * _c2],
        [_c3a, _c3b], [_c3b, _c3a],
        [1 - _c3a - _c3b, _c3a], [1 - _c3a - _c3b, _c3b],
        [_c3a, 1 - _c3a - _c3b], [_c3b, 1 - _c3a - _c3b],
    ],
    [0.050844906370207] * 3 + [0.116786275726379] * 3
    + [0.082851075618374] * 6,
)


def quadrature(exactness: int):
    """Smallest stored rule exact to at least the requested degree."""
    for d in sorted(_RULES):
        if d >= exactness:
            return _RULES[d]
    return _RULES[max(_RULES)]


def reference_lattice(k: int):
    """Lagrange node lattice on the reference triangle in the canonical
    order: 3 vertices, then edges (v0-v1, v1-v2, v2-v0) with k-1 interior
    points each (ordered along the edge), then interior lattice points."""
    verts = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    pts = [verts[0], verts[1], verts[2]]
    edges = [(0, 1), (1, 2), (2, 0)]
    for a, b in edges:
        for i in range(1, k):
            pts.append(verts[a] + (verts[b] - verts[a]) * i / k)
    # interior points (only k >= 3): barycentric (i,j) with i,j >= 1, i+j <= k-1
    for j in range(1, k):
        for i in range(1, k - j):
            pts.append(np.array([i / k, j / k]))
    return np.asarray(pts)


def _monomials(pts, k):
    """All monomials x^a y^b, a+b <= k, at pts (n,2) -> (n, nloc)."""
    x, y = pts[:, 0], pts[:, 1]
    cols = [x**a * y**b for a in range(k + 1) for b in range(k + 1 - a)]
    return np.stack(cols, axis=1)


def _monomial_grads(pts, k):
    x, y = pts[:, 0], pts[:, 1]
    dx, dy = [], []
    for a in range(k + 1):
        for b in range(k + 1 - a):
            dx.append(a * x ** max(a - 1, 0) * y**b if a > 0 else 0 * x)
            dy.append(b * x**a * y ** max(b - 1, 0) if b > 0 else 0 * x)
    return np.stack(dx, axis=1), np.stack(dy, axis=1)


def tabulate_basis(k: int, pts):
    """(phi (n,nloc), dphi (n,nloc,2)) of the Pk Lagrange basis at pts."""
    nodes = reference_lattice(k)
    V = _monomials(nodes, k)
    C = np.linalg.inv(V)            # coeffs: column j = basis j
    phi = _monomials(pts, k) @ C
    gx, gy = _monomial_grads(pts, k)
    dphi = np.stack([gx @ C, gy @ C], axis=2)
    return phi, dphi


def _build_adjacency(ndof: int, cell_dofs: np.ndarray):
    a = np.repeat(cell_dofs, cell_dofs.shape[1], axis=1).reshape(-1)
    b = np.tile(cell_dofs, (1, cell_dofs.shape[1])).reshape(-1)
    pairs = np.unique(np.stack([a, b], axis=1), axis=0)
    rows, cols = pairs[:, 0], pairs[:, 1]
    deg = np.bincount(rows, minlength=ndof)
    K = int(deg.max())
    patch_cols = np.tile(np.arange(ndof, dtype=np.int64)[:, None], (1, K))
    patch_mask = np.zeros((ndof, K), dtype=bool)
    offsets = np.concatenate([[0], np.cumsum(deg)])
    slot = np.arange(len(rows)) - offsets[rows]
    patch_cols[rows, slot] = cols
    patch_mask[rows, slot] = True
    diag_slot = np.argmax(
        (patch_cols == np.arange(ndof)[:, None]) & patch_mask, axis=1
    )
    return patch_cols, patch_mask, diag_slot.astype(np.int64), K


@dataclasses.dataclass(frozen=True, eq=False)
class FunctionSpace:
    mesh: Mesh
    degree: int
    dof_coords: np.ndarray     # (ndof,2)
    cell_dofs: np.ndarray      # (M,nloc) i64
    boundary_mask: np.ndarray  # (ndof,)
    patch_cols: np.ndarray
    patch_mask: np.ndarray
    diag_slot: np.ndarray
    cell_slots: np.ndarray     # (M,nloc,nloc)
    mat_perm: np.ndarray
    mat_segs: np.ndarray
    vec_perm: np.ndarray
    vec_segs: np.ndarray
    quad_pts: np.ndarray       # (Q,2)
    quad_w: np.ndarray         # (Q,) sums to 0.5
    phi: np.ndarray            # (Q,nloc)
    dphi: np.ndarray           # (Q,nloc,2)
    # basis tabulated at the *lattice nodes* (for interpolation identity)

    @property
    def ndof(self) -> int:
        return self.dof_coords.shape[0]

    @property
    def nloc(self) -> int:
        return self.cell_dofs.shape[1]

    def device_arrays(self, dtype=None):
        """Export as a SpaceArrays bundle of jax arrays."""
        import jax.numpy as jnp

        if dtype is None:
            dtype = jnp.float64 if jnp.zeros(0).dtype == jnp.float64 else jnp.float32
        f = lambda x: jnp.asarray(x, dtype=dtype)
        jinv_t_q, detj_q = self._geometry_q()
        i = lambda x: jnp.asarray(x, dtype=jnp.int32)
        host = self.mesh
        return SpaceArrays(
            degree=self.degree,
            dof_coords=f(self.dof_coords),
            cell_dofs=i(self.cell_dofs),
            boundary_mask=jnp.asarray(self.boundary_mask),
            patch_cols=i(self.patch_cols),
            patch_mask=jnp.asarray(self.patch_mask),
            diag_slot=i(self.diag_slot),
            mat_perm=i(self.mat_perm),
            mat_segs=i(self.mat_segs),
            vec_perm=i(self.vec_perm),
            vec_segs=i(self.vec_segs),
            area=f(host.area),
            jinv_t=f(self._jinv_t()),
            cell_p0=f(host.points[host.cells[:, 0]]),
            cell_e1=f(host.points[host.cells[:, 1]] - host.points[host.cells[:, 0]]),
            cell_e2=f(host.points[host.cells[:, 2]] - host.points[host.cells[:, 0]]),
            quad_pts=f(self.quad_pts),
            quad_w=f(self.quad_w),
            phi=f(self.phi),
            dphi=f(self.dphi),
            h_cell=f(host.h_cell),
            jinv_t_q=f(jinv_t_q),
            detj_q=f(detj_q),
        )

    def _geometry_q(self):
        """Per-(cell, quad-point) isoparametric geometry: the cell map is
        x(xi) = sum_c phi_c(xi) X_c with X_c the (possibly boundary-
        projected) dof coordinates. For straight cells this reduces to the
        affine map exactly; with a curved boundary (build_space
        boundary_projector) boundary cells get the bent geometry that lifts
        P2/P3 convergence past the straight-triangle cap (the reference's
        gmsh meshes are straight, ref RV_node.py:30-46 — this exceeds it).

        Returns (jinv_t_q (M,Q,2,2), detj_q (M,Q))."""
        X = self.dof_coords[self.cell_dofs]            # (M,nloc,2)
        # J[m,q,d,e] = d x_d / d xi_e
        J = np.einsum("mcd,qce->mqde", X, self.dphi)
        det = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
        if np.any(det == 0.0):
            raise ValueError("degenerate cell: zero Jacobian at a quad point")
        jinv_t = np.empty_like(J)
        jinv_t[..., 0, 0] = J[..., 1, 1]
        jinv_t[..., 0, 1] = -J[..., 1, 0]
        jinv_t[..., 1, 0] = -J[..., 0, 1]
        jinv_t[..., 1, 1] = J[..., 0, 0]
        # The quadrature weight is |det| so clockwise-oriented cells (accepted
        # by mesh_from_arrays) assemble with the correct sign; the signed det
        # stays in jinv_t, which is orientation-correct as a ratio.
        return jinv_t / det[..., None, None], np.abs(det)

    def _jinv_t(self):
        """Per-cell J^{-T} (M,2,2) for mapping reference gradients."""
        host = self.mesh
        p = host.points[host.cells[:, :3]]
        e1 = p[:, 1] - p[:, 0]
        e2 = p[:, 2] - p[:, 0]
        det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
        # J = [[e1x, e2x],[e1y, e2y]]; J^{-T} = 1/det [[e2y, -e1y],[-e2x, e1x]]
        jinv_t = np.empty((p.shape[0], 2, 2))
        jinv_t[:, 0, 0] = e2[:, 1]
        jinv_t[:, 0, 1] = -e1[:, 1]
        jinv_t[:, 1, 0] = -e2[:, 0]
        jinv_t[:, 1, 1] = e1[:, 0]
        return jinv_t / det[:, None, None]


class SpaceArrays(NamedTuple):
    degree: int
    dof_coords: object
    cell_dofs: object
    boundary_mask: object
    patch_cols: object
    patch_mask: object
    diag_slot: object
    mat_perm: object
    mat_segs: object
    vec_perm: object
    vec_segs: object
    area: object          # (M,)
    jinv_t: object        # (M,2,2)
    cell_p0: object       # (M,2) first vertex (affine map offset)
    cell_e1: object       # (M,2) edge vectors (affine map columns)
    cell_e2: object       # (M,2)
    quad_pts: object      # (Q,2) reference coords
    quad_w: object        # (Q,)
    phi: object           # (Q,nloc)
    dphi: object          # (Q,nloc,2)
    h_cell: object        # (M,)
    # isoparametric per-quad-point geometry (== affine values on straight
    # cells; differs on curved-boundary cells)
    jinv_t_q: object      # (M,Q,2,2)
    detj_q: object        # (M,Q), dx = detj_q dxi


def build_space(mesh: Mesh, degree: int, quad_exactness: int | None = None,
                boundary_projector=None) -> FunctionSpace:
    """boundary_projector: optional callable (n,2)->(n,2) mapping points
    onto the true curved boundary (e.g. p/|p| for the unit disk). With
    degree >= 2 the boundary dofs are projected and the cell geometry map
    becomes isoparametric (see SpaceArrays.jinv_t_q), lifting the disk
    convergence past the straight-triangle O(h^2) geometry cap. Straight
    interior cells are unaffected (their per-q geometry equals the affine
    one exactly)."""
    if degree not in (1, 2, 3):
        raise ValueError("degree must be 1, 2 or 3")
    if degree >= 2 and getattr(mesh, "periodic", False):
        raise NotImplementedError(
            "Pk spaces on a make_periodic mesh: edge/interior dof "
            "coordinates and the cell geometry map are recomputed from "
            "points[cells], which is wrong on seam cells (their "
            "connectivity points at the fold's master nodes while their "
            "true geometry is the pre-fold triangle). Build the Pk space "
            "on the host mesh and apply the periodic identification to "
            "the Pk dofs instead.")
    k = degree
    cells = mesh.cells.astype(np.int64)
    n_vert = mesh.points.shape[0]
    M = cells.shape[0]
    nloc = (k + 1) * (k + 2) // 2

    # unique edges and their dof blocks
    edges_all = np.concatenate(
        [cells[:, [0, 1]], cells[:, [1, 2]], cells[:, [2, 0]]], axis=0
    )
    edges_sorted = np.sort(edges_all, axis=1)
    uniq_edges, edge_ids = np.unique(edges_sorted, axis=0, return_inverse=True)
    n_edge = uniq_edges.shape[0]
    edge_ids = edge_ids.reshape(3, M).T        # (M,3): edge id of local edges

    n_edge_dofs = (k - 1) * n_edge
    n_int = (k - 1) * (k - 2) // 2
    ndof = n_vert + n_edge_dofs + n_int * M

    # dof coords
    dof_coords = np.empty((ndof, 2))
    dof_coords[:n_vert] = mesh.points
    for e in range(1, k):
        frac = e / k
        idx = n_vert + np.arange(n_edge) * (k - 1) + (e - 1)
        dof_coords[idx] = (
            mesh.points[uniq_edges[:, 0]] * (1 - frac)
            + mesh.points[uniq_edges[:, 1]] * frac
        )
    # interior dof coords per cell (lattice order as reference_lattice)
    if n_int:
        lat = reference_lattice(k)[3 + 3 * (k - 1):]       # (n_int,2)
        p0 = mesh.points[cells[:, 0]]
        e1 = mesh.points[cells[:, 1]] - p0
        e2 = mesh.points[cells[:, 2]] - p0
        for j, (lx, ly) in enumerate(lat):
            idx = n_vert + n_edge_dofs + np.arange(M) * n_int + j
            dof_coords[idx] = p0 + lx * e1 + ly * e2

    # cell_dofs in canonical local order
    cell_dofs = np.empty((M, nloc), dtype=np.int64)
    cell_dofs[:, :3] = cells
    local_edges = [(0, 1), (1, 2), (2, 0)]
    col = 3
    for le, (a, b) in enumerate(local_edges):
        eid = edge_ids[:, le]
        forward = cells[:, a] == uniq_edges[eid, 0]     # traversal matches storage
        base = n_vert + eid * (k - 1)
        for e in range(1, k):
            fwd_idx = base + (e - 1)
            bwd_idx = base + (k - 1 - e)
            cell_dofs[:, col] = np.where(forward, fwd_idx, bwd_idx)
            col += 1
    for j in range(n_int):
        cell_dofs[:, col] = n_vert + n_edge_dofs + np.arange(M) * n_int + j
        col += 1

    # boundary dofs: boundary vertices + dofs of boundary edges
    boundary_mask = np.zeros(ndof, dtype=bool)
    boundary_mask[:n_vert] = mesh.boundary_mask
    _, counts = np.unique(edges_sorted, axis=0, return_counts=True)
    bnd_edge = counts == 1
    for e in range(1, k):
        idx = n_vert + np.nonzero(bnd_edge)[0] * (k - 1) + (e - 1)
        boundary_mask[idx] = True

    if boundary_projector is not None and k >= 2:
        # snap boundary dofs (vertices + boundary-edge dofs) onto the true
        # boundary -> isoparametric geometry on boundary cells
        bmask_tmp = np.zeros(ndof, dtype=bool)
        bmask_tmp[:n_vert] = mesh.boundary_mask
        _, counts_tmp = np.unique(edges_sorted, axis=0, return_counts=True)
        for e in range(1, k):
            idx = (n_vert + np.nonzero(counts_tmp == 1)[0] * (k - 1)
                   + (e - 1))
            bmask_tmp[idx] = True
        dof_coords[bmask_tmp] = boundary_projector(dof_coords[bmask_tmp])

    qp, qw = quadrature(quad_exactness or 2 * k)
    phi, dphi = tabulate_basis(k, qp)
    return _finalize_space(mesh, k, dof_coords, cell_dofs, boundary_mask,
                           qp, qw, phi, dphi)


def _finalize_space(mesh, k, dof_coords, cell_dofs, boundary_mask,
                    qp, qw, phi, dphi) -> FunctionSpace:
    """Adjacency, cell slots and scatter permutations from the dof map —
    shared by build_space and permute_dofs."""
    ndof = dof_coords.shape[0]
    M, nloc = cell_dofs.shape
    patch_cols, patch_mask, diag_slot, K = _build_adjacency(ndof, cell_dofs)

    # cell slots
    rows = np.repeat(cell_dofs, nloc, axis=1).reshape(M, nloc, nloc)
    colt = np.tile(cell_dofs, (1, nloc)).reshape(M, nloc, nloc)
    row_cols = patch_cols[rows.reshape(-1)]
    row_mask = patch_mask[rows.reshape(-1)]
    eq = (row_cols == colt.reshape(-1, 1)) & row_mask
    slot = np.argmax(eq, axis=1)
    assert eq[np.arange(eq.shape[0]), slot].all()
    cell_slots = slot.reshape(M, nloc, nloc).astype(np.int64)

    mat_target = (rows * K + cell_slots).reshape(-1)
    mat_perm = np.argsort(mat_target, kind="stable")
    mat_segs = mat_target[mat_perm]
    vec_target = cell_dofs.reshape(-1)
    vec_perm = np.argsort(vec_target, kind="stable")
    vec_segs = vec_target[vec_perm]

    return FunctionSpace(
        mesh=mesh, degree=k, dof_coords=dof_coords, cell_dofs=cell_dofs,
        boundary_mask=boundary_mask, patch_cols=patch_cols,
        patch_mask=patch_mask, diag_slot=diag_slot, cell_slots=cell_slots,
        mat_perm=mat_perm, mat_segs=mat_segs, vec_perm=vec_perm,
        vec_segs=vec_segs, quad_pts=qp, quad_w=qw, phi=phi, dphi=dphi,
    )


def rcm_dof_permutation(space: FunctionSpace) -> np.ndarray:
    """Reverse Cuthill-McKee ordering (old -> new) of the space's DOF
    adjacency graph. The native dof numbering (vertices, then edge dofs,
    then interior) has O(n) matrix bandwidth; RCM brings it back to
    O(sqrt(n)) so the blocked-window backend's one-hot operators stay
    small (cf. ops/mesh.rcm_permutation for the P1 mesh version)."""
    from conservation_fem_tpu.ops.mesh import rcm_from_connectivity

    return rcm_from_connectivity(space.ndof, space.cell_dofs)


def permute_dofs(space: FunctionSpace, perm: np.ndarray) -> FunctionSpace:
    """Renumber the space's dofs by perm (old -> new); rebuilds adjacency
    and scatter permutations. Cell-indexed data (quadrature geometry,
    areas) is unaffected; dof-indexed fields are permuted consistently, so
    solutions computed on the permuted space equal inverse-permuted
    solutions of the original (to summation-order roundoff)."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return _finalize_space(
        space.mesh, space.degree, space.dof_coords[inv],
        perm[space.cell_dofs], space.boundary_mask[inv],
        space.quad_pts, space.quad_w, space.phi, space.dphi)
