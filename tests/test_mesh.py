"""Mesh construction tests, mirroring the reference's hand-verifiable
micro-fixtures (ref tests/verification/{stiffness,patch_test,hk_test}.py)."""

import numpy as np
import pytest

from conservation_fem_tpu.ops.mesh import (
    disk_mesh,
    load_h5_mesh,
    mesh_from_arrays,
    rectangle_mesh,
)

KPP_H5 = "/root/reference/Data/KPP_RV.h5"


def test_handmade_mesh():
    """6-node / 4-triangle handmade mesh (ref tests/verification/hk_test.py:36-40)."""
    pts = np.array([[0, 0], [1, 0], [2, 0], [0, 1], [1, 1], [2, 1]], dtype=float)
    cells = np.array([[0, 1, 4], [0, 4, 3], [1, 2, 5], [1, 5, 4]])
    m = mesh_from_arrays(pts, cells)
    assert m.n_nodes == 6 and m.n_cells == 4
    np.testing.assert_allclose(m.area, 0.5)
    np.testing.assert_allclose(m.area.sum(), 2.0)
    # every node is on the boundary of this strip
    assert m.boundary_mask.all()
    # h_cell = min edge = 1 for all (legs 1, hyp sqrt2)
    np.testing.assert_allclose(m.h_cell, 1.0)


def test_patches_match_reference_semantics():
    """Patch = all nodes sharing a cell with i, including self
    (ref Code/Utils/SI.py:12-28; fixture ref tests/verification/patch_test.py)."""
    m = rectangle_mesh(nx=2, ny=2, diagonal="crossed")
    # crossed 2x2: 9 grid + 4 centers = 13 nodes, 16 triangles
    assert m.n_nodes == 13 and m.n_cells == 16
    patches = {}
    for c in m.cells:
        for a in c:
            patches.setdefault(int(a), set()).update(int(b) for b in c)
    for i in range(m.n_nodes):
        got = set(m.patch_cols[i][m.patch_mask[i]].tolist())
        assert got == patches[i], f"patch mismatch at node {i}"
        # diag_slot points at self
        assert m.patch_cols[i][m.diag_slot[i]] == i


def test_rectangle_geometry():
    m = rectangle_mesh((0, 0), (1, 1), nx=4, ny=4)
    assert m.n_nodes == 25 and m.n_cells == 32
    np.testing.assert_allclose(m.area.sum(), 1.0)
    # boundary = 16 perimeter nodes
    assert m.boundary_mask.sum() == 16
    np.testing.assert_allclose(m.h_cell, 0.25)


def test_rectangle_left_diagonal():
    m = rectangle_mesh((0, 0), (2, 1), nx=4, ny=2, diagonal="left")
    np.testing.assert_allclose(m.area.sum(), 2.0)
    assert m.n_cells == 16


def test_disk_mesh_quality():
    m = disk_mesh(hmax=1 / 8)
    # area approaches pi; with the outer polygon at nr rings:
    nr = 8
    n_outer = 6 * nr
    polygon_area = 0.5 * n_outer * np.sin(2 * np.pi / n_outer)
    np.testing.assert_allclose(m.area.sum(), polygon_area, rtol=1e-12)
    assert abs(m.area.sum() - np.pi) < 0.02
    # boundary nodes = outermost ring only
    assert m.boundary_mask.sum() == n_outer
    r = np.linalg.norm(m.points[m.boundary_mask], axis=1)
    np.testing.assert_allclose(r, 1.0, atol=1e-12)
    # all cells non-degenerate and h near hmax
    assert (m.area > 1e-6).all()
    assert 0.05 < m.h_cell.min() and m.h_cell.max() < 0.3


def test_irregular_mesh():
    """Jittered-Delaunay rectangle: exact area/boundary, deterministic
    (the committed f64 anchors of bench_blocked_scaling depend on
    bit-identical regeneration), genuinely irregular valences."""
    from conservation_fem_tpu.ops.mesh import irregular_mesh

    m = irregular_mesh((-2, -2), (2, 2), nx=12, seed=1)
    np.testing.assert_allclose(m.area.sum(), 16.0, rtol=1e-12)
    assert (m.area > 0).all()
    b = np.asarray(m.points[m.boundary_mask])
    on_edge = (np.isclose(np.abs(b[:, 0]), 2.0)
               | np.isclose(np.abs(b[:, 1]), 2.0))
    assert on_edge.all() and m.boundary_mask.sum() == 4 * 12
    m2 = irregular_mesh((-2, -2), (2, 2), nx=12, seed=1)
    assert np.array_equal(np.asarray(m.points), np.asarray(m2.points))
    assert np.array_equal(np.asarray(m.cells), np.asarray(m2.cells))
    # irregular: interior valences are not the structured {4,8} pattern
    deg = np.asarray(m.patch_mask).sum(1)
    assert len(np.unique(deg)) > 3


def test_load_reference_kpp_mesh():
    m = load_h5_mesh(KPP_H5)
    # ref Data/KPP_RV.xdmf:7-11 — 4886 nodes / 9514 triangles
    assert m.n_nodes == 4886 and m.n_cells == 9514
    np.testing.assert_allclose(m.area.sum(), 16.0, rtol=1e-9)  # [-2,2]^2
    assert (m.area > 0).all()


def test_scatter_orderings_consistent():
    m = rectangle_mesh(nx=3, ny=3)
    # matrix scatter targets must be a permutation-sorted view
    assert (np.diff(m.mat_segs) >= 0).all()
    assert (np.diff(m.vec_segs) >= 0).all()
    assert len(m.mat_perm) == 9 * m.n_cells
    assert len(m.vec_perm) == 3 * m.n_cells


def test_make_periodic():
    """Periodic node identification (ref Burger_CPP/main.cpp:146-192
    PeriodicBoundaryXY1): folds both axes of the unit square, corner
    chains through both folds, seam cells keep their true geometry, and
    the resulting convection operator conserves discrete mass exactly."""
    import jax.numpy as jnp

    from conservation_fem_tpu.ops import assembly
    from conservation_fem_tpu.ops.krylov import cg, jacobi_preconditioner
    from conservation_fem_tpu.ops.mesh import make_periodic, rectangle_mesh
    from conservation_fem_tpu.ops.spmv import ell_diag, ell_matvec

    host = rectangle_mesh((0, 0), (1, 1), nx=8)
    pm = make_periodic(host, axes=(0, 1))
    assert pm.points.shape[0] == 8 * 8          # (nx+1)^2 -> nx^2
    assert not pm.boundary_mask.any()           # fully periodic
    assert np.isclose(np.asarray(pm.area).sum(), 1.0)

    m = pm.device_arrays(jnp.float64)
    n = pm.points.shape[0]
    w = jnp.stack([jnp.ones(n), 0.5 * jnp.ones(n)], axis=1)
    M = assembly.assemble_mass(m)
    C = assembly.assemble_convection(m, w)
    u0 = jnp.asarray(np.random.default_rng(0).random(n))
    dt = 0.01
    Aop = lambda x: ell_matvec(m, M, x) + 0.5 * dt * ell_matvec(m, C, x)
    b = ell_matvec(m, M, u0) - 0.5 * dt * ell_matvec(m, C, u0)
    u1 = cg(Aop, b, precond=jacobi_preconditioner(ell_diag(m, M)),
            rtol=1e-14).x
    ones = jnp.ones(n)
    drift = abs(float(ones @ ell_matvec(m, M, u1 - u0)))
    assert drift < 1e-12, drift


def test_periodic_geometry_consumers_guarded():
    """points/cells are mutually inconsistent on seam cells of a
    make_periodic mesh (connectivity renumbered onto masters, geometry
    kept pre-fold), so consumers that recompute geometry from
    points[cells] must either refuse (Pk build_space) or filter the
    seam cells (plot triangulation)."""
    import pytest

    from conservation_fem_tpu.ops.mesh import make_periodic, rectangle_mesh
    from conservation_fem_tpu.ops.spaces import build_space
    from conservation_fem_tpu.utils.plotting import _triangulation

    host = rectangle_mesh((0, 0), (1, 1), nx=8)
    pm = make_periodic(host)
    assert pm.periodic and not host.periodic
    with pytest.raises(NotImplementedError, match="seam"):
        build_space(pm, 2)
    build_space(pm, 1)                         # P1 shares the solver's view
    tri = _triangulation(pm)
    p = np.asarray(pm.points)[tri.triangles]   # only true-sized triangles
    assert np.ptp(p, axis=1).max() < 2.0 * float(np.asarray(pm.h_cell).max())
    assert tri.triangles.shape[0] < pm.n_cells


def test_make_periodic_single_axis():
    """Periodic in x only: the y = 0, 1 walls stay boundary."""
    from conservation_fem_tpu.ops.mesh import make_periodic, rectangle_mesh

    host = rectangle_mesh((0, 0), (1, 1), nx=6)
    pm = make_periodic(host, axes=(0,))
    assert pm.points.shape[0] == 6 * 7
    bpts = np.asarray(pm.points)[np.asarray(pm.boundary_mask)]
    assert len(bpts) == 2 * 6                   # two walls, 6 nodes each
    assert all(np.isclose(y, 0.0) or np.isclose(y, 1.0) for y in bpts[:, 1])


def test_rectangle_mesh_lean_matches_full():
    """ops/mesh.rectangle_mesh_lean: identical geometry to the generic
    builder (unlocks mesh >= 2048 whose generic patch/scatter build
    exceeds host RAM), with placeholder sparse structure the stencil
    backend never reads."""
    import numpy as np

    from conservation_fem_tpu.ops.mesh import (rectangle_mesh,
                                               rectangle_mesh_lean)

    m1 = rectangle_mesh((-2, -2), (2, 2), 12, 12)
    m2 = rectangle_mesh_lean((-2, -2), (2, 2), 12, 12)
    assert np.array_equal(m1.points, m2.points)
    assert np.array_equal(m1.cells, m2.cells)
    assert np.array_equal(m1.boundary_mask, m2.boundary_mask)
    assert np.allclose(m1.area, m2.area)
    assert np.allclose(m1.grads, m2.grads)
    assert np.allclose(m1.h_cell, m2.h_cell)


def test_kpp_lean_mesh_trajectory_identity():
    import numpy as np

    from conservation_fem_tpu.models import kpp

    cfg = dict(mesh_size=8, dtype="float64", dt=0.01, T=0.03)
    u1 = np.asarray(kpp.build(kpp.KPPConfig(**cfg, lean_mesh=False)).solve().u)
    u2 = np.asarray(kpp.build(kpp.KPPConfig(**cfg, lean_mesh=True)).solve().u)
    assert np.array_equal(u1, u2)
