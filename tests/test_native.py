"""Native C++ preprocessor vs NumPy path equality + RCM properties."""

import numpy as np
import pytest

from conservation_fem_tpu import native_ext
from conservation_fem_tpu.ops.mesh import (
    disk_mesh,
    load_h5_mesh,
    mesh_from_arrays,
    rcm_permutation,
    rectangle_mesh,
    reorder_mesh,
)


def test_native_builds():
    assert native_ext.available(), "g++ build of native/mesh_preprocess.cpp failed"


def test_native_library_is_built_from_source_when_missing(tmp_path,
                                                          monkeypatch):
    """The library is not committed: first use compiles it from the C++
    source to its (git-ignored) path."""
    lib = tmp_path / "libcftmesh.so"
    monkeypatch.setattr(native_ext, "_LIB", str(lib))
    monkeypatch.setattr(native_ext, "_lib", None)
    monkeypatch.setattr(native_ext, "_build_failed", False)
    assert native_ext.available()
    assert lib.exists()
    assert not list(tmp_path.glob("*.tmp"))


def test_native_matches_numpy_structures():
    base = disk_mesh(1 / 8)
    m_native = mesh_from_arrays(base.points, base.cells, use_native=True)
    m_numpy = mesh_from_arrays(base.points, base.cells, use_native=False)
    np.testing.assert_array_equal(m_native.boundary_mask, m_numpy.boundary_mask)
    np.testing.assert_array_equal(m_native.patch_cols, m_numpy.patch_cols)
    np.testing.assert_array_equal(m_native.patch_mask, m_numpy.patch_mask)
    np.testing.assert_array_equal(m_native.diag_slot, m_numpy.diag_slot)
    np.testing.assert_array_equal(m_native.cell_slots, m_numpy.cell_slots)


def test_native_on_reference_mesh():
    m = load_h5_mesh("/root/reference/Data/KPP_RV.h5")
    m2 = mesh_from_arrays(m.points, m.cells, use_native=False)
    np.testing.assert_array_equal(m.patch_cols, m2.patch_cols)
    np.testing.assert_array_equal(m.boundary_mask, m2.boundary_mask)


def test_native_structured_rectangle_matches():
    got = native_ext.structured_rectangle(4, 3, 0, 0, 2, 1)
    assert got is not None
    points, cells = got
    ref = rectangle_mesh((0, 0), (2, 1), nx=4, ny=3)
    np.testing.assert_allclose(points, ref.points)
    np.testing.assert_array_equal(cells, ref.cells)


def test_rcm_reduces_bandwidth():
    mesh = disk_mesh(1 / 16)
    perm = rcm_permutation(mesh)
    assert sorted(perm.tolist()) == list(range(mesh.n_nodes))

    def bandwidth(m):
        c = m.cells.astype(np.int64)
        return int(np.max(c.max(axis=1) - c.min(axis=1)))

    re = reorder_mesh(mesh, perm)
    assert bandwidth(re) < bandwidth(mesh)
    # physical content preserved
    np.testing.assert_allclose(np.sort(re.area), np.sort(mesh.area))
    assert re.boundary_mask.sum() == mesh.boundary_mask.sum()


def test_reordered_mesh_solves_identically():
    """Poisson solution is permutation-equivariant."""
    import jax.numpy as jnp

    from conservation_fem_tpu.ops import assembly
    from conservation_fem_tpu.ops.bc import constrained_operator, lift_rhs
    from conservation_fem_tpu.ops.krylov import cg

    mesh = disk_mesh(1 / 8)
    perm = rcm_permutation(mesh)
    re = reorder_mesh(mesh, perm)

    def solve(m):
        ma = m.device_arrays(jnp.float64)
        K = assembly.assemble_stiffness(ma)
        g = ma.points[:, 0] ** 2 - ma.points[:, 1] ** 2
        b = lift_rhs(ma, K, jnp.zeros(m.n_nodes), g, ma.boundary_mask)
        return np.asarray(
            cg(constrained_operator(ma, K, ma.boundary_mask), b, rtol=1e-13).x
        )

    u1 = solve(mesh)
    u2 = solve(re)
    np.testing.assert_allclose(u2[perm], u1, atol=1e-10)
