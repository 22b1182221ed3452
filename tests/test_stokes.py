"""IPCS Navier-Stokes tests vs exact Poiseuille flow
(ref Code/Compressible_euler/stokes.py:135-144,186-190)."""

import numpy as np
import pytest

from conservation_fem_tpu.models import stokes
from conservation_fem_tpu.ops.facets import boundary_facet_data
from conservation_fem_tpu.ops.mesh import rectangle_mesh
from conservation_fem_tpu.ops.spaces import build_space


def test_facet_data_geometry():
    mesh = rectangle_mesh((0, 0), (1, 1), nx=4)
    sp = build_space(mesh, 2)
    fd = boundary_facet_data(sp)
    assert len(fd.edge_cell) == 16
    np.testing.assert_allclose(fd.length, 0.25)
    # normals are unit and axis-aligned outward
    np.testing.assert_allclose(np.linalg.norm(fd.normal, axis=1), 1.0)
    assert set(map(tuple, np.round(fd.normal).astype(int))) == {
        (1, 0), (-1, 0), (0, 1), (0, -1)
    }
    # total boundary length
    np.testing.assert_allclose(fd.length.sum(), 4.0)


def test_poiseuille_converges_to_exact():
    """Pressure-driven channel flow reaches the parabolic profile."""
    res = stokes.solve(stokes.build(num_steps=150, T=3.0))
    assert res.error_l2 < 1e-4, res.error_l2
    u = np.asarray(res.u)
    np.testing.assert_allclose(u[0].max(), 1.0, atol=1e-3)
    assert np.abs(u[1]).max() < 1e-3


def test_lattice_backend_matches_ell():
    """Grid-space Krylov on the generalized lattice-stencil operators
    (ops/lattice.py) is numerically identical to the gather-ELL path —
    the Stokes "stencil backend" (P2 dofs on the half-step lattice)."""
    r1 = stokes.solve(stokes.build(num_steps=30, T=0.6))
    r2 = stokes.solve(stokes.build(num_steps=30, T=0.6, backend="lattice"))
    du = np.abs(np.asarray(r1.u) - np.asarray(r2.u)).max()
    dp = np.abs(np.asarray(r1.p) - np.asarray(r2.p)).max()
    assert du < 1e-10 and dp < 1e-10, (du, dp)


def test_fixed_iteration_solves_match_adaptive():
    """krylov_iters=25 (the throughput path) reproduces the adaptive
    solution: Poiseuille oracle error unchanged to 3 digits, u to 5e-8."""
    r_ref = stokes.solve(stokes.build(num_steps=60, T=1.2,
                                      backend="lattice"))
    r_fix = stokes.solve(stokes.build(num_steps=60, T=1.2,
                                      backend="lattice", krylov_iters=25))
    d = np.abs(np.asarray(r_ref.u) - np.asarray(r_fix.u)).max()
    assert d < 1e-6, d


def test_pressure_profile_linear():
    res = stokes.solve(stokes.build(num_steps=150, T=3.0))
    p, _ = stokes.build(num_steps=1)
    x = np.asarray(p.host_mesh.points[:, 0])
    # exact pressure p = 8 (1 - x)
    np.testing.assert_allclose(np.asarray(res.p), 8 * (1 - x), atol=2e-3)
