"""KPP rotating-wave tests (ref Code/KPP/KPP_NodeRV.py) — the north-star
workload."""

import jax.numpy as jnp
import numpy as np
import pytest

from conservation_fem_tpu.models import kpp


def test_rv_coarse_runs_in_bounds():
    res = kpp.run(mesh_size=8, record_metrics=True)
    assert res.num_steps == 100
    assert bool(res.metrics["newton_converged"].all())
    # maximum principle up to small over/undershoot: [pi/4, 14pi/4]
    assert float(res.u.min()) > np.pi / 4 - 0.2
    assert float(res.u.max()) < 14 * np.pi / 4 + 0.2
    # Newton on the mildly nonlinear CN system converges in few iters
    assert int(res.metrics["newton_iters"].max()) <= 5


def test_si_coarse_runs():
    res = kpp.run(mesh_size=8, stabilization="si", record_metrics=True)
    assert bool(res.metrics["newton_converged"].all())
    assert np.isfinite(np.asarray(res.u)).all()


def test_reference_mesh_loads_and_steps():
    """One step on the stored FEniCSx reference mesh (Data/KPP_RV.h5)."""
    p = kpp.build(mesh_source=kpp.KPP_REFERENCE_H5, T=0.02)
    res = p.solve()
    assert res.u.shape == (4886,)
    assert np.isfinite(np.asarray(res.u)).all()


def test_boundary_pinned_at_pi4():
    res = kpp.run(mesh_size=8)
    p = kpp.build(mesh_size=8)
    bnd = np.asarray(p.mesh.boundary_mask)
    np.testing.assert_allclose(np.asarray(res.u)[bnd], np.pi / 4, atol=1e-12)


def test_epsilon_localized_at_discontinuity():
    """RV viscosity should concentrate near the initial circle, not the
    far field (qualitative check of the patch kernel wiring)."""
    p = kpp.build(mesh_size=8, record_metrics=True)
    m = p.mesh
    RH = p._residual_bdf2(p.u0, p.u0, p.u0)
    eps = p._epsilon(p.u0, RH)
    r = np.linalg.norm(np.asarray(m.points), axis=1)
    near = np.abs(r - 1.0) < 0.2
    # deep interior: far enough that neither the consistent-mass residual
    # spread nor the patch-max reaches the discontinuity
    far = r < 0.35
    assert float(eps[near].max()) > 10 * float(eps[far].max() + 1e-30)


def test_banded_backend_matches_gather_on_gmsh_mesh():
    """RCM-banded operator application == gather ELL on the reference's
    unstructured gmsh mesh (gather-free diagonals)."""
    from conservation_fem_tpu.ops.mesh import (
        load_h5_mesh,
        rcm_permutation,
        reorder_mesh,
    )

    base = load_h5_mesh(kpp.KPP_REFERENCE_H5)
    mesh = reorder_mesh(base, rcm_permutation(base))
    r1 = kpp.build(kpp.KPPConfig(mesh_size=32, T=0.03), host_mesh=mesh).solve()
    r2 = kpp.build(
        kpp.KPPConfig(mesh_size=32, T=0.03, ell_matvec_backend="banded"),
        host_mesh=mesh,
    ).solve()
    np.testing.assert_allclose(np.asarray(r1.u), np.asarray(r2.u), atol=1e-12)
