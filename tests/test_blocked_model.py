"""BlockedHyperbolicProblem end-to-end vs the gather-ELL problem.

Adaptive solvers at 1e-12: the two backends must agree to summation-order
roundoff over a full KPP run. Fixed-iteration unrolled solvers (the
throughput configuration) must stay within the Newton tolerance band of the
adaptive result.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from conservation_fem_tpu.models import kpp
from conservation_fem_tpu.ops.mesh import (
    rcm_permutation,
    rectangle_mesh,
    reorder_mesh,
)


@pytest.fixture(scope="module")
def rcm_mesh():
    hm = rectangle_mesh((-2, -2), (2, 2), nx=12)
    return reorder_mesh(hm, rcm_permutation(hm))


def _run(rcm_mesh, T=0.05, **kw):
    cfg = kpp.KPPConfig(mesh_size=12, T=T, backend="ell", **kw)
    p = kpp.build(cfg, host_mesh=rcm_mesh)
    return np.asarray(p.solve().u)


def test_blocked_matches_gather_full_run(rcm_mesh):
    u_g = _run(rcm_mesh, ell_matvec_backend="gather")
    u_b = _run(rcm_mesh, ell_matvec_backend="blocked")
    assert np.max(np.abs(u_b - u_g)) < 1e-9


def test_blocked_si_matches_gather(rcm_mesh):
    u_g = _run(rcm_mesh, stabilization="si", ell_matvec_backend="gather")
    u_b = _run(rcm_mesh, stabilization="si", ell_matvec_backend="blocked")
    assert np.max(np.abs(u_b - u_g)) < 1e-9


def test_matrix_free_matches_assembled(rcm_mesh):
    """The default matrix-free CN Newton (local_apply) vs the windowed
    assembled operators: same contributions, roundoff-only divergence."""
    u_mf = _run(rcm_mesh, ell_matvec_backend="blocked",
                blocked_matrix_free=True)
    u_as = _run(rcm_mesh, ell_matvec_backend="blocked",
                blocked_matrix_free=False)
    assert np.max(np.abs(u_mf - u_as)) < 1e-9


def test_fixed_iteration_solvers_match_adaptive(rcm_mesh):
    u_ad = _run(rcm_mesh, ell_matvec_backend="blocked")
    u_fx = _run(rcm_mesh, ell_matvec_backend="blocked",
                cg_iters=30, newton_iters=6, newton_linear_iters=25)
    # fixed counts chosen generously here: must reproduce the adaptive
    # (1e-12-Krylov) trajectory to ~Newton-tolerance accuracy
    assert np.max(np.abs(u_fx - u_ad)) < 1e-6


def test_blocked_smoothing_path(rcm_mesh):
    u_g = _run(rcm_mesh, stabilization="si", smooth_l=4.0,
               ell_matvec_backend="gather")
    u_b = _run(rcm_mesh, stabilization="si", smooth_l=4.0,
               ell_matvec_backend="blocked")
    assert np.max(np.abs(u_b - u_g)) < 1e-9
