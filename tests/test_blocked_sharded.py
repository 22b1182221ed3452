"""Distributed blocked-window solver == single-device blocked solver
(band-halo windows + psum reductions) on the virtual CPU device mesh."""

import jax
import numpy as np
import pytest

from conservation_fem_tpu.models import kpp
from conservation_fem_tpu.parallel.blocked_sharded import DistributedBlocked


def _dmesh(n):
    devs = jax.devices()
    if len(devs) < n:
        pytest.skip(f"needs {n} devices")
    return jax.sharding.Mesh(np.array(devs[:n]), ("i",))


def _build(**kw):
    cfg = kpp.KPPConfig(mesh_size=8, T=0.05, backend="ell",
                        ell_matvec_backend="blocked", **kw)
    return kpp.build(cfg)


def test_distributed_blocked_rv_matches():
    p = _build()
    u_single = np.asarray(p.solve().u)
    u_dist = DistributedBlocked(_build(), _dmesh(4)).solve()
    d = np.abs(u_dist - u_single).max()
    assert d < 1e-9, d


def test_distributed_blocked_si_matches():
    p = _build(stabilization="si", smooth_l=2.0)
    u_single = np.asarray(p.solve().u)
    u_dist = DistributedBlocked(
        _build(stabilization="si", smooth_l=2.0), _dmesh(2)).solve()
    d = np.abs(u_dist - u_single).max()
    assert d < 1e-9, d


def test_distributed_blocked_devices_with_only_padding():
    """9 real blocks over 8 devices -> Lb=2, 7 inert pad blocks; the last
    devices own nothing real and must stay numerically inert."""
    p = _build()
    u_single = np.asarray(p.solve().u)
    sh = DistributedBlocked(_build(), _dmesh(8))
    assert sh.blocks_pad > sh.plan.blocks
    u_dist = sh.solve()
    d = np.abs(u_dist - u_single).max()
    assert d < 1e-9, d


def test_distributed_blocked_fast_solvers_match():
    """The sharded blocked path running the FAST fixed-iteration
    Chebyshev solvers (zero psum dots in the inner loops) matches the
    single-device blocked problem running the same config at 1e-9 —
    the fast kernels compose with sharding."""
    kw = dict(modified_newton=True, cg_iters=10, newton_iters=2,
              newton_linear_iters=16, inner_solver="cheby")
    p = _build(**kw)
    u_single = np.asarray(p.solve().u)
    u_dist = DistributedBlocked(_build(**kw), _dmesh(4)).solve()
    d = np.abs(u_dist - u_single).max()
    assert d < 1e-9, d
    # and the fixed config itself tracks the adaptive anchor
    u_adaptive = np.asarray(_build().solve().u)
    rel = (np.linalg.norm(u_single - u_adaptive)
           / np.linalg.norm(u_adaptive))
    assert rel < 2e-3, rel


def test_distributed_blocked_matrix_free_matches():
    """The matrix-free per-step operators (blocked_matrix_free=True,
    non-default: assembled windows are the default, but the matrix-free
    path stays supported) match single-device at 1e-9."""
    p = _build(blocked_matrix_free=True)
    u_single = np.asarray(p.solve().u)
    u_dist = DistributedBlocked(
        _build(blocked_matrix_free=True), _dmesh(4)).solve()
    d = np.abs(u_dist - u_single).max()
    assert d < 1e-9, d
