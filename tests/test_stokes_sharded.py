"""Distributed IPCS Stokes == single-device solver on the 8-virtual-device
CPU mesh (conftest pins platform + device count)."""

import jax
import numpy as np
import pytest

from conservation_fem_tpu.models import stokes
from conservation_fem_tpu.parallel.stokes_sharded import ShardedStokes


def _dmesh(n):
    devs = jax.devices()
    if len(devs) < n:
        pytest.skip(f"needs {n} devices")
    return jax.sharding.Mesh(np.array(devs[:n]), ("i",))


@pytest.mark.parametrize("n_dev", [4, 8])
def test_sharded_matches_single_device(n_dev):
    cfg = dict(nx=10, num_steps=40, T=0.8)
    p, fd = stokes.build(**cfg)
    res = stokes.solve((p, fd))
    sh = ShardedStokes(*stokes.build(**cfg), _dmesh(n_dev))
    u_d, p_d = sh.solve()
    du = np.abs(u_d - np.asarray(res.u)).max()
    dp = np.abs(p_d - np.asarray(res.p)).max()
    assert du < 1e-9 and dp < 1e-9, (du, dp)


def test_sharded_fixed_solvers_match_single_device():
    """Fixed-iteration (krylov_iters + auto kip) sharded step == the
    single-device fixed step: identical algorithm, psum dots — roundoff
    agreement only."""
    cfg = dict(nx=10, num_steps=40, T=0.8, krylov_iters=20)
    p, fd = stokes.build(**cfg)
    res = stokes.solve((p, fd))
    sh = ShardedStokes(*stokes.build(**cfg), _dmesh(4))
    u_d, p_d = sh.solve()
    du = np.abs(u_d - np.asarray(res.u)).max()
    dp = np.abs(p_d - np.asarray(res.p)).max()
    assert du < 1e-9 and dp < 1e-9, (du, dp)


def test_sharded_uneven_rows():
    """Row count (nx+1 = 8 coarse rows) not divisible by 3 devices."""
    cfg = dict(nx=7, num_steps=20, T=0.4)
    p, fd = stokes.build(**cfg)
    res = stokes.solve((p, fd))
    sh = ShardedStokes(*stokes.build(**cfg), _dmesh(3))
    u_d, p_d = sh.solve()
    du = np.abs(u_d - np.asarray(res.u)).max()
    dp = np.abs(p_d - np.asarray(res.p)).max()
    assert du < 1e-9 and dp < 1e-9, (du, dp)


def test_sharded_multigrid_matches_single_device():
    """MG-preconditioned sharded solves == single-device multigrid run.

    nx=16 exercises BOTH sharded MG shapes: the momentum hierarchy has a
    real stencil level 0 (33^2 fine grid -> local smoothing + gathered
    coarse correction) while the pressure hierarchy is the dense-only
    degenerate (17^2 < coarse_max -> gather + cinv matmul + row slice)."""
    cfg = dict(nx=16, num_steps=20, T=0.4, backend="lattice",
               multigrid=True)
    p, fd = stokes.build(**cfg)
    res = stokes.solve((p, fd))
    sh = ShardedStokes(*stokes.build(**cfg), _dmesh(8))
    assert sh._mg1_n > 0 and sh._mg2_n == 0
    u_d, p_d = sh.solve()
    du = np.abs(u_d - np.asarray(res.u)).max()
    dp = np.abs(p_d - np.asarray(res.p)).max()
    assert du < 1e-9 and dp < 1e-9, (du, dp)


def test_sharded_multigrid_fixed_uneven_rows():
    """MG + fixed iteration counts (the throughput config) on a
    device count that does not divide the rows."""
    cfg = dict(nx=16, num_steps=20, T=0.4, backend="lattice",
               multigrid=True, krylov_iters=6)
    p, fd = stokes.build(**cfg)
    res = stokes.solve((p, fd))
    sh = ShardedStokes(*stokes.build(**cfg), _dmesh(3))
    u_d, p_d = sh.solve()
    du = np.abs(u_d - np.asarray(res.u)).max()
    dp = np.abs(p_d - np.asarray(res.p)).max()
    assert du < 1e-9 and dp < 1e-9, (du, dp)


def test_sharded_multigrid_dense_only():
    """Tiny grid: both hierarchies degenerate to the dense coarsest
    solve — the gather + cinv + slice path on every device."""
    cfg = dict(nx=8, num_steps=10, T=0.2, backend="lattice",
               multigrid=True)
    p, fd = stokes.build(**cfg)
    res = stokes.solve((p, fd))
    sh = ShardedStokes(*stokes.build(**cfg), _dmesh(4))
    assert sh._mg1_n == 0 and sh._mg2_n == 0
    u_d, p_d = sh.solve()
    du = np.abs(u_d - np.asarray(res.u)).max()
    dp = np.abs(p_d - np.asarray(res.p)).max()
    assert du < 1e-9 and dp < 1e-9, (du, dp)


def test_sharded_multigrid_pressure_stencil_level():
    """Regression: the PRESSURE hierarchy with a real stencil level
    (nx=26 -> 27^2 = 729 > coarse_max) sharded over >1 device — a review
    found the mg2 dinv in_spec sharded the size-1 component axis instead
    of the rows, crashing at trace time for every even nx >= 26."""
    cfg = dict(nx=26, num_steps=6, T=0.12, backend="lattice",
               multigrid=True, krylov_iters=6)
    p, fd = stokes.build(**cfg)
    res = stokes.solve((p, fd))
    sh = ShardedStokes(*stokes.build(**cfg), _dmesh(4))
    assert sh._mg2_n > 0
    u_d, p_d = sh.solve()
    du = np.abs(u_d - np.asarray(res.u)).max()
    dp = np.abs(p_d - np.asarray(res.p)).max()
    assert du < 1e-9 and dp < 1e-9, (du, dp)


def test_multigrid_dense_degeneration_guard():
    """build_mg refuses a large even-sized (non-coarsenable) grid
    instead of dense-inverting the whole operator (review finding)."""
    with pytest.raises(ValueError, match="dense-solve limit"):
        # the MG hierarchy is built lazily at solve time (step_buffers);
        # the guard fires host-side before any compile
        stokes.solve(stokes.build(nx=63, num_steps=1, backend="lattice",
                                  multigrid=True))


def test_backend_grid_matches_lattice():
    """backend="grid" (the fully gather-free single-chip step: the
    grid-space SPMD formulation on a 1-device mesh) == the lattice
    backend, adaptive and with multigrid."""
    base = dict(nx=10, num_steps=20, T=0.4)
    for extra in ({}, dict(multigrid=True)):
        r_l = stokes.solve(stokes.build(**base, backend="lattice", **extra))
        r_g = stokes.solve(stokes.build(**base, backend="grid", **extra))
        du = np.abs(np.asarray(r_g.u) - np.asarray(r_l.u)).max()
        dp = np.abs(np.asarray(r_g.p) - np.asarray(r_l.p)).max()
        assert du < 1e-9 and dp < 1e-9, (extra, du, dp)
