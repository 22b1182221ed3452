"""Blocked-window backend for linear advection vs the gather path.

Full-run identity (to summation-order roundoff, f64) for every variant
with a window form; rv_cell raises (order-dependent last-cell-wins
scatter, documented guard)."""

import numpy as np
import pytest

from conservation_fem_tpu.models import linear_advection as la
from conservation_fem_tpu.ops.mesh import rcm_permutation


@pytest.mark.parametrize(
    "stab", ["gfem", "rv_node", "rv_node_simple", "si", "rk4"])
def test_blocked_advection_matches_gather(stab):
    cfg = dict(mesh_size=8, T=0.05, stabilization=stab, dtype="float64")
    pg = la.build(la.AdvectionConfig(**cfg))
    pb = la.build(la.AdvectionConfig(**cfg, ell_matvec_backend="blocked"))
    ug = np.asarray(la.solve(pg).u)
    ub = np.asarray(la.solve(pb).u)
    inv = np.argsort(rcm_permutation(pg.host_mesh))
    d = np.abs(ub - ug[inv]).max()
    assert d < 1e-11, (stab, d)


def test_blocked_advection_rv_cell_guard():
    """last-cell-wins is order-dependent and guarded; the order-
    independent 'max' scatter has a window form and matches gather."""
    with pytest.raises(NotImplementedError):
        la.build(la.AdvectionConfig(stabilization="rv_cell",
                                    ell_matvec_backend="blocked"))
    cfg = dict(mesh_size=8, T=0.05, stabilization="rv_cell",
               rv_cell_scatter="max", dtype="float64")
    pg = la.build(la.AdvectionConfig(**cfg))
    pb = la.build(la.AdvectionConfig(**cfg, ell_matvec_backend="blocked"))
    ug = np.asarray(la.solve(pg).u)
    ub = np.asarray(la.solve(pb).u)
    inv = np.argsort(rcm_permutation(pg.host_mesh))
    assert np.abs(ub - ug[inv]).max() < 1e-11


def test_blocked_advection_fixed_iteration_solvers():
    """Fixed-iteration (and dot-free cheby) solver knobs match the
    adaptive 1e-12 run at their expected inexactness levels."""
    cfg = dict(mesh_size=8, T=0.1, stabilization="rv_node",
               dtype="float64", ell_matvec_backend="blocked")
    ua = np.asarray(la.solve(la.build(la.AdvectionConfig(**cfg))).u)
    uf = np.asarray(la.solve(la.build(la.AdvectionConfig(
        **cfg, cg_iters=10, krylov_iters=10))).u)
    uc = np.asarray(la.solve(la.build(la.AdvectionConfig(
        **cfg, cg_iters=12, krylov_iters=14, inner_solver="cheby"))).u)
    assert np.abs(uf - ua).max() < 1e-5
    assert np.abs(uc - ua).max() < 1e-3


def test_blocked_pk_advection_matches_gather():
    """Higher-order advection (advection_ho) on the blocked Pk backend
    matches the gather path over full runs (f64)."""
    from conservation_fem_tpu.models import advection_ho as ho
    from conservation_fem_tpu.ops.spaces import (build_space,
                                                 rcm_dof_permutation)

    for stab_name, deg in [("gfem", 2), ("rv", 2), ("rv_simple", 3),
                           ("si", 2)]:
        cfg = dict(mesh_size=6, degree=deg, T=0.05,
                   stabilization=stab_name, dtype="float64")
        pg, ug, _ = ho.run(**cfg)
        pb, ub, _ = ho.run(**cfg, ell_matvec_backend="blocked")
        perm = rcm_dof_permutation(build_space(pg.host_mesh, deg))
        d = np.abs(np.asarray(ub) - np.asarray(ug)[np.argsort(perm)]).max()
        assert d < 1e-10, (stab_name, deg, d)


def test_distributed_blocked_advection_matches():
    """DistributedBlockedAdvection vs the single-device blocked run."""
    import jax
    from jax.sharding import Mesh as DeviceMesh

    from conservation_fem_tpu.parallel.blocked_advection_sharded import \
        DistributedBlockedAdvection

    dmesh = DeviceMesh(np.array(jax.devices()[:4]), ("i",))
    for stab_name in ("gfem", "rv_node", "rv_node_simple", "si"):
        cfg = dict(mesh_size=8, T=0.05, stabilization=stab_name,
                   dtype="float64", ell_matvec_backend="blocked")
        u_single = np.asarray(la.solve(la.build(la.AdvectionConfig(**cfg))).u)
        u_dist = DistributedBlockedAdvection(
            la.build(la.AdvectionConfig(**cfg)), dmesh).solve()
        d = np.abs(u_dist - u_single).max()
        assert d < 1e-9, (stab_name, d)


def test_blocked_precise_f32_quality():
    """f32 blocked runs default to the PRECISE plan (f32 one-hots +
    Precision.HIGHEST contractions): over a long smooth-transport horizon
    the bf16 operand streams visibly diffuse the solution (the 569-step
    reference-disk rotation). Gate:
    the precise f32 trajectory stays within f32 noise of gather-f32."""
    import jax.numpy as jnp

    from conservation_fem_tpu.ops import blocked

    cfg = dict(mesh_size=8, T=0.25, stabilization="rv_node",
               dtype="float32")
    pg = la.build(la.AdvectionConfig(**cfg))
    pb = la.build(la.AdvectionConfig(**cfg, ell_matvec_backend="blocked"))
    assert pb.blkplan.precise and pb.blkplan.Gcell.dtype == jnp.float32
    ug = np.asarray(la.solve(pg).u, np.float64)
    ub = np.asarray(la.solve(pb).u, np.float64)
    inv = np.argsort(rcm_permutation(pg.host_mesh))
    l2 = np.linalg.norm(ub - ug[inv]) / np.linalg.norm(ug)
    assert l2 < 1e-4, l2

    # knob off -> bf16 one-hot storage (the throughput mode)
    pb16 = la.build(la.AdvectionConfig(**cfg, ell_matvec_backend="blocked",
                                       blocked_precise=False))
    assert pb16.blkplan.Gcell.dtype == jnp.bfloat16
    # f64 plans ignore the knob (identity-test regime stays exact)
    p64 = blocked.make_blocked_plan(pb.host_mesh, dtype=jnp.float64,
                                    precise=True)
    assert not p64.precise and p64.Gcell.dtype == jnp.float32

    # Pk twin: HOAdvectionConfig defaults precise ON for f32 blocked,
    # and the trajectory stays at f32 noise of the gather path
    # (measured: precise 1.9e-5 vs bf16 streams 2.3e-2 at T=0.2)
    from conservation_fem_tpu.models import advection_ho as ho
    from conservation_fem_tpu.ops.spaces import (build_space,
                                                 rcm_dof_permutation)

    hocfg = dict(mesh_size=4, degree=2, T=0.1, stabilization="rv",
                 dtype="float32")
    pg2, ug2, _ = ho.run(**hocfg)
    pho, ub2, _ = ho.run(**hocfg, ell_matvec_backend="blocked")
    assert pho.blkplan.precise and pho.blkplan.Gcell.dtype == jnp.float32
    perm2 = rcm_dof_permutation(build_space(pg2.host_mesh, 2))
    ug2 = np.asarray(ug2, np.float64)[np.argsort(perm2)]
    l2p = np.linalg.norm(np.asarray(ub2, np.float64) - ug2) / \
        np.linalg.norm(ug2)
    assert l2p < 1e-3, l2p
