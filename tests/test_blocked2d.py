"""2D tiled-window blocked backend (ops/tiling + blocked.make_tiled_plan).

The large-N unstructured path: equal-count kd tiles give a 3-run window
of constant width W = 3*(2k+1)*nb (vs the 1D RCM band's nb + 2B with
B ~ sqrt(N)). Gate: full-run f64 identity with the gather-ELL solve on
the SAME mesh, mapped through the slot numbering (the tiled solution
lives in slot space: u_native = u_slots[slot_of_node]).

ref analog: DOLFINx ghosted-CSR scale-out (SURVEY 2.8) — the reference
has no single-rank window ceiling; this closes the same gap on one device.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from conservation_fem_tpu.models import kpp
from conservation_fem_tpu.ops import blocked
from conservation_fem_tpu.ops.mesh import irregular_mesh
from conservation_fem_tpu.ops.tiling import tile_layout, tile_mesh


@pytest.fixture(scope="module")
def meshes():
    m = irregular_mesh((-2, -2), (2, 2), nx=60, seed=1)
    mt, slot = tile_mesh(m)
    return m, mt, slot


def test_tile_layout_partitions(meshes):
    m, mt, slot = meshes
    assert mt.tile_T > 0 and mt.slot_valid is not None
    # every node gets a distinct slot; phantom count matches
    assert len(np.unique(slot)) == m.n_nodes
    assert mt.slot_valid.sum() == m.n_nodes
    assert mt.n_nodes % 128 == 0
    # phantoms are Dirichlet-pinned
    assert bool(mt.boundary_mask[~mt.slot_valid].all())


def test_tiled_plan_primitives(meshes):
    _, mt, _ = meshes
    plan = blocked.make_tiled_plan(mt, dtype=jnp.float64)
    assert plan.run_off is not None and plan.W == 3 * plan.rw * plan.nb
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(mt.n_nodes))
    # mass SpMV identity vs ELL
    from conservation_fem_tpu.ops import assembly
    from conservation_fem_tpu.ops.spmv import ell_matvec

    L = assembly.local_mass(np.asarray(plan.area_b).reshape(-1))
    D = blocked.assemble_matrix(
        plan, jnp.asarray(L.reshape(plan.blocks, plan.C, 3, 3)))
    y_blk = np.asarray(blocked.spmv(plan, D, x))
    M_ell = assembly.assemble_mass(mt)
    y_ell = np.asarray(ell_matvec(mt.device_arrays(jnp.float64), M_ell, x))
    assert np.abs(y_blk - y_ell).max() < 1e-14
    # diag extraction consistency
    d = np.asarray(blocked.diag_of(plan, D))
    dr = np.asarray(blocked.spmv(
        plan, D * np.asarray(plan.diag_eye)[None], jnp.ones_like(x)))
    assert np.abs(d - dr).max() < 1e-14


def test_full_run_identity_rv(meshes):
    m, mt, slot = meshes
    cfg = dict(dtype="float64", dt=0.005, T=0.05, backend="ell",
               krylov_rtol=1e-12)
    u_ref = np.asarray(kpp.build(kpp.KPPConfig(**cfg), host_mesh=m).solve().u)
    p2 = kpp.build(kpp.KPPConfig(**cfg, ell_matvec_backend="blocked2d"),
                   host_mesh=mt)
    u2 = np.asarray(p2.solve().u)
    assert np.abs(u2[slot] - u_ref).max() < 1e-11
    assert np.isfinite(u2).all()   # phantom rows pinned, no NaN leakage


def test_full_run_identity_fixed_iters(meshes):
    """The throughput config (modified Newton + fixed counts)."""
    m, mt, slot = meshes
    cfg = dict(dtype="float64", dt=0.005, T=0.03, backend="ell",
               modified_newton=True, cg_iters=6, newton_iters=2,
               newton_linear_iters=4, inner_solver="bicgstab")
    u_ref = np.asarray(kpp.build(kpp.KPPConfig(**cfg), host_mesh=m).solve().u)
    p2 = kpp.build(kpp.KPPConfig(**cfg, ell_matvec_backend="blocked2d"),
                   host_mesh=mt)
    u2 = np.asarray(p2.solve().u)
    assert np.abs(u2[slot] - u_ref).max() < 1e-11


def test_small_mesh_rejected():
    """T <= run width: the tiled layout degenerates — loud error."""
    m = irregular_mesh((0, 0), (1, 1), nx=12, seed=0)
    mt, _ = tile_mesh(m)
    with pytest.raises(blocked.WindowCoverageError):
        blocked.make_tiled_plan(mt, dtype=jnp.float64)


def test_sharded_tiled_identity(meshes):
    """DistributedBlocked over the tiled plan: the 2D 3-run window's
    halo is still ONE contiguous band ((T+k)*nb rows — strip-major slot
    ordering), so the band-halo ppermute machinery shards it directly.
    Identity with the single-device tiled solve at f64 roundoff."""
    import jax

    from conservation_fem_tpu.parallel.blocked_sharded import (
        DistributedBlocked,
    )

    m, mt, slot = meshes
    cfg = dict(dtype="float64", dt=0.005, T=0.03, backend="ell",
               ell_matvec_backend="blocked2d", krylov_rtol=1e-12)
    u1 = np.asarray(kpp.build(kpp.KPPConfig(**cfg), host_mesh=mt).solve().u)
    # 4 devices: each must own >= (T+k)*nb halo rows (T=6, k=1 here)
    devs = jax.devices()[:4]
    dmesh = jax.sharding.Mesh(np.array(devs), ("i",))
    tw = DistributedBlocked(kpp.build(kpp.KPPConfig(**cfg), host_mesh=mt),
                            dmesh)
    u_s = tw.solve()
    assert np.abs(u_s - u1).max() < 1e-12


def test_sharded_tiled_halo_too_small(meshes):
    """Too many devices for the (T+k)-block halo: loud error."""
    import jax

    from conservation_fem_tpu.parallel.blocked_sharded import (
        DistributedBlocked,
    )

    _, mt, _ = meshes
    cfg = dict(dtype="float64", backend="ell",
               ell_matvec_backend="blocked2d")
    p = kpp.build(kpp.KPPConfig(**cfg), host_mesh=mt)
    devs = jax.devices()[:8]
    dmesh = jax.sharding.Mesh(np.array(devs), ("i",))
    with pytest.raises(ValueError):
        DistributedBlocked(p, dmesh)


def test_full_run_identity_si(meshes):
    """SI stabilization on the tiled plan (si_alpha windows + bc-applied
    stiffness via apply_bc_matrix use the reinterpreted diag offset)."""
    m, mt, slot = meshes
    cfg = dict(dtype="float64", dt=0.005, T=0.03, backend="ell",
               stabilization="si", krylov_rtol=1e-12)
    u_ref = np.asarray(kpp.build(kpp.KPPConfig(**cfg), host_mesh=m).solve().u)
    p2 = kpp.build(kpp.KPPConfig(**cfg, ell_matvec_backend="blocked2d"),
                   host_mesh=mt)
    u2 = np.asarray(p2.solve().u)
    assert np.abs(u2[slot] - u_ref).max() < 1e-11


def test_full_run_identity_smoothing(meshes):
    """smooth_l > 0 exercises patch_sum — the lazily-built A_float
    (need_patch_sum) must materialize on this path."""
    m, mt, slot = meshes
    cfg = dict(dtype="float64", dt=0.005, T=0.02, backend="ell",
               smooth_l=2.0, krylov_rtol=1e-12)
    u_ref = np.asarray(kpp.build(kpp.KPPConfig(**cfg), host_mesh=m).solve().u)
    p2 = kpp.build(kpp.KPPConfig(**cfg, ell_matvec_backend="blocked2d"),
                   host_mesh=mt)
    assert p2.plan.A_float is not None
    u2 = np.asarray(p2.solve().u)
    assert np.abs(u2[slot] - u_ref).max() < 1e-11
