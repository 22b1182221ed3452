"""Blocked-window backend vs the ELL backend: exact-identity tests.

Every blocked op must reproduce its ELL twin to summation-order roundoff
(f64 here; conftest pins CPU + x64). The blocked backend exists purely for
performance — any numerical divergence beyond reordering noise is a bug.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from conservation_fem_tpu.ops import assembly, blocked
from conservation_fem_tpu.ops import stabilization as stab
from conservation_fem_tpu.ops.bc import ell_with_bc
from conservation_fem_tpu.ops.mesh import (
    disk_mesh,
    rcm_permutation,
    rectangle_mesh,
    reorder_mesh,
)
from conservation_fem_tpu.ops.spmv import ell_diag, ell_matvec

TOL = 1e-11


@pytest.fixture(scope="module")
def setup():
    hm = disk_mesh(1.0 / 8)
    hm = reorder_mesh(hm, rcm_permutation(hm))
    m = hm.device_arrays(jnp.float64)
    plan = blocked.make_blocked_plan(hm, nb=64, dtype=jnp.float64)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal(hm.n_nodes))
    return hm, m, plan, x


def rel(a, b):
    return float(jnp.max(jnp.abs(a - b)) / (1e-300 + jnp.max(jnp.abs(b))))


def test_device_onehot_matches_host_scatter(setup):
    """build_onehot (device compare-and-select materialization) must equal
    the host numpy fancy-scatter it replaced, bit for bit, for every
    operator family — including the Rrow/Ccol assembly one-hots only the
    build_rc=True path emits."""
    hm, _, _, _ = setup
    st = blocked._plan_struct(
        hm.n_nodes, np.asarray(hm.cells, np.int64), hm.patch_cols,
        hm.patch_mask, hm.boundary_mask, 64, build_rc=True)
    for key in ("Gcell", "Sv", "Rrow", "Ccol"):
        idx, mask, width = st[key]
        dev = np.asarray(blocked.build_onehot(st[key], jnp.float32))
        ref = np.zeros(dev.shape, np.float32)
        bb, ss = np.nonzero(mask)
        ref[bb, ss, idx[bb, ss]] = 1.0
        np.testing.assert_array_equal(dev, ref, err_msg=key)
        assert dev.sum() > 0, key


def test_windows_rows_roundtrip(setup):
    _, _, plan, x = setup
    w = blocked.windows(plan, x)
    back = blocked.unblock(plan, blocked.rows_of(plan, w))
    assert rel(back, x) == 0.0


def test_spmv_and_diag_match_ell(setup):
    hm, m, plan, x = setup
    M_ell = assembly.assemble_mass(m)
    area_b = plan.area_b
    locs = assembly.local_mass(area_b.reshape(-1)).reshape(
        plan.blocks, plan.C, 3, 3)
    D = blocked.assemble_matrix(plan, locs)
    assert rel(blocked.spmv(plan, D, x), ell_matvec(m, M_ell, x)) < TOL
    assert rel(blocked.diag_of(plan, D), ell_diag(m, M_ell)) < TOL


def test_gather_scatter_cells(setup):
    hm, m, plan, x = setup
    uc = blocked.gather_cells(plan, x)
    # compare against direct u[cells] through the plan's cell lists:
    # scatter both through their own paths and compare nodal results
    r_blk = blocked.scatter_cell_vectors(plan, uc * plan.area_b[:, :, None])
    r_ell = assembly.scatter_vector(
        m, x[m.cells] * m.area[:, None])
    assert rel(r_blk, r_ell) < TOL


def test_flux_jacobian_and_rhs_match(setup):
    hm, m, plan, x = setup
    fprime = lambda u: jnp.stack([jnp.cos(u), -jnp.sin(u)], axis=-1)
    r_ell = assembly.convection_rhs_flux(m, x, fprime)
    uc = blocked.gather_cells(plan, x)
    r_loc = assembly.local_convection_rhs(
        plan.area_b.reshape(-1), plan.grads_b.reshape(-1, 3, 2),
        uc.reshape(-1, 3), fprime).reshape(plan.blocks, plan.C, 3)
    r_blk = blocked.scatter_cell_vectors(plan, r_loc)
    assert rel(r_blk, r_ell) < TOL

    J_ell = assembly.assemble_flux_jacobian(m, x, fprime)
    j_loc = assembly.local_flux_jacobian(
        plan.area_b.reshape(-1), plan.grads_b.reshape(-1, 3, 2),
        uc.reshape(-1, 3), fprime).reshape(plan.blocks, plan.C, 3, 3)
    J_blk = blocked.assemble_matrix(plan, j_loc)
    y = jnp.asarray(np.random.default_rng(5).standard_normal(hm.n_nodes))
    assert rel(blocked.spmv(plan, J_blk, y), ell_matvec(m, J_ell, y)) < TOL


def test_eps_stiffness_match(setup):
    hm, m, plan, x = setup
    eps = jnp.abs(x)
    K_ell = assembly.assemble_eps_stiffness(m, eps)
    ec = blocked.gather_cells(plan, eps)
    k_loc = assembly.local_eps_stiffness(
        plan.area_b.reshape(-1), plan.grads_b.reshape(-1, 3, 2),
        ec.reshape(-1, 3)).reshape(plan.blocks, plan.C, 3, 3)
    K_blk = blocked.assemble_matrix(plan, k_loc)
    assert rel(blocked.spmv(plan, K_blk, x), ell_matvec(m, K_ell, x)) < TOL


def test_local_apply_matches_assembled(setup):
    """Matrix-free local_apply/local_diag == assemble_matrix + spmv/diag_of
    to summation-order roundoff (the matrix-free CN Newton path's basis)."""
    hm, m, plan, x = setup
    fprime = lambda u: jnp.stack([jnp.cos(u), -jnp.sin(u)], axis=-1)
    uc = blocked.gather_cells(plan, x)
    L = assembly.local_flux_jacobian(
        plan.area_b.reshape(-1), plan.grads_b.reshape(-1, 3, 2),
        uc.reshape(-1, 3), fprime).reshape(plan.blocks, plan.C, 3, 3)
    D = blocked.assemble_matrix(plan, L)
    y = jnp.asarray(np.random.default_rng(7).standard_normal(hm.n_nodes))
    assert rel(blocked.local_apply(plan, L, y),
               blocked.spmv(plan, D, y)) < TOL
    assert rel(blocked.local_diag(plan, L), blocked.diag_of(plan, D)) < TOL


def test_bc_matrix_match(setup):
    hm, m, plan, x = setup
    K_ell = ell_with_bc(m, assembly.assemble_stiffness(m), m.boundary_mask)
    k_loc = assembly.local_stiffness(
        plan.area_b.reshape(-1), plan.grads_b.reshape(-1, 3, 2)).reshape(
        plan.blocks, plan.C, 3, 3)
    K_blk = blocked.apply_bc_matrix(plan, blocked.assemble_matrix(plan, k_loc))
    assert rel(blocked.spmv(plan, K_blk, x), ell_matvec(m, K_ell, x)) < TOL


def test_patch_reductions_match(setup):
    hm, m, plan, x = setup
    gmax = stab._masked_max(x[m.patch_cols], m.patch_mask)
    gmin = stab._masked_min(x[m.patch_cols], m.patch_mask)
    assert rel(blocked.patch_max(plan, x), gmax) == 0.0
    assert rel(blocked.patch_min(plan, x), gmin) == 0.0
    gabs = stab._masked_max(jnp.abs(x[m.patch_cols]), m.patch_mask)
    assert rel(blocked.patch_abs_max(plan, x), gabs) == 0.0


def test_rv_epsilon_match(setup):
    hm, m, plan, x = setup
    h = jnp.ones(hm.n_nodes) * 0.1
    fpn = lambda u: jnp.ones_like(u)
    Rh = jnp.sin(7 * x)
    e_ell = stab.rv_epsilon_nonlinear(m, 0.5, 4.0, x, x * 0.9, fpn, Rh, h)
    e_blk = blocked.rv_epsilon_nonlinear(plan, 0.5, 4.0, x, x * 0.9, fpn,
                                         Rh, h)
    assert rel(e_blk, e_ell) < TOL


def test_si_alpha_match(setup):
    hm, m, plan, x = setup
    K_ell = ell_with_bc(m, assembly.assemble_stiffness(m), m.boundary_mask)
    a_ell = stab.si_alpha(m, K_ell, x, eps_floor=1e-8)
    k_loc = assembly.local_stiffness(
        plan.area_b.reshape(-1), plan.grads_b.reshape(-1, 3, 2)).reshape(
        plan.blocks, plan.C, 3, 3)
    K_blk = blocked.apply_bc_matrix(plan, blocked.assemble_matrix(plan, k_loc))
    a_blk = blocked.si_alpha(plan, K_blk, x, eps_floor=1e-8)
    assert rel(a_blk, a_ell) < 1e-9


def test_smooth_vector_match(setup):
    hm, m, plan, x = setup
    s_ell = stab.smooth_vector(m, x, 4.0)
    s_blk = blocked.smooth_vector(plan, x, 4.0)
    assert rel(s_blk, s_ell) < TOL


def test_constrained_matvec_match(setup):
    hm, m, plan, x = setup
    from conservation_fem_tpu.ops.bc import constrained_matvec as cmv_ell

    M_ell = assembly.assemble_mass(m)
    locs = assembly.local_mass(plan.area_b.reshape(-1)).reshape(
        plan.blocks, plan.C, 3, 3)
    D = blocked.assemble_matrix(plan, locs)
    bc = m.boundary_mask
    y_ell = cmv_ell(m, M_ell, x, bc)
    y_blk = blocked.constrained_matvec(plan, D, x, bc)
    assert rel(y_blk, y_ell) < TOL


def test_sweep_form_semantics(setup):
    """sweep_form: no-op for f64 plans (identity tests stay exact); bf16
    copy for f32 plans, whose spmv matches the f32 einsum within bf16
    operand eps (the f32 einsum runs in full precision on CPU, hence the
    tolerance here)."""
    hm, m, plan, x = setup
    M = blocked.assemble_matrix(
        plan, assembly.local_mass(plan.area_b.reshape(-1)).reshape(
            plan.blocks, plan.C, 3, 3))
    assert blocked.sweep_form(plan, M) is M          # f64: no copy

    plan32 = blocked.make_blocked_plan(hm, nb=64, dtype=jnp.float32)
    M32 = blocked.assemble_matrix(
        plan32, assembly.local_mass(
            plan32.area_b.reshape(-1)).reshape(
            plan32.blocks, plan32.C, 3, 3)).astype(jnp.float32)
    Ms = blocked.sweep_form(plan32, M32)
    assert Ms.dtype == jnp.bfloat16
    x32 = x.astype(jnp.float32)
    y_s = blocked.spmv(plan32, Ms, x32)
    y_f = blocked.spmv(plan32, M32, x32)
    assert y_s.dtype == jnp.float32
    r = rel(y_s, y_f)
    assert r < 2e-2, r                               # bf16 operand eps
