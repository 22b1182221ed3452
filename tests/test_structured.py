"""Stencil backend vs generic ELL backend: exact numerical identity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conservation_fem_tpu.models import kpp
from conservation_fem_tpu.ops import assembly, structured as st
from conservation_fem_tpu.ops.mesh import rectangle_mesh
from conservation_fem_tpu.ops.spmv import ell_matvec


@pytest.fixture(scope="module")
def setup():
    host = rectangle_mesh((-2, -2), (2, 2), nx=12, ny=12)
    m = host.device_arrays(jnp.float64)
    sd = st.build_structured(host, 12, 12, jnp.float64)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=host.n_nodes))
    return host, m, sd, x


def test_mass_matvec_matches(setup):
    host, m, sd, x = setup
    M = assembly.assemble_mass(m)
    y_ell = ell_matvec(m, M, x)
    y_st = st.mass_matvec(sd, x.reshape(13, 13)).reshape(-1)
    np.testing.assert_allclose(np.asarray(y_st), np.asarray(y_ell), atol=1e-14)


def test_nonlinear_rhs_matches(setup):
    host, m, sd, x = setup
    fp = lambda u: jnp.stack([jnp.cos(u), -jnp.sin(u)], axis=-1)
    r_ell = assembly.convection_rhs_flux(m, x, fp)
    r_st = st.nonlinear_rhs(sd, x.reshape(13, 13), fp).reshape(-1)
    np.testing.assert_allclose(np.asarray(r_st), np.asarray(r_ell), atol=1e-13)


def test_keps_matches(setup):
    host, m, sd, x = setup
    eps = jnp.abs(x) * 0.01
    K_ell = assembly.assemble_eps_stiffness(m, eps)
    v = jnp.sin(x)
    y_ell = ell_matvec(m, K_ell, v)
    Kc = st.keps_coef(sd, eps.reshape(13, 13))
    y_st = st.matvec(sd, Kc, v.reshape(13, 13)).reshape(-1)
    np.testing.assert_allclose(np.asarray(y_st), np.asarray(y_ell), atol=1e-13)


def test_flux_jacobian_matches(setup):
    host, m, sd, x = setup
    fp = lambda u: jnp.stack([jnp.cos(u), -jnp.sin(u)], axis=-1)
    J_ell = assembly.assemble_flux_jacobian(m, x, fp)
    v = jnp.cos(3 * x)
    y_ell = ell_matvec(m, J_ell, v)
    Jc = st.flux_jacobian_coef(sd, x.reshape(13, 13), fp)
    y_st = st.matvec(sd, Jc, v.reshape(13, 13)).reshape(-1)
    np.testing.assert_allclose(np.asarray(y_st), np.asarray(y_ell), atol=1e-12)


def test_rv_epsilon_matches(setup):
    host, m, sd, x = setup
    from conservation_fem_tpu.ops import stabilization as stab

    Rh = jnp.sin(5 * x)
    fpn = lambda u: jnp.ones_like(u)
    h = sd.h_cg2.reshape(-1)
    e_ell = stab.rv_epsilon_nonlinear(m, 0.5, 4.0, x, x, fpn, Rh, h)
    e_st = st.rv_epsilon(sd, 0.5, 4.0, x.reshape(13, 13), Rh.reshape(13, 13),
                         fpn).reshape(-1)
    np.testing.assert_allclose(np.asarray(e_st), np.asarray(e_ell), atol=1e-14)


def test_full_kpp_solve_matches_ell_backend():
    """End-to-end: stencil-backend KPP == ELL-backend KPP to f64 roundoff."""
    r_st = kpp.build(kpp.KPPConfig(mesh_size=4, T=0.05, backend="stencil")).solve()
    r_ell = kpp.build(kpp.KPPConfig(mesh_size=4, T=0.05, backend="ell")).solve()
    np.testing.assert_allclose(
        np.asarray(r_st.u), np.asarray(r_ell.u), atol=1e-10
    )


def test_si_stencil_matches_ell():
    r1 = kpp.build(kpp.KPPConfig(mesh_size=4, T=0.05, stabilization="si",
                                 backend="stencil")).solve()
    r2 = kpp.build(kpp.KPPConfig(mesh_size=4, T=0.05, stabilization="si",
                                 backend="ell")).solve()
    np.testing.assert_allclose(np.asarray(r1.u), np.asarray(r2.u), atol=1e-12)


def test_smoothing_stencil_matches_ell():
    from conservation_fem_tpu.models import burgers

    p1 = burgers.build(burgers.BurgersConfig(
        mesh_size=20, stabilization="si", smooth_l=4.0, backend="stencil", T=0.1))
    p2 = burgers.build(burgers.BurgersConfig(
        mesh_size=20, stabilization="si", smooth_l=4.0, backend="ell", T=0.1))
    np.testing.assert_allclose(
        np.asarray(p1.solve().u), np.asarray(p2.solve().u), atol=1e-10)


def test_xla_bf16_planes():
    """bf16 solver-plane streaming (structured.sweep_form knob).

    f64: sweep_form is a no-op, so the run is bit-identical. f32: only
    the fixed-iteration solve directions are perturbed (~1e-3 relative
    operator rounding); the trajectory must stay within a loose bound of
    the exact-f32 run.
    """
    base = dict(mesh_size=4, T=0.05, backend="stencil", cg_iters=6,
                newton_iters=2, newton_linear_iters=4)
    r64a = kpp.build(kpp.KPPConfig(**base)).solve()
    r64b = kpp.build(kpp.KPPConfig(xla_bf16_planes=True, **base)).solve()
    np.testing.assert_array_equal(np.asarray(r64a.u), np.asarray(r64b.u))

    r32a = kpp.build(kpp.KPPConfig(dtype="float32", **base)).solve()
    r32b = kpp.build(kpp.KPPConfig(dtype="float32", xla_bf16_planes=True,
                                   **base)).solve()
    ref = np.asarray(r32a.u)
    diff = np.abs(np.asarray(r32b.u) - ref).max()
    assert np.isfinite(np.asarray(r32b.u)).all()
    assert diff < 5e-3 * max(1.0, np.abs(ref).max()), diff


def _fixed(inner_solver, **kw):
    """bench.py-style fixed-iteration config; cheby gets twice the
    BiCGStab count (1 matvec per iteration instead of 2)."""
    return dict(mesh_size=4, T=0.05, cg_iters=6, newton_iters=2,
                newton_linear_iters=4 if inner_solver == "bicgstab" else 8,
                inner_solver=inner_solver, **kw)


@pytest.mark.parametrize("stabilization", ["rv", "gfem"])
@pytest.mark.parametrize("modified_newton", [True, False],
                         ids=["frozen", "exact"])
@pytest.mark.parametrize("inner_solver", ["bicgstab", "cheby"])
def test_fixed_iteration_step_matches_ell(inner_solver, modified_newton,
                                          stabilization):
    """The composed-XLA fixed-iteration structured step (the GPU main
    path) == the independent ELL/gather step with the same fixed counts,
    at f64 roundoff, over the solver and stabilization choices."""
    cfg = _fixed(inner_solver, modified_newton=modified_newton,
                 stabilization=stabilization)
    r_st = kpp.build(kpp.KPPConfig(backend="stencil", **cfg)).solve()
    r_ell = kpp.build(kpp.KPPConfig(backend="ell", **cfg)).solve()
    np.testing.assert_allclose(np.asarray(r_st.u), np.asarray(r_ell.u),
                               atol=1e-10)


# bf16 sweep planes perturb only the fixed-iteration solve directions, so
# the f32 end state stays close to the f64 run of the same config:
# measured 2.9e-6 L2rel at this size (plain f32: 5e-8). A bf16 residual or
# quadrature pass would move it towards bf16 eps (~4e-3); 1e-4 tells the
# two apart.
BF16_PLANES_TOL = 1e-4


@pytest.mark.parametrize("inner_solver", ["bicgstab", "cheby"])
def test_xla_bf16_planes_f32_tracks_f64(inner_solver):
    cfg = _fixed(inner_solver, modified_newton=True, backend="stencil")
    u64 = np.asarray(kpp.build(kpp.KPPConfig(**cfg)).solve().u)
    u32 = np.asarray(kpp.build(kpp.KPPConfig(
        dtype="float32", xla_bf16_planes=True, **cfg)).solve().u)
    assert u32.dtype == np.float32
    rel = np.linalg.norm(u32 - u64) / np.linalg.norm(u64)
    assert rel <= BF16_PLANES_TOL, rel


def test_cheby_full_run_matches_adaptive():
    """Chebyshev fixed-iteration config reproduces the adaptive f64
    anchor on a full KPP run (same gate as the bicgstab fixed config)."""
    anchor = np.asarray(
        kpp.build(kpp.KPPConfig(mesh_size=8, T=0.2)).solve().u)
    u = np.asarray(kpp.build(kpp.KPPConfig(
        mesh_size=8, T=0.2, modified_newton=True, cg_iters=10,
        newton_iters=2, newton_linear_iters=12,
        inner_solver="cheby")).solve().u)
    rel = np.linalg.norm(u - anchor) / np.linalg.norm(anchor)
    assert rel < 2e-3, rel
