"""P1 finite-element assembly as vectorized cell kernels + ELL scatter.

Replacement for UFL forms + ffcx JIT + PETSc assembly
(ref Code/Linear_advection/linear_advection.py:110-124 and the
FFC-generated tabulate_tensor kernels in Burger_CPP/Burger.h).

Local closed forms on a triangle with area A and constant P1 gradients g_a:
  mass       M_ab  = A/12 * (1 + delta_ab)
  stiffness  K_ab  = A * g_a . g_b
  convection C_ab  = sum_c M_ac * (w_c . g_b)          (w P1 vector field)
  eps-stiff  Ke_ab = (g_a . g_b) * A * mean(eps_cell)   (eps P1 scalar)

Nonlinear convection vectors (Burgers u*(ux+uy), KPP (cos u, -sin u) . grad u,
ref Code/KPP/KPP_NodeRV.py:53-55) use a degree-4 Dunavant quadrature rule —
exact for the quadratic Burgers integrand, high-accuracy for KPP's
transcendental flux (matching ffcx's estimated quadrature degree).

Assembled operators live in the ELL layout defined by ``Mesh.patch_cols`` so
that stabilization kernels (SI) can read matrix entries per patch directly
(replacing PETSc Mat.getValue/getRow, ref Code/Utils/SI.py:54,164).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from conservation_fem_tpu.ops.mesh import MeshArrays
# geometry/quadrature contractions run at exact f32 (no TF32/bf16
# operand rounding) — see ops/precision.py
from conservation_fem_tpu.ops.precision import einsum_exact as _einsum


# degree-4 Dunavant rule on the reference triangle (6 points), exact to p=4
_DUN4_W = jnp.array(
    [0.223381589678011, 0.223381589678011, 0.223381589678011,
     0.109951743655322, 0.109951743655322, 0.109951743655322]
)
_a1, _b1 = 0.445948490915965, 0.108103018168070
_a2, _b2 = 0.091576213509771, 0.816847572980459
_DUN4_P = jnp.array(
    [[_a1, _a1], [_b1, _a1], [_a1, _b1],
     [_a2, _a2], [_b2, _a2], [_a2, _b2]]
)


def _quad_basis():
    """P1 basis values at the quadrature points: (Q,3)."""
    x, y = _DUN4_P[:, 0], _DUN4_P[:, 1]
    return jnp.stack([1.0 - x - y, x, y], axis=1)


# ---------------------------------------------------------------------------
# local cell matrices (vmapped closed forms)
# ---------------------------------------------------------------------------


def local_mass(area):
    """(M,) -> (M,3,3) local mass matrices."""
    base = ((jnp.ones((3, 3)) + jnp.eye(3)) / 12.0).astype(area.dtype)
    return area[:, None, None] * base[None]


def local_stiffness(area, grads):
    """(M,),(M,3,2) -> (M,3,3) local stiffness."""
    gg = _einsum("mad,mbd->mab", grads, grads)
    return area[:, None, None] * gg


def local_convection(area, grads, w_cell):
    """(M,),(M,3,2),(M,3,2) -> (M,3,3) local convection with P1 vector w.

    C_ab = int (w . grad phi_b) phi_a = sum_c M_ac (w_c . g_b).
    """
    m = local_mass(area)                       # (M,3,3)
    wg = _einsum("mcd,mbd->mcb", w_cell, grads)  # (M,3,3): (c,b)
    return _einsum("mac,mcb->mab", m, wg)


def local_eps_stiffness(area, grads, eps_cell):
    """eps-weighted stiffness, eps P1: Ke_ab = g_a.g_b * A * mean(eps)."""
    gg = _einsum("mad,mbd->mab", grads, grads)
    scale = area * eps_cell.mean(axis=1)
    return scale[:, None, None] * gg


# ---------------------------------------------------------------------------
# scatter: cell values -> ELL matrix / nodal vector
# ---------------------------------------------------------------------------


def scatter_matrix(mesh: MeshArrays, cell_vals):
    """(M,3,3) local matrices -> (N,K) ELL matrix, deterministic order."""
    n, K = mesh.patch_cols.shape
    flat = cell_vals.reshape(-1)
    flat = flat[mesh.mat_perm]
    out = jax.ops.segment_sum(
        flat, mesh.mat_segs, num_segments=n * K, indices_are_sorted=True
    )
    return out.reshape(n, K)


def scatter_vector(mesh: MeshArrays, cell_vals):
    """(M,3) local vectors -> (N,) nodal vector, deterministic order."""
    n = mesh.patch_cols.shape[0]
    flat = cell_vals.reshape(-1)
    flat = flat[mesh.vec_perm]
    return jax.ops.segment_sum(
        flat, mesh.vec_segs, num_segments=n, indices_are_sorted=True
    )


# ---------------------------------------------------------------------------
# assembled global operators (ELL)
# ---------------------------------------------------------------------------


def assemble_mass(mesh: MeshArrays):
    return scatter_matrix(mesh, local_mass(mesh.area))


def assemble_stiffness(mesh: MeshArrays):
    return scatter_matrix(mesh, local_stiffness(mesh.area, mesh.grads))


def assemble_convection(mesh: MeshArrays, w):
    """w: (N,2) P1 vector field."""
    w_cell = w[mesh.cells]                      # (M,3,2)
    return scatter_matrix(mesh, local_convection(mesh.area, mesh.grads, w_cell))


def assemble_eps_stiffness(mesh: MeshArrays, eps):
    """eps: (N,) P1 scalar viscosity field."""
    eps_cell = eps[mesh.cells]                  # (M,3)
    return scatter_matrix(
        mesh, local_eps_stiffness(mesh.area, mesh.grads, eps_cell)
    )


def assemble_directional_convection(mesh: MeshArrays):
    """Cx, Cy with (Cd)_ab = int phi_a d_d phi_b dx = (A/3) g_b[d] per cell.

    Used for group-FEM divergence of vector/tensor fluxes (Euler):
    (div F_h)_i ~ ML^-1 (Cx Fx + Cy Fy) with F_h = sum_j F(U_j) phi_j.
    """
    a3 = mesh.area / 3.0
    gx = jnp.broadcast_to(
        (a3[:, None] * mesh.grads[:, :, 0])[:, None, :], (mesh.area.shape[0], 3, 3)
    )
    gy = jnp.broadcast_to(
        (a3[:, None] * mesh.grads[:, :, 1])[:, None, :], (mesh.area.shape[0], 3, 3)
    )
    return scatter_matrix(mesh, gx), scatter_matrix(mesh, gy)


def lumped_mass(mesh: MeshArrays):
    """Row-sum lumped mass vector (N,)."""
    cell_vals = mesh.area[:, None] * (jnp.ones(3, mesh.area.dtype) / 3.0)
    return scatter_vector(mesh, cell_vals)


# ---------------------------------------------------------------------------
# nonlinear convection residual vectors (quadrature)
# ---------------------------------------------------------------------------


def local_convection_rhs(area, grads, u_cell, fprime):
    """(M,),(M,3,2),(M,3) -> (M,3) local vectors of
    r_a = int (f'(u_h) . grad u_h) phi_a dx over one cell."""
    phi = _quad_basis().astype(u_cell.dtype)     # (Q,3)
    u_q = _einsum("ma,qa->mq", u_cell, phi)      # (M,Q)
    fp_q = fprime(u_q)                           # (M,Q,2)
    grad_u = _einsum("ma,mad->md", u_cell, grads)       # (M,2) const
    conv_q = _einsum("mqd,md->mq", fp_q, grad_u)        # (M,Q)
    w = _DUN4_W.astype(u_cell.dtype) * 0.5       # ref triangle area = 1/2
    # r[m,a] = 2*A_m * sum_q w_q conv_q phi_a(q)   (|J| = 2A)
    r = _einsum("mq,qa->ma", conv_q * w[None, :], phi)
    return 2.0 * area[:, None] * r


def local_flux_jacobian(area, grads, u_cell, fprime):
    """(M,),(M,3,2),(M,3) -> (M,3,3) local Jacobian of the convection rhs:

      J_ab = int [ (f''(u) . grad u) phi_b + f'(u) . grad phi_b ] phi_a dx

    f'' is obtained as the elementwise jvp of ``fprime`` — no user-provided
    second derivative needed.
    """
    phi = _quad_basis().astype(u_cell.dtype)     # (Q,3)
    u_q = _einsum("ma,qa->mq", u_cell, phi)      # (M,Q)
    fp_q, fpp_q = jax.jvp(fprime, (u_q,), (jnp.ones_like(u_q),))
    grad_u = _einsum("ma,mad->md", u_cell, grads)               # (M,2)
    t1 = _einsum("mqd,md->mq", fpp_q, grad_u)                   # (M,Q)
    w = _DUN4_W.astype(u_cell.dtype) * 0.5
    # term1[m,a,b] = 2A sum_q w_q t1 phi_a phi_b
    term1 = _einsum("mq,qa,qb->mab", t1 * w[None], phi, phi)
    # term2[m,a,b] = 2A sum_q w_q (f'(u_q) . g_b) phi_a
    t2 = _einsum("mqd,mbd->mqb", fp_q, grads)
    term2 = _einsum("q,qa,mqb->mab", w, phi, t2)
    return 2.0 * area[:, None, None] * (term1 + term2)


def convection_rhs_flux(mesh: MeshArrays, u, fprime):
    """r_a = int (f'(u_h) . grad u_h) phi_a dx, vectorized over cells.

    fprime: callable u -> (..., 2) flux derivative evaluated pointwise
    (ref velocity_field(u) in Code/KPP/KPP_NodeRV.py:53-55 and
    Code/Burgers_equation/Exact_Burger_RV.py:33-35).
    """
    r = local_convection_rhs(mesh.area, mesh.grads, u[mesh.cells], fprime)
    return scatter_vector(mesh, r)


def assemble_flux_jacobian(mesh: MeshArrays, u, fprime):
    """ELL assembly of d/du N(u) (see local_flux_jacobian). Identical (to
    roundoff) to the jvp of ``convection_rhs_flux`` since the same
    quadrature rule is used; the point of materializing it is performance:
    Newton's inner Krylov iterations become single ELL SpMVs instead of
    full re-quadratures."""
    vals = local_flux_jacobian(mesh.area, mesh.grads, u[mesh.cells], fprime)
    return scatter_matrix(mesh, vals)


def mass_apply_cellwise(mesh: MeshArrays, u):
    """y = M u without assembling M (consistent mass action)."""
    u_cell = u[mesh.cells]                       # (M,3)
    m = local_mass(mesh.area)
    return scatter_vector(mesh, _einsum("mab,mb->ma", m, u_cell))


def l2_norm_sq(mesh: MeshArrays, u):
    """int u_h^2 dx (exact for P1 via local mass): scalar."""
    return u @ mass_apply_cellwise(mesh, u)


def l2_error_vs_function(mesh: MeshArrays, u, exact_fn, t=None):
    """sqrt(int (u_h - u_ex)^2 dx) with u_ex evaluated at quadrature points.

    Replaces assemble_scalar((uh-u_ex)**2 dx) with u_ex interpolated into a
    higher-degree space (ref Code/Linear_advection/RV_node_convergence.py:239)
    — here the exact callable is evaluated directly at the quad points.
    """
    phi = _quad_basis().astype(u.dtype)          # (Q,3)
    u_cell = u[mesh.cells]
    u_q = _einsum("ma,qa->mq", u_cell, phi)      # (M,Q)
    pts_q = _einsum("qa,mad->mqd", phi, mesh.points[mesh.cells])  # (M,Q,2)
    if t is None:
        ex_q = exact_fn(pts_q[..., 0], pts_q[..., 1])
    else:
        ex_q = exact_fn(pts_q[..., 0], pts_q[..., 1], t)
    w = _DUN4_W.astype(u.dtype) * 0.5
    err = ((u_q - ex_q) ** 2 * w[None, :]).sum(axis=1) * 2.0 * mesh.area
    return jnp.sqrt(err.sum())
