"""Generic Pk quadrature assembly over SpaceArrays (k = 1..3).

Replaces ffcx-generated element kernels for higher-degree spaces
(ref UFL forms at Code/Linear_advection/GFEM_pol.py:63-67 and the generated
tabulate_tensor kernels in Burger_CPP/Burger.h). Everything is one einsum
over (cells x quadrature points) with tabulated reference basis values —
batched dense work that XLA compiles to fused device kernels.

All outputs use the ELL layout defined by the space's dof adjacency, so the
SpMV/BC/stabilization machinery from the P1 path applies unchanged.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from conservation_fem_tpu.ops.spaces import SpaceArrays
# geometry/quadrature contractions run at exact f32 (no TF32/bf16
# operand rounding) — see ops/precision.py
from conservation_fem_tpu.ops.precision import einsum_exact as _einsum



def _phys_grads(sp: SpaceArrays):
    """Physical basis gradients at quad points: (M,Q,nloc,2).

    Uses the isoparametric per-quad-point J^{-T} (== affine J^{-T} on
    straight cells; curved-boundary cells get the bent geometry)."""
    return _einsum("mqde,qne->mqnd", sp.jinv_t_q, sp.dphi)


def scatter_matrix(sp: SpaceArrays, cell_vals):
    n, K = sp.patch_cols.shape
    flat = cell_vals.reshape(-1)[sp.mat_perm]
    out = jax.ops.segment_sum(
        flat, sp.mat_segs, num_segments=n * K, indices_are_sorted=True
    )
    return out.reshape(n, K)


def scatter_vector(sp: SpaceArrays, cell_vals):
    n = sp.patch_cols.shape[0]
    flat = cell_vals.reshape(-1)[sp.vec_perm]
    return jax.ops.segment_sum(
        flat, sp.vec_segs, num_segments=n, indices_are_sorted=True
    )


def assemble_mass(sp: SpaceArrays):
    vals = _einsum("q,mq,qa,qb->mab", sp.quad_w, sp.detj_q,
                      sp.phi, sp.phi)
    return scatter_matrix(sp, vals)


def assemble_stiffness(sp: SpaceArrays):
    g = _phys_grads(sp)                                   # (M,Q,n,2)
    vals = _einsum("q,mq,mqad,mqbd->mab", sp.quad_w, sp.detj_q, g, g)
    return scatter_matrix(sp, vals)


def assemble_convection(sp: SpaceArrays, w):
    """w: (ndof,2) vector field in the same space."""
    g = _phys_grads(sp)
    w_cell = w[sp.cell_dofs]                              # (M,n,2)
    w_q = _einsum("qc,mcd->mqd", sp.phi, w_cell)       # (M,Q,2)
    vals = _einsum("q,mq,qa,mqd,mqbd->mab", sp.quad_w, sp.detj_q,
                      sp.phi, w_q, g)
    return scatter_matrix(sp, vals)


def assemble_eps_stiffness(sp: SpaceArrays, eps):
    """eps: (ndof,) scalar field in the same space."""
    g = _phys_grads(sp)
    e_cell = eps[sp.cell_dofs]
    e_q = _einsum("qc,mc->mq", sp.phi, e_cell)
    vals = _einsum("q,mq,mq,mqad,mqbd->mab", sp.quad_w, sp.detj_q,
                      e_q, g, g)
    return scatter_matrix(sp, vals)


def convection_rhs_flux(sp: SpaceArrays, u, fprime):
    """r_a = int (f'(u_h) . grad u_h) phi_a dx."""
    g = _phys_grads(sp)
    u_cell = u[sp.cell_dofs]
    u_q = _einsum("qc,mc->mq", sp.phi, u_cell)
    grad_u = _einsum("mc,mqcd->mqd", u_cell, g)
    conv = _einsum("mqd,mqd->mq", fprime(u_q), grad_u)
    vals = _einsum("q,mq,mq,qa->ma", sp.quad_w, sp.detj_q, conv, sp.phi)
    return scatter_vector(sp, vals)


def assemble_flux_jacobian(sp: SpaceArrays, u, fprime):
    """ELL assembly of d/du N(u) in the Pk space
    (cf. assembly.assemble_flux_jacobian for the closed-form P1 version)."""
    g = _phys_grads(sp)                                   # (M,Q,n,2)
    u_cell = u[sp.cell_dofs]
    u_q = _einsum("qc,mc->mq", sp.phi, u_cell)
    fp, fpp = jax.jvp(fprime, (u_q,), (jnp.ones_like(u_q),))
    grad_u = _einsum("mc,mqcd->mqd", u_cell, g)
    t1 = _einsum("mqd,mqd->mq", fpp, grad_u)
    term1 = _einsum("q,mq,mq,qa,qb->mab", sp.quad_w, sp.detj_q, t1,
                       sp.phi, sp.phi)
    t2 = _einsum("mqd,mqbd->mqb", fp, g)
    term2 = _einsum("q,mq,qa,mqb->mab", sp.quad_w, sp.detj_q,
                       sp.phi, t2)
    vals = term1 + term2
    return scatter_matrix(sp, vals)


def mass_apply(sp: SpaceArrays, u):
    u_cell = u[sp.cell_dofs]
    u_q = _einsum("qb,mb->mq", sp.phi, u_cell)
    vals = _einsum("q,mq,mq,qa->ma", sp.quad_w, sp.detj_q, u_q, sp.phi)
    return scatter_vector(sp, vals)


def lumped_mass(sp: SpaceArrays):
    vals = _einsum("q,mq,qa->ma", sp.quad_w, sp.detj_q, sp.phi)
    return scatter_vector(sp, vals)


def quad_coords(sp: SpaceArrays):
    """Physical coordinates of the quadrature points: (M,Q,2) via the
    isoparametric map x = sum_c phi_c(xi) X_c (== affine on straight
    cells)."""
    X = sp.dof_coords[sp.cell_dofs]                        # (M,nloc,2)
    return _einsum("qc,mcd->mqd", sp.phi, X)


def l2_error_vs_function(sp: SpaceArrays, u, exact_fn, t=None):
    """sqrt(int (u_h - u_ex)^2) with u_ex evaluated at quadrature points."""
    u_cell = u[sp.cell_dofs]
    u_q = _einsum("qc,mc->mq", sp.phi, u_cell)
    xq = quad_coords(sp)
    ex = exact_fn(xq[..., 0], xq[..., 1]) if t is None else exact_fn(
        xq[..., 0], xq[..., 1], t
    )
    err2 = ((u_q - ex) ** 2 * sp.quad_w[None, :] * sp.detj_q).sum()
    return jnp.sqrt(err2)
