"""Artificial-viscosity stabilization: RV and SI epsilon kernels.

Vectorized replacements for the reference's per-node Python loops:

  * RV (residual viscosity), 5 variants mirroring class RV
    (ref Code/Utils/RV.py:27-142).
  * SI (smoothness indicator) with sigmoid gate, mirroring class SI
    (ref Code/Utils/SI.py:30-67,147-192); stiffness entries are read from
    the patch-aligned ELL matrix instead of PETSc Mat.getValue.
  * patch smoothing, mirroring smooth_vector (ref Code/Utils/helpers.py:40-50).

Every kernel is a handful of (N,K) gathers + masked row reductions — the
whole epsilon computation is O(N*K) vector work with no host round-trips,
replacing the reference's dominant serial cost (SURVEY.md section 2.8).

Reference quirks reproduced deliberately:
  * the patch normalization n_i = |u_tilde - ||u - mean(u)||_inf| can be ~0
    and spike R_i; only the min() guards it (ref RV.py:83-88) — kept, with a
    tiny-denominator floor only to avoid literal division by zero.
  * ``get_epsilon_linear`` evaluates the velocity at the *patch owner* node
    (fi = w_values[node] inside the adjacency loop, ref RV.py:113-116), so
    beta is simply |w_i| — kept.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax.numpy as jnp

from conservation_fem_tpu.ops.mesh import MeshArrays


def _patch_gather(mesh: MeshArrays, x):
    """x (N,) -> (N,K) patch values (padding gathers self, masked later)."""
    return x[mesh.patch_cols]


def _masked_max(vals, mask):
    return jnp.where(mask, vals, -jnp.inf).max(axis=1)


def _masked_min(vals, mask):
    return jnp.where(mask, vals, jnp.inf).min(axis=1)


def inf_norm_centered(u):
    """||u - mean(u)||_inf (ref RV.py:59)."""
    return jnp.abs(u - u.mean()).max()


# ---------------------------------------------------------------------------
# RV — residual viscosity (ref Code/Utils/RV.py)
# ---------------------------------------------------------------------------


def rv_epsilon(Cvel, Crv, h, residual, beta):
    """Plain nodal RV: eps_i = min(Cvel h_i beta_i, Crv h_i^2 |R_i|)
    (ref RV.py:27-40 get_epsilon; beta_i = |f'(u_i)|)."""
    return jnp.minimum(Cvel * h * beta, Crv * h**2 * jnp.abs(residual))


def rv_epsilon_1storder(h, beta):
    """First-order viscosity eps_i = 0.5 h_i |f'(u_i)| (ref RV.py:42-54)."""
    return 0.5 * h * beta


def rv_epsilon_nonlinear(
    mesh: MeshArrays, Cvel, Crv, uh, u_n, fprime_norm: Callable, Rh, h
):
    """Patch-normalized RV for nonlinear fluxes (ref RV.py:56-90).

    fprime_norm: u -> |f'(u)| pointwise (e.g. KPP: |(cos u, -sin u)| = 1,
    Burgers: sqrt(2)|u|).
    For each node i with patch P_i:
      u_tilde = max_{j in P_i} u_n_j - min u_n_j
      n_i     = |u_tilde - ||uh - mean uh||_inf|
      R_i     = max_{j in P_i} |Rh_j| / n_i
      beta_i  = max_{j in P_i} |f'(uh_j)|
      eps_i   = min(Cvel h_i beta_i, Crv h_i^2 |R_i|)
    """
    mask = mesh.patch_mask
    abs_term = inf_norm_centered(uh)
    u_patch = _patch_gather(mesh, u_n)
    u_tilde = _masked_max(u_patch, mask) - _masked_min(u_patch, mask)
    n_i = jnp.abs(u_tilde - abs_term)
    Rh_i = _masked_max(jnp.abs(_patch_gather(mesh, Rh)), mask)
    # avoid literal 0/0; the reference lets n_i ~ 0 spike R_i and relies on
    # the min() to clamp (RV.py:83-88)
    tiny = jnp.asarray(1e-300 if n_i.dtype == jnp.float64 else 1e-30, n_i.dtype)
    R_i = Rh_i / jnp.maximum(n_i, tiny)
    beta = _masked_max(_patch_gather(mesh, fprime_norm(uh)), mask)
    return jnp.minimum(Cvel * h * beta, Crv * h**2 * jnp.abs(R_i))


def rv_epsilon_linear(mesh: MeshArrays, Cvel, Crv, uh, u_n, w, Rh, h):
    """Patch-normalized RV with a vector velocity field w (N,2)
    (ref RV.py:92-127). Note: the reference evaluates |w| at the patch owner
    (RV.py:113-114), so beta_i = |w_i| — reproduced exactly."""
    mask = mesh.patch_mask
    abs_term = inf_norm_centered(uh)
    u_patch = _patch_gather(mesh, u_n)
    u_tilde = _masked_max(u_patch, mask) - _masked_min(u_patch, mask)
    n_i = jnp.abs(u_tilde - abs_term)
    Rh_i = _masked_max(jnp.abs(_patch_gather(mesh, Rh)), mask)
    tiny = jnp.asarray(1e-300 if n_i.dtype == jnp.float64 else 1e-30, n_i.dtype)
    R_i = Rh_i / jnp.maximum(n_i, tiny)
    beta = jnp.linalg.norm(w, axis=1)
    return jnp.minimum(Cvel * h * beta, Crv * h**2 * jnp.abs(R_i))


def rv_epsilon_linear_simple(Cvel, Crv, w, residual, u_n, h):
    """Globally normalized RV used for P2/P3 runs (ref RV.py:129-142):
    R <- R / ||u_n - mean||_inf, eps_i = min(Cvel h |w_i|, Crv h^2 |R_i|)."""
    norm = inf_norm_centered(u_n)
    r = residual / norm
    beta = jnp.linalg.norm(w, axis=1)
    return jnp.minimum(Cvel * h * beta, Crv * h**2 * jnp.abs(r))


def rv_epsilon_system(mesh: MeshArrays, Cvel, Crv, rho, beta, Rh, h):
    """RV for systems (Euler): same patch structure as rv_epsilon_nonlinear
    but the scalar field is the density and the wavespeed beta (|u|+c) is a
    precomputed nodal array (it is not a function of the scalar alone)."""
    mask = mesh.patch_mask
    abs_term = inf_norm_centered(rho)
    r_patch = _patch_gather(mesh, rho)
    u_tilde = _masked_max(r_patch, mask) - _masked_min(r_patch, mask)
    n_i = jnp.abs(u_tilde - abs_term)
    Rh_i = _masked_max(jnp.abs(_patch_gather(mesh, Rh)), mask)
    tiny = jnp.asarray(1e-300 if n_i.dtype == jnp.float64 else 1e-30, n_i.dtype)
    R_i = Rh_i / jnp.maximum(n_i, tiny)
    beta_i = _masked_max(_patch_gather(mesh, beta), mask)
    return jnp.minimum(Cvel * h * beta_i, Crv * h**2 * jnp.abs(R_i))


def rv_epsilon_cell(mesh: MeshArrays, Cvel, Crv, residual_node, beta_cell,
                    h_cell, scatter: str = "last"):
    """Cell-based RV (ref Code/Linear_advection/RV_cell.py:182-195):
    eps_k = min(Cvel h_k beta_k, Crv h_k^2 max_{a in cell} |R_a|), scattered
    to the cell's nodes.

    scatter="last" reproduces the reference exactly: the Python cell loop
    assigns eps_k to each dof, so the highest-indexed adjacent cell wins
    (ref RV_cell.py:193-195, plain assignment in loop order).
    scatter="max" takes the max over adjacent cells (slightly more
    diffusive at cell interfaces, order-independent).
    """
    import jax

    n = mesh.patch_cols.shape[0]
    R_cell = jnp.abs(residual_node[mesh.cells]).max(axis=1)       # (M,)
    eps_k = jnp.minimum(Cvel * h_cell * beta_cell, Crv * h_cell**2 * R_cell)
    flat_nodes = mesh.cells.reshape(-1)
    if scatter == "max":
        eps_rep = jnp.repeat(eps_k, 3)
        return jax.ops.segment_max(eps_rep, flat_nodes, num_segments=n)
    # last-cell-wins: find the max adjacent cell index per node, gather eps
    m_cells = mesh.cells.shape[0]
    cell_idx = jnp.repeat(jnp.arange(m_cells, dtype=jnp.int32), 3)
    last_cell = jax.ops.segment_max(cell_idx, flat_nodes, num_segments=n)
    return eps_k[last_cell]


# ---------------------------------------------------------------------------
# SI — smoothness indicator (ref Code/Utils/SI.py)
# ---------------------------------------------------------------------------


def sigmoid_activation(alpha, s=20.0, x0=0.5):
    """psi(alpha) = 1/(1+exp(-s(alpha-x0))) (ref SI.py:30-33)."""
    return 1.0 / (1.0 + jnp.exp(-s * (alpha - x0)))


class SIResult(NamedTuple):
    epsilon: object
    alpha: object
    psi: object


def si_alpha(mesh: MeshArrays, stiffness_ell, u, eps_floor=1e-8):
    """Oscillation detector alpha_i = |sum_j b_ij du_ij| / max(sum_j |b_ij||du_ij|, eps)
    over the node patch, du_ij = u_j - u_i (ref SI.py:50-61,170-187).
    Diagonal contributes du=0, so no explicit exclusion needed."""
    mask = mesh.patch_mask
    du = _patch_gather(mesh, u) - u[:, None]
    b = stiffness_ell
    num = jnp.abs(jnp.where(mask, b * du, 0.0).sum(axis=1))
    den = jnp.where(mask, jnp.abs(b) * jnp.abs(du), 0.0).sum(axis=1)
    den = jnp.maximum(den, eps_floor)
    return num / den


def si_epsilon(
    mesh: MeshArrays, Cm, stiffness_ell, u_n, beta, h, eps_floor=1e-8
) -> SIResult:
    """SI viscosity eps_i = psi(alpha_i) Cm h_i beta_i (ref SI.py:38-67).

    beta: (N,) wavespeed |f'(u_i)| — pass |w_i| for the linear variant
    (ref SI.py:147-192) or |f'(u_n_i)| for the nonlinear one.
    """
    alpha = si_alpha(mesh, stiffness_ell, u_n, eps_floor)
    psi = sigmoid_activation(alpha)
    return SIResult(psi * Cm * h * beta, alpha, psi)


# ---------------------------------------------------------------------------
# smoothing (ref Code/Utils/helpers.py:40-50)
# ---------------------------------------------------------------------------


def smooth_vector(mesh: MeshArrays, u, l: float):
    """Jacobi-like patch blending: u_i <- (sum_{j!=i} u_j + (l-1) d u_i)/(l d),
    d = patch size - 1. The reference updates in place sequentially
    (helpers.py:41-50); this is the simultaneous (Jacobi) version —
    documented deviation, equivalent smoothing strength and parallel-safe.
    """
    mask = mesh.patch_mask
    total = jnp.where(mask, _patch_gather(mesh, u), 0.0).sum(axis=1)
    neighbor_sum = total - u                      # remove self
    d = mask.sum(axis=1).astype(u.dtype) - 1.0
    d = jnp.maximum(d, 1.0)
    return (neighbor_sum + (l - 1.0) * d * u) / (l * d)
