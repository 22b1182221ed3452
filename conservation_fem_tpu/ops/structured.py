"""Structured-grid (stencil) backend: gather-free FEM operators.

On structured rectangle triangulations (ops/mesh.rectangle_mesh with the
"right" diagonal — the meshes used by Burgers, Euler and the structured
KPP benchmark, ref Code/Burgers_equation/Exact_Burger_RV.py:28) every node
neighbor sits at a fixed (di, dj) grid offset. All sparse operators then
become 7-plane stencils and every gather/scatter becomes a statically
shifted slice — elementwise work that XLA fuses. Its speed against the
generic ELL gather path on the H100 is not measured.

Identities maintained (tested): every structured op here equals its
unstructured ELL counterpart to roundoff on the same mesh.

Node id = i * (ny+1) + j, i in [0,nx], j in [0,ny]; fields are handled as
2D (nx+1, ny+1) arrays internally.

Triangles per quad (i,j):
  L: (c00, c10, c11)   U: (c00, c11, c01)
with corner offsets L -> [(0,0),(1,0),(1,1)], U -> [(0,0),(1,1),(0,1)].
Neighbor offsets (self + 6): (0,0),(1,0),(-1,0),(0,1),(0,-1),(1,1),(-1,-1).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from conservation_fem_tpu.ops import stabilization as stab
import numpy as np
# geometry/quadrature contractions run at exact f32 (no TF32/bf16
# operand rounding) — see ops/precision.py
from conservation_fem_tpu.ops.precision import einsum_exact as _einsum


from conservation_fem_tpu.ops.assembly import _DUN4_W, _quad_basis
from conservation_fem_tpu.ops.mesh import Mesh

OFFSETS = ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (-1, -1))
_PLANE = {o: k for k, o in enumerate(OFFSETS)}
CORNERS = (((0, 0), (1, 0), (1, 1)), ((0, 0), (1, 1), (0, 1)))  # L, U


class StructuredData(NamedTuple):
    nx: int
    ny: int
    grads: object        # (2,3,2) per-type P1 gradients
    area: object         # scalar cell area
    bc2: object          # (nx+1, ny+1) boundary mask
    phi: object          # (Q,3) quad basis
    qw: object           # (Q,)
    M_coef: object       # (7, nx+1, ny+1) mass stencil
    h_cg2: object        # (nx+1, ny+1) nodal h (projected)
    diagM2: object       # (nx+1, ny+1) mass diagonal


def build_structured(host_mesh: Mesh, nx: int, ny: int, dtype):
    """Precompute stencil data for a rectangle_mesh(nx, ny, 'right')."""
    n1x, n1y = nx + 1, ny + 1
    assert host_mesh.n_nodes == n1x * n1y
    assert host_mesh.n_cells == 2 * nx * ny
    # exemplar geometry: cell 0 is the first lower triangle, cell nx*ny the
    # first upper one (rectangle_mesh concatenates lowers then uppers)
    grads = jnp.asarray(
        np.stack([host_mesh.grads[0], host_mesh.grads[nx * ny]]), dtype
    )
    area = jnp.asarray(host_mesh.area[0], dtype)
    bc2 = jnp.asarray(host_mesh.boundary_mask.reshape(n1x, n1y))
    phi = _quad_basis().astype(dtype)
    qw = (_DUN4_W * 0.5).astype(dtype)

    sd = StructuredData(
        nx=nx, ny=ny, grads=grads, area=area, bc2=bc2, phi=phi, qw=qw,
        M_coef=None, h_cg2=None, diagM2=None,
    )
    # mass stencil: local mass is type-independent. Built under jit so the
    # (2,nx,ny,3,3) broadcast fuses into the stencil-plane slices — eager,
    # it is materialized with its small trailing dims padded in device
    # layouts (2048^2 cells at mesh 512).
    mloc = area * (jnp.ones((3, 3), dtype) + jnp.eye(3, dtype=dtype)) / 12.0

    @jax.jit
    def _mass_stencil(mloc):
        return local_to_stencil(
            sd, jnp.broadcast_to(mloc, (2, nx, ny, 3, 3)))

    M_coef = _mass_stencil(mloc)
    sd = sd._replace(M_coef=M_coef, diagM2=M_coef[0])
    # nodal h: uniform mesh -> h_cg == h_cell everywhere (projection of a
    # constant is exact, ref helpers.py:29-36)
    h = jnp.full((n1x, n1y), jnp.asarray(host_mesh.h_cell[0], dtype))
    return sd._replace(h_cg2=h)


# ---------------------------------------------------------------------------
# core primitives
# ---------------------------------------------------------------------------


def matvec(sd: StructuredData, coef, x2):
    """y = A x for a 7-plane stencil operator (zero-padded boundary)."""
    n1x, n1y = sd.nx + 1, sd.ny + 1
    xp = jnp.pad(x2, 1)
    out = coef[0] * x2
    for k, (di, dj) in enumerate(OFFSETS[1:], start=1):
        out = out + coef[k] * jax.lax.dynamic_slice(
            xp, (1 + di, 1 + dj), (n1x, n1y)
        )
    return out


def cell_gather(sd: StructuredData, x2):
    """x at triangle corners: (2, nx, ny, 3) via static slices."""
    nx, ny = sd.nx, sd.ny
    out = []
    for t in range(2):
        cs = [x2[di:di + nx, dj:dj + ny] for (di, dj) in CORNERS[t]]
        out.append(jnp.stack(cs, axis=-1))
    return jnp.stack(out)


def node_scatter(sd: StructuredData, vals):
    """(2, nx, ny, 3) per-corner cell values -> (nx+1, ny+1) nodal sums."""
    nx, ny = sd.nx, sd.ny
    out = jnp.zeros((nx + 1, ny + 1), vals.dtype)
    for t in range(2):
        for a, (di, dj) in enumerate(CORNERS[t]):
            out = out.at[di:di + nx, dj:dj + ny].add(vals[t, :, :, a])
    return out


def local_to_stencil(sd: StructuredData, loc):
    """(2, nx, ny, 3, 3) local matrices -> (7, nx+1, ny+1) stencil planes."""
    nx, ny = sd.nx, sd.ny
    coef = jnp.zeros((len(OFFSETS), nx + 1, ny + 1), loc.dtype)
    for t in range(2):
        cs = CORNERS[t]
        for a in range(3):
            dai, daj = cs[a]
            for b in range(3):
                off = (cs[b][0] - dai, cs[b][1] - daj)
                p = _PLANE[off]
                coef = coef.at[p, dai:dai + nx, daj:daj + ny].add(
                    loc[t, :, :, a, b]
                )
    return coef


def sweep_form(coef, enable: bool):
    """bf16 HBM copy of solver-sweep operator planes (f32 inputs only).

    Structured twin of blocked.sweep_form: when `enable`, the 7-plane
    operator streamed by every Krylov/Chebyshev sweep iteration is stored
    as bfloat16, halving the dominant per-iteration HBM stream at
    mesh >= 256 (planes are 7x the field size). The matvec accumulates in
    f32 (bf16 * f32 promotes), and residual / quadrature passes keep the
    exact f32 operator, so only the linear-solve direction is perturbed
    (~1e-3 relative), not the Newton fixed point. No-op off f32 (f64
    accuracy-gated paths unchanged). XLA hoists the cast out of the scan,
    so exactly one bf16 copy lives in HBM.
    """
    if enable and coef.dtype == jnp.float32:
        return coef.astype(jnp.bfloat16)
    return coef


def constrained_matvec(sd: StructuredData, coef, x2):
    """Dirichlet-constrained stencil matvec (rows/cols zeroed, unit diag)."""
    x_in = jnp.where(sd.bc2, 0.0, x2)
    y = matvec(sd, coef, x_in)
    return jnp.where(sd.bc2, x2, y)


# ---------------------------------------------------------------------------
# FEM operators
# ---------------------------------------------------------------------------


def quad_values(sd: StructuredData, x2):
    """Field at quadrature points: (2, nx, ny, Q)."""
    u_cell = cell_gather(sd, x2)                      # (2,nx,ny,3)
    return _einsum("qa,txya->txyq", sd.phi, u_cell)


def cell_grad(sd: StructuredData, x2):
    """Constant per-cell gradient: (2, nx, ny, 2)."""
    u_cell = cell_gather(sd, x2)
    return _einsum("txya,tad->txyd", u_cell, sd.grads)


def _fp_comp(fprime, fprime_xy):
    """Componentwise flux derivative: the model's fprime_xy pair, else
    the two components sliced out of fprime."""
    if fprime_xy is not None:
        return fprime_xy
    return (lambda v: fprime(v)[..., 0]), (lambda v: fprime(v)[..., 1])


def nonlinear_rhs(sd: StructuredData, x2, fprime, fprime_xy=None):
    """N(u)_a = int (f'(u) . grad u) phi_a dx (cf. assembly.convection_rhs_flux).

    COMPONENTWISE quadrature: every intermediate is an (nx, ny) plane —
    the q/a/d dims are unrolled Python loops over scalar weights, so no
    (2,nx,ny,Q) / (...,2) intermediate with a small, padded trailing dim
    is materialized. Scalar-weighted plane MACs are also exact f32 (no
    dot, so no operand rounding) — at least as accurate as the
    einsum_exact forms.
    """
    fx, fy = _fp_comp(fprime, fprime_xy)
    nx, ny = sd.nx, sd.ny
    nq = sd.qw.shape[0]
    out = jnp.zeros((nx + 1, ny + 1), x2.dtype)
    two_area = 2.0 * sd.area
    for t in range(2):
        cs = CORNERS[t]
        c = [x2[di:di + nx, dj:dj + ny] for (di, dj) in cs]
        gux = sum(sd.grads[t, a, 0] * c[a] for a in range(3))
        guy = sum(sd.grads[t, a, 1] * c[a] for a in range(3))
        vals = [None, None, None]
        for q in range(nq):
            uq = sum(sd.phi[q, a] * c[a] for a in range(3))
            conv = fx(uq) * gux + fy(uq) * guy
            for a in range(3):
                w = two_area * sd.qw[q] * sd.phi[q, a]
                vals[a] = conv * w if vals[a] is None else vals[a] + conv * w
        for a, (di, dj) in enumerate(cs):
            out = out.at[di:di + nx, dj:dj + ny].add(vals[a])
    return out


def keps_coef(sd: StructuredData, eps2):
    """eps-weighted stiffness stencil (eps P1 -> exact mean rule).

    Componentwise planes (see nonlinear_rhs): gg entries are scalars per
    (t, a, b), so the local matrices never materialize as rank-5 arrays.
    """
    nx, ny = sd.nx, sd.ny
    coef = jnp.zeros((len(OFFSETS), nx + 1, ny + 1), eps2.dtype)
    for t in range(2):
        cs = CORNERS[t]
        ae = sd.area / 3.0 * sum(
            eps2[di:di + nx, dj:dj + ny] for (di, dj) in cs)
        for a in range(3):
            dai, daj = cs[a]
            for b in range(3):
                gg = (sd.grads[t, a, 0] * sd.grads[t, b, 0]
                      + sd.grads[t, a, 1] * sd.grads[t, b, 1])
                p = _PLANE[(cs[b][0] - dai, cs[b][1] - daj)]
                coef = coef.at[p, dai:dai + nx, daj:daj + ny].add(gg * ae)
    return coef


def flux_jacobian_coef(sd: StructuredData, x2, fprime, fprime_xy=None):
    """Stencil of d/du N(u) (cf. assembly.assemble_flux_jacobian).

    Componentwise quadrature planes (see nonlinear_rhs for the layout
    rationale); f'/f'' come from jax.jvp of the per-component fluxes.
    """
    fx, fy = _fp_comp(fprime, fprime_xy)
    nx, ny = sd.nx, sd.ny
    nq = sd.qw.shape[0]
    coef = jnp.zeros((len(OFFSETS), nx + 1, ny + 1), x2.dtype)
    two_area = 2.0 * sd.area
    for t in range(2):
        cs = CORNERS[t]
        c = [x2[di:di + nx, dj:dj + ny] for (di, dj) in cs]
        gux = sum(sd.grads[t, a, 0] * c[a] for a in range(3))
        guy = sum(sd.grads[t, a, 1] * c[a] for a in range(3))
        loc = [[None] * 3 for _ in range(3)]
        for q in range(nq):
            uq = sum(sd.phi[q, a] * c[a] for a in range(3))
            ones = jnp.ones_like(uq)
            fpx, fppx = jax.jvp(fx, (uq,), (ones,))
            fpy, fppy = jax.jvp(fy, (uq,), (ones,))
            t1 = fppx * gux + fppy * guy
            gb = [fpx * sd.grads[t, b, 0] + fpy * sd.grads[t, b, 1]
                  for b in range(3)]
            for a in range(3):
                wqa = sd.qw[q] * sd.phi[q, a]
                for b in range(3):
                    contrib = (two_area * wqa) * (
                        t1 * sd.phi[q, b] + gb[b])
                    loc[a][b] = (contrib if loc[a][b] is None
                                 else loc[a][b] + contrib)
        for a in range(3):
            dai, daj = cs[a]
            for b in range(3):
                p = _PLANE[(cs[b][0] - dai, cs[b][1] - daj)]
                coef = coef.at[p, dai:dai + nx, daj:daj + ny].add(loc[a][b])
    return coef


def mass_matvec(sd: StructuredData, x2):
    return matvec(sd, sd.M_coef, x2)


# ---------------------------------------------------------------------------
# RV epsilon on the grid (cf. stabilization.rv_epsilon_nonlinear)
# ---------------------------------------------------------------------------


def _patch_reduce(x2, reducer, pad_val):
    """Reduce over the 7-neighbor patch with boundary-safe padding."""
    xp = jnp.pad(x2, 1, constant_values=pad_val)
    n1x, n1y = x2.shape
    acc = x2
    for (di, dj) in OFFSETS[1:]:
        acc = reducer(acc, jax.lax.dynamic_slice(xp, (1 + di, 1 + dj), (n1x, n1y)))
    return acc


def directional_convection_coefs(sd: StructuredData):
    """Stencil forms of Cx, Cy with (Cd)_ab = (A/3) g_b[d] per cell
    (cf. assembly.assemble_directional_convection; group-FEM Euler)."""
    nx, ny = sd.nx, sd.ny
    coefs = []
    for d in range(2):
        loc_t = sd.area / 3.0 * sd.grads[:, :, d]          # (2,3): per type, b
        loc = jnp.broadcast_to(
            loc_t[:, None, None, None, :], (2, nx, ny, 3, 3)
        )
        coefs.append(local_to_stencil(sd, loc))
    return coefs[0], coefs[1]


def lumped_mass_grid(sd: StructuredData):
    """Row-sum lumped mass on the grid: M_coef applied to ones."""
    ones = jnp.ones((sd.nx + 1, sd.ny + 1), sd.M_coef.dtype)
    return matvec(sd, sd.M_coef, ones)


def stiffness_bc_coef(sd: StructuredData):
    """bc-applied stiffness as stencil planes: rows/cols at Dirichlet nodes
    zeroed, unit diagonal (cf. bc.ell_with_bc; the SI kernel reads these
    entries, ref Code/Linear_advection/smoothness.py:147-149)."""
    nx, ny = sd.nx, sd.ny
    gg = _einsum("tad,tbd->tab", sd.grads, sd.grads)
    loc = jnp.broadcast_to(
        (sd.area * gg)[:, None, None, :, :], (2, nx, ny, 3, 3)
    )
    K = local_to_stencil(sd, loc)
    bc = sd.bc2
    bcp = jnp.pad(bc, 1)
    n1x, n1y = nx + 1, ny + 1
    planes = []
    for k, (di, dj) in enumerate(OFFSETS):
        nbr_bc = jax.lax.dynamic_slice(bcp, (1 + di, 1 + dj), (n1x, n1y))
        v = jnp.where(bc | nbr_bc, 0.0, K[k])
        if k == 0:
            v = jnp.where(bc, 1.0, v)
        planes.append(v)
    return jnp.stack(planes)


def si_epsilon_grid(sd: StructuredData, Cm, K_bc_coef, u2, beta2,
                    eps_floor=1e-8):
    """Grid SI (cf. stabilization.si_epsilon, ref SI.py:38-67):
    alpha_i = |sum_k b_ik du_ik| / max(sum_k |b_ik||du_ik|, eps),
    eps_i = psi(alpha_i) Cm h_i beta_i."""
    n1x, n1y = u2.shape
    up = jnp.pad(u2, 1)
    num = jnp.zeros_like(u2)
    den = jnp.zeros_like(u2)
    for k, (di, dj) in enumerate(OFFSETS[1:], start=1):
        du = jax.lax.dynamic_slice(up, (1 + di, 1 + dj), (n1x, n1y)) - u2
        b = K_bc_coef[k]
        num = num + b * du
        den = den + jnp.abs(b) * jnp.abs(du)
    alpha = jnp.abs(num) / jnp.maximum(den, eps_floor)
    psi = stab.sigmoid_activation(alpha)
    return psi * Cm * sd.h_cg2 * beta2


def rv_epsilon_system_grid(sd: StructuredData, Cvel, Crv, rho2, Rh2, beta2):
    """Grid version of stabilization.rv_epsilon_system (Euler: density
    normalization, precomputed wavespeed field)."""
    abs_term = jnp.abs(rho2 - rho2.mean()).max()
    r_max = _patch_reduce(rho2, jnp.maximum, -jnp.inf)
    r_min = _patch_reduce(rho2, jnp.minimum, jnp.inf)
    n_i = jnp.abs((r_max - r_min) - abs_term)
    Rh_i = _patch_reduce(jnp.abs(Rh2), jnp.maximum, -jnp.inf)
    tiny = jnp.asarray(1e-300 if rho2.dtype == jnp.float64 else 1e-30, rho2.dtype)
    beta_i = _patch_reduce(beta2, jnp.maximum, -jnp.inf)
    return jnp.minimum(
        Cvel * sd.h_cg2 * beta_i,
        Crv * sd.h_cg2**2 * jnp.abs(Rh_i / jnp.maximum(n_i, tiny)),
    )


def smooth_vector_grid(sd: StructuredData, u2, l):
    """Grid version of stabilization.smooth_vector (ref helpers.py:40-50,
    Jacobi variant): u_i <- (sum_{j!=i} u_j + (l-1) d u_i) / (l d)."""
    n1x, n1y = u2.shape
    up = jnp.pad(u2, 1)
    onesp = jnp.pad(jnp.ones_like(u2), 1)
    nbr_sum = jnp.zeros_like(u2)
    d = jnp.zeros_like(u2)
    for (di, dj) in OFFSETS[1:]:
        nbr_sum = nbr_sum + jax.lax.dynamic_slice(up, (1 + di, 1 + dj), (n1x, n1y))
        d = d + jax.lax.dynamic_slice(onesp, (1 + di, 1 + dj), (n1x, n1y))
    d = jnp.maximum(d, 1.0)
    return (nbr_sum + (l - 1.0) * d * u2) / (l * d)


def rv_epsilon(sd: StructuredData, Cvel, Crv, u2, Rh2, fprime_norm):
    """Grid version of stabilization.rv_epsilon_nonlinear (ref RV.py:56-90)."""
    abs_term = jnp.abs(u2 - u2.mean()).max()
    u_max = _patch_reduce(u2, jnp.maximum, -jnp.inf)
    u_min = _patch_reduce(u2, jnp.minimum, jnp.inf)
    n_i = jnp.abs((u_max - u_min) - abs_term)
    Rh_i = _patch_reduce(jnp.abs(Rh2), jnp.maximum, -jnp.inf)
    tiny = jnp.asarray(1e-300 if u2.dtype == jnp.float64 else 1e-30, u2.dtype)
    R_i = Rh_i / jnp.maximum(n_i, tiny)
    beta = _patch_reduce(fprime_norm(u2), jnp.maximum, -jnp.inf)
    return jnp.minimum(Cvel * sd.h_cg2 * beta, Crv * sd.h_cg2**2 * jnp.abs(R_i))
