"""Blocked-window backend for Pk (degree 2-3) spaces.

The Pk gather-ELL pipeline pays per-step XLA gathers (u[cell_dofs]) and
segment_sum scatters (assembly) — the ops the blocked-window backend
removes (ops/blocked.py module docstring). This extends the blocked-window
machinery to any Lagrange degree: the structural plan builder
(blocked._plan_struct) is degree-agnostic (component-major one-hot
gather/scatter over RCM'd dof windows), and the quadrature kernels below
are componentwise twins of ops/assembly_pk.py (same tabulated basis, same
rule — identity to summation-order roundoff, tests/test_blocked_pk.py).

Requires an RCM dof ordering (ops/spaces.rcm_dof_permutation +
permute_dofs): the native vertex/edge/interior dof numbering has O(n)
bandwidth. The huge nd^2-wide assembly one-hots are never built — operator
assembly uses the factored Sv/Gcell contraction
(blocked.assemble_matrix_components).

ref parity: the same forms as Code/Burgers_equation/higher_order_SI.py
(P2 SI Burgers) and GFEM_pol.py degree sweeps, in blocked layout.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from conservation_fem_tpu.ops import blocked
from conservation_fem_tpu.ops.spaces import FunctionSpace


@dataclasses.dataclass(frozen=True, eq=False)
class BlockedPkPlan:
    """Blocked-window plan for a Pk space (cf. blocked.BlockedPlan).

    Geometry rides as per-quad-point component planes: detjq (blocks,Q,C),
    gxq/gyq (blocks,Q,nd,C) — physical basis gradients at quad points
    (isoparametric-aware, from SpaceArrays._geometry_q). phi/qw are static
    reference-basis tables (tuples, hashable for the pytree aux)."""

    n: int
    nb: int
    B: int
    blocks: int
    W: int
    Wpad: int
    C: int
    pad_hi: int
    nd: int
    Q: int
    phi: tuple      # ((Q) x (nd)) reference basis values
    qw: tuple       # (Q,) quadrature weights (sum 1/2)
    # f32 one-hots + Precision.HIGHEST contractions (blocked.plan_precision)
    precise: bool
    # device arrays
    Gcell: object
    Sv: object
    A_bool: object
    A_float: object
    bc_row: object
    bc_win: object
    diag_eye: object
    patch_deg: object
    detjq: object   # (blocks, Q, C)
    gxq: object     # (blocks, Q, nd, C)
    gyq: object     # (blocks, Q, nd, C)


_PK_ARRAY_FIELDS = ("Gcell", "Sv", "A_bool", "A_float", "bc_row", "bc_win",
                    "diag_eye", "patch_deg", "detjq", "gxq", "gyq")
_PK_STATIC_FIELDS = ("n", "nb", "B", "blocks", "W", "Wpad", "C", "pad_hi",
                     "nd", "Q", "phi", "qw", "precise")


def _pk_flatten(p):
    return (tuple(getattr(p, f) for f in _PK_ARRAY_FIELDS),
            tuple(getattr(p, f) for f in _PK_STATIC_FIELDS))


def _pk_unflatten(aux, children):
    return BlockedPkPlan(**dict(zip(_PK_STATIC_FIELDS, aux)),
                         **dict(zip(_PK_ARRAY_FIELDS, children)))


jax.tree_util.register_pytree_node(BlockedPkPlan, _pk_flatten, _pk_unflatten)


def make_blocked_pk_plan(space: FunctionSpace, nb: int = 128,
                         dtype=jnp.float32,
                         precise: bool = False) -> BlockedPkPlan:
    """Build the plan from an (RCM-permuted) FunctionSpace (host NumPy).

    precise: f32 one-hot storage + Precision.HIGHEST contractions, the
    quality mode for long smooth-transport horizons (see
    blocked.make_blocked_plan)."""
    st = blocked._plan_struct(
        space.ndof, np.asarray(space.cell_dofs, np.int64),
        space.patch_cols, space.patch_mask, space.boundary_mask, nb,
        build_rc=False)
    valid, safe_id = st["valid"], st["safe_id"]

    jinv_t_q, detj_q = space._geometry_q()          # (M,Q,2,2), (M,Q)
    g = np.einsum("mqde,qne->mqnd", jinv_t_q, space.dphi)   # (M,Q,nd,2)
    detjq = np.where(valid[:, :, None], detj_q[safe_id], 0.0)  # (b,C,Q)
    gq = np.where(valid[:, :, None, None, None], g[safe_id], 0.0)

    f = lambda x: jnp.asarray(x, dtype)
    precise = bool(precise) and jnp.dtype(dtype) == jnp.float32
    oh_dtype = (jnp.bfloat16 if jnp.dtype(dtype) == jnp.float32
                and not precise else jnp.float32)
    return BlockedPkPlan(
        n=st["n"], nb=nb, B=st["B"], blocks=st["blocks"], W=st["W"],
        Wpad=st["Wpad"], C=st["C"], pad_hi=st["pad_hi"], nd=st["nd"],
        precise=precise,
        Q=int(space.quad_w.shape[0]),
        phi=tuple(tuple(float(v) for v in row) for row in space.phi),
        qw=tuple(float(v) for v in space.quad_w),
        Gcell=blocked.build_onehot(st["Gcell"], oh_dtype),
        Sv=blocked.build_onehot(st["Sv"], oh_dtype),
        A_bool=jnp.asarray(st["A"]), A_float=f(st["A"]),
        bc_row=jnp.asarray(st["bc_row"]), bc_win=jnp.asarray(st["bc_win"]),
        diag_eye=f(st["diag_eye"]), patch_deg=f(st["patch_deg"]),
        detjq=f(detjq.transpose(0, 2, 1)),
        gxq=f(gq[..., 0].transpose(0, 2, 3, 1)),   # (b,C,Q,nd)->(b,Q,nd,C)
        gyq=f(gq[..., 1].transpose(0, 2, 3, 1)),
    )


# ---------------------------------------------------------------------------
# componentwise Pk quadrature kernels (twins of ops/assembly_pk.py)
# All loops over (q, a, b) are Python-unrolled; every operand is a clean
# (blocks, C) plane (see blocked.py on layout padding).
# ---------------------------------------------------------------------------


def _tabs(plan: BlockedPkPlan, dtype):
    phi = np.asarray(plan.phi, np.float64)
    qw = np.asarray(plan.qw, np.float64)
    f = lambda c: jnp.asarray(c, dtype)
    return phi, qw, f


def _cell_fields(plan: BlockedPkPlan, u, gather=None):
    """Gathered components + per-q values/gradients of a dof vector.

    gather: override for sharded callers (halo'd windows instead of the
    plan's global window extraction) — returns (blocks, nd, C)."""
    phi, qw, f = _tabs(plan, u.dtype)
    gather = gather or (lambda v: blocked.gather_components(plan, v))
    uc = gather(u)                                   # (blocks, nd, C)
    ua = [uc[:, a] for a in range(plan.nd)]
    u_q, gux_q, guy_q = [], [], []
    for q in range(plan.Q):
        u_q.append(sum(f(phi[q, a]) * ua[a] for a in range(plan.nd)))
        gux_q.append(sum(ua[a] * plan.gxq[:, q, a] for a in range(plan.nd)))
        guy_q.append(sum(ua[a] * plan.gyq[:, q, a] for a in range(plan.nd)))
    return ua, u_q, gux_q, guy_q


def pk_conv_plus_locals_rhs(plan: BlockedPkPlan, u, fpx, fpy, L=None,
                            gather=None, scatter=None):
    """(N(u) [+ A(L) u])_a -> (n,): the convection quadrature
    (assembly_pk.convection_rhs_flux) with an optional fused local-matrix
    action (cf. blocked.conv_plus_locals_rhs_components). gather/scatter:
    sharded overrides (see _cell_fields)."""
    phi, qw, f = _tabs(plan, u.dtype)
    nd = plan.nd
    scatter = scatter or (lambda v3: blocked.scatter_components(plan, v3))
    ua, u_q, gux_q, guy_q = _cell_fields(plan, u, gather)
    conv = [fpx(u_q[q]) * gux_q[q] + fpy(u_q[q]) * guy_q[q]
            for q in range(plan.Q)]
    v3 = []
    for a in range(nd):
        r = sum(f(qw[q] * phi[q, a]) * plan.detjq[:, q] * conv[q]
                for q in range(plan.Q))
        if L is not None:
            r = r + sum(L[:, nd * a + b] * ua[b] for b in range(nd))
        v3.append(r)
    return scatter(jnp.stack(v3, axis=1))


def pk_mass_locals(plan: BlockedPkPlan, dtype=jnp.float32):
    """Mass locals -> (blocks, nd^2, C) (assembly_pk.assemble_mass vals)."""
    phi, qw, f = _tabs(plan, dtype)
    nd = plan.nd
    rows = [sum(f(qw[q] * phi[q, a] * phi[q, b]) * plan.detjq[:, q]
                for q in range(plan.Q))
            for a in range(nd) for b in range(nd)]
    return jnp.stack(rows, axis=1).astype(dtype)


def pk_stiffness_locals(plan: BlockedPkPlan, dtype=jnp.float32):
    """Stiffness locals (assembly_pk.assemble_stiffness vals)."""
    phi, qw, f = _tabs(plan, dtype)
    nd = plan.nd
    rows = [sum(f(qw[q]) * plan.detjq[:, q]
                * (plan.gxq[:, q, a] * plan.gxq[:, q, b]
                   + plan.gyq[:, q, a] * plan.gyq[:, q, b])
                for q in range(plan.Q))
            for a in range(nd) for b in range(nd)]
    return jnp.stack(rows, axis=1).astype(dtype)


def pk_eps_locals(plan: BlockedPkPlan, eps, gather=None):
    """eps-weighted stiffness locals (assembly_pk.assemble_eps_stiffness)."""
    phi, qw, f = _tabs(plan, eps.dtype)
    nd = plan.nd
    gather = gather or (lambda v: blocked.gather_components(plan, v))
    ec = gather(eps)
    e_q = [sum(f(phi[q, c]) * ec[:, c] for c in range(nd))
           for q in range(plan.Q)]
    rows = [sum(f(qw[q]) * plan.detjq[:, q] * e_q[q]
                * (plan.gxq[:, q, a] * plan.gxq[:, q, b]
                   + plan.gyq[:, q, a] * plan.gyq[:, q, b])
                for q in range(plan.Q))
            for a in range(nd) for b in range(nd)]
    return jnp.stack(rows, axis=1)


def pk_flux_jacobian_locals(plan: BlockedPkPlan, u, fpx, fpy, gather=None):
    """Jacobian locals of the convection rhs
    (assembly_pk.assemble_flux_jacobian vals)."""
    phi, qw, f = _tabs(plan, u.dtype)
    nd = plan.nd
    ua, u_q, gux_q, guy_q = _cell_fields(plan, u, gather)
    fx_v, fx_d, fy_v, fy_d, t1 = [], [], [], [], []
    for q in range(plan.Q):
        one = jnp.ones_like(u_q[q])
        xv, xd = jax.jvp(fpx, (u_q[q],), (one,))
        yv, yd = jax.jvp(fpy, (u_q[q],), (one,))
        fx_v.append(xv)
        fy_v.append(yv)
        t1.append(xd * gux_q[q] + yd * guy_q[q])
    rows = []
    for a in range(nd):
        for b in range(nd):
            rows.append(sum(
                f(qw[q] * phi[q, a]) * plan.detjq[:, q]
                * (t1[q] * f(phi[q, b])
                   + fx_v[q] * plan.gxq[:, q, b]
                   + fy_v[q] * plan.gyq[:, q, b])
                for q in range(plan.Q)))
    return jnp.stack(rows, axis=1)



def pk_convection_locals(plan: BlockedPkPlan, w, gather=None):
    """Convection locals with a Pk vector field w (ndof, 2) ->
    (blocks, nd^2, C) (assembly_pk.assemble_convection vals:
    C_ab = int phi_a (w . grad phi_b) dx, w_q interpolated per quad
    point)."""
    phi, qw, f = _tabs(plan, w.dtype)
    nd = plan.nd
    gather = gather or (lambda v: blocked.gather_components(plan, v))
    wxc, wyc = gather(w[:, 0]), gather(w[:, 1])      # (blocks, nd, C)
    wx_q = [sum(f(phi[q, c]) * wxc[:, c] for c in range(nd))
            for q in range(plan.Q)]
    wy_q = [sum(f(phi[q, c]) * wyc[:, c] for c in range(nd))
            for q in range(plan.Q)]
    rows = []
    for a in range(nd):
        for b in range(nd):
            rows.append(sum(
                f(qw[q] * phi[q, a]) * plan.detjq[:, q]
                * (wx_q[q] * plan.gxq[:, q, b]
                   + wy_q[q] * plan.gyq[:, q, b])
                for q in range(plan.Q)))
    return jnp.stack(rows, axis=1)
