"""Geometric multigrid for lattice-stencil operators.

Why: the IPCS solves' Krylov iteration counts grow with resolution —
kappa ~ 1/h^2 means kip = 3*nx pressure sweeps and ki ~ nx momentum
sweeps per step (models/stokes.auto_kip,
scripts/calibrate_stokes_ki.py). A Galerkin-coarsened V-cycle makes the counts
resolution-INDEPENDENT while keeping every op in the gather-free
lattice-stencil form of ops/lattice.py:

  * transfers: the 9-point tent (bilinear) stencil. Prolongation is an
    interior zero-pad (``lax.pad`` with interior=1 — a native XLA op)
    followed by the tent MAC; restriction is its transpose: the tent MAC
    followed by a stride-2 static slice. No gathers anywhere.
  * coarse operators: host-side Galerkin RAP (scipy sparse, once per
    build), re-laid-out as per-level coefficient planes — every level's
    matvec is the same shifted-MAC form as the fine-grid LatticeOp.
  * smoother: weighted Jacobi — elementwise, dot-free, symmetric.
  * coarsest level: a precomputed dense inverse applied as one small
    matmul.

Supports C-component block operators (the 2x2 IPCS momentum block with
its nonsymmetric boundary-edge coupling) and scalar ones (the pressure
Poisson). A V(nu,nu) cycle with equal pre/post smoothing counts is a
symmetric linear operator whenever A is symmetric, so ``preconditioner``
is a valid CG preconditioner for the pressure solve; the momentum solve
uses the same cycle inside BiCGStab. Dirichlet rows arrive already
pinned (unit diagonal, zero row/col) and coarsen correctly through RAP.

ref Code/Compressible_euler/stokes.py:104-125: the reference solves
these systems with PETSc defaults (GMRES/ILU-class); multigrid here is a
replacement for the resolution-scaling iteration counts, not a
port. Identity/convergence gates: tests/test_multigrid.py.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# tent = bilinear interpolation weights on the 3x3 neighborhood
_TENT = tuple(
    (di, dj, (1.0 if di == 0 else 0.5) * (1.0 if dj == 0 else 0.5))
    for di in (-1, 0, 1) for dj in (-1, 0, 1)
)


class MGStatic(NamedTuple):
    """Static (hashable) hierarchy metadata; pair with the array pytree
    from build_mg. Kept separate so the arrays can thread through jit as
    arguments (cf. models/stokes.step_buffers payload note)."""

    ncomp: int
    shapes: tuple          # per stencil level, fine first: (nI, nJ)
    offsets: tuple         # per level: C x C tuple of offset-tuples | None
    coarse_shape: tuple    # (nI, nJ) of the dense-solved coarsest grid
    nu: int                # pre == post smoothing steps (symmetry)
    omega: tuple           # per-level weighted-Jacobi damping (Gershgorin)


# ---------------------------------------------------------------------------
# host-side build (numpy / scipy, once per operator)
# ---------------------------------------------------------------------------


def _ell_to_csr(patch_cols, patch_mask, vals, perm):
    """(N, K) ELL -> scipy CSR in GRID ordering (row/col f <-> dof
    perm[f]); pad slots dropped via patch_mask."""
    import scipy.sparse as sps

    patch_cols = np.asarray(patch_cols)
    mask = np.asarray(patch_mask)
    vals = np.asarray(vals, np.float64)
    N, K = patch_cols.shape
    rows = np.repeat(np.arange(N), K).reshape(N, K)
    inv = np.empty(N, np.int64)
    inv[perm] = np.arange(N)                   # dof -> grid position
    A = sps.coo_matrix(
        (vals[mask], (inv[rows[mask]], inv[patch_cols[mask]])),
        shape=(N, N)).tocsr()
    A.sum_duplicates()
    return A


def _pin_bc(blocks, bc):
    """DOLFINx-style bc pinning on a C x C block CSR system: zero bc rows
    and columns in every block, unit diagonal on the diagonal blocks.
    Matches the masked matvec the solvers apply (models/stokes.A1g/A2g)."""
    import scipy.sparse as sps

    C = len(blocks)
    n = bc.size
    keep = sps.diags((~bc).astype(np.float64))
    eye_bc = sps.diags(bc.astype(np.float64))
    out = [[None] * C for _ in range(C)]
    for s in range(C):
        for d in range(C):
            if blocks[s][d] is None:
                continue
            B = keep @ blocks[s][d] @ keep
            if s == d:
                B = B + eye_bc
            out[s][d] = B.tocsr()
    return out


def _tent_P(nI, nJ):
    """Bilinear prolongation CSR: coarse ((nI+1)//2, (nJ+1)//2) -> fine
    (nI, nJ); coarse (i, j) sits at fine (2i, 2j). nI, nJ must be odd."""
    import scipy.sparse as sps

    mI, mJ = (nI + 1) // 2, (nJ + 1) // 2
    rows, cols, vals = [], [], []
    ic, jc = np.meshgrid(np.arange(mI), np.arange(mJ), indexing="ij")
    for di, dj, w in _TENT:
        fi = 2 * ic + di
        fj = 2 * jc + dj
        ok = (fi >= 0) & (fi < nI) & (fj >= 0) & (fj < nJ)
        rows.append((fi[ok] * nJ + fj[ok]).ravel())
        cols.append((ic[ok] * mJ + jc[ok]).ravel())
        vals.append(np.full(int(ok.sum()), w))
    return sps.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(nI * nJ, mI * mJ)).tocsr()


def _csr_to_planes(A, nI, nJ, dtype):
    """Grid-ordered CSR -> (offsets, planes) shifted-MAC form (the
    LatticeOp layout of ops/lattice.to_planes, from COO)."""
    from conservation_fem_tpu.ops import lattice as lat

    coo = A.tocoo()
    plan = lat.LatticePlan(nI=nI, nJ=nJ, idx=np.arange(nI * nJ),
                           dof_at=np.arange(nI * nJ), full=True)
    offsets, planes = lat.to_planes_coo(plan, plan, coo.row, coo.col,
                                        coo.data)
    return tuple(offsets), jnp.asarray(planes, dtype)


def build_mg(plan, patch_cols, patch_mask, blocks, bc_mask, *,
             dtype=jnp.float64, nu: int = 2, omega: float = 1.2,
             coarse_max: int = 700):
    """Build a V-cycle hierarchy for a C x C block ELL operator whose dofs
    live on a FULL lattice (ops/lattice.build_plan; plan.full required).

    blocks: C x C nested sequence of (N, K) ELL value arrays (None for a
    zero block); bc_mask: (N,) bool pinned rows (same for every
    component, like the Stokes wall mask). Coarsens while the grid stays
    odd-sized and larger than ``coarse_max`` points; the last grid gets a
    dense f64 inverse (stored at ``dtype``).

    Returns (MGStatic, arrays) — arrays is a jit-traceable pytree
    {"planes": [level][s][d], "dinv": [level], "cinv": dense}.
    """
    if not plan.full:
        raise NotImplementedError(
            "multigrid needs a full lattice (every grid point a dof); "
            "holes would need masked smoothing — not required by any "
            "current space (P1/Pk on rectangle meshes are full)")
    C = len(blocks)
    bc = np.asarray(bc_mask, bool)
    perm = np.asarray(plan.dof_at)             # grid position -> dof
    csr = [[None if blocks[s][d] is None else
            _ell_to_csr(patch_cols, patch_mask, blocks[s][d], perm)
            for d in range(C)] for s in range(C)]
    csr = _pin_bc(csr, bc[perm])

    nI, nJ = plan.nI, plan.nJ
    shapes, offsets, planes, dinv, omegas = [], [], [], [], []
    while (nI % 2 == 1 and nJ % 2 == 1 and nI >= 5 and nJ >= 5
           and C * nI * nJ > coarse_max):
        lev_off, lev_pl = [], []
        for s in range(C):
            ro, rp = [], []
            for d in range(C):
                if csr[s][d] is None:
                    ro.append(None)
                    rp.append(None)
                else:
                    o, p = _csr_to_planes(csr[s][d], nI, nJ, dtype)
                    ro.append(o)
                    rp.append(p)
            lev_off.append(tuple(ro))
            lev_pl.append(rp)
        diag = np.stack([csr[s][s].diagonal().reshape(nI, nJ)
                         for s in range(C)])
        # Gershgorin bound on lambda_max(D^-1 A) for the smoother damping:
        # omega_l = omega / g guarantees |1 - omega_l * lambda| < 1 for
        # every eigenvalue in (0, g] whenever omega < 2 (divergence
        # observed otherwise: the P2 consistent-mass block violates the
        # P1 Wathen bound lambda_max <= 2 that a flat omega assumes).
        di = np.where(diag != 0.0, 1.0 / diag, 1.0)
        g = 0.0
        for s in range(C):
            rs = np.zeros(nI * nJ)
            for d in range(C):
                if csr[s][d] is not None:
                    rs += np.abs(csr[s][d]).sum(axis=1).A1
            g = max(g, float((rs * di[s].reshape(-1)).max()))
        omegas.append(omega / max(g, 1e-30))
        shapes.append((nI, nJ))
        offsets.append(tuple(lev_off))
        planes.append(lev_pl)
        dinv.append(jnp.asarray(di, dtype))
        P = _tent_P(nI, nJ)
        csr = [[None if csr[s][d] is None else (P.T @ csr[s][d] @ P).tocsr()
                for d in range(C)] for s in range(C)]
        nI, nJ = (nI + 1) // 2, (nJ + 1) // 2

    n = nI * nJ
    # Guard the dense coarsest solve: tent coarsening needs ODD grid
    # sizes ((nI+1)//2 keeps 2^k*m+1 chains like 33->17->9->5 but stops
    # at e.g. 27->14), so a large even-sized top/stopped grid would
    # otherwise silently np.linalg.inv the WHOLE operator (nx=255
    # pressure: a 65536^2 inverse). Fail loudly instead of degenerating.
    dense_limit = max(4096, 4 * coarse_max)
    if C * n > dense_limit:
        raise ValueError(
            f"multigrid hierarchy stopped at a {nI}x{nJ} grid "
            f"(C*n = {C * n} > dense-solve limit {dense_limit}): grid "
            f"sizes must stay odd to coarsen (2^k*m+1 chains). For the "
            f"Stokes lattices use an even nx (pressure grid nx+1 odd, "
            f"velocity 2nx+1 odd), or raise coarse_max deliberately.")
    import scipy.sparse as sps

    dense = sps.bmat([[csr[s][d] if csr[s][d] is not None
                       else sps.csr_matrix((n, n))
                       for d in range(C)] for s in range(C)]).toarray()
    cinv = jnp.asarray(np.linalg.inv(dense), dtype)

    static = MGStatic(ncomp=C, shapes=tuple(shapes), offsets=tuple(offsets),
                      coarse_shape=(nI, nJ), nu=nu, omega=tuple(omegas))
    return static, {"planes": planes, "dinv": dinv, "cinv": cinv}


# ---------------------------------------------------------------------------
# device-side cycle (pure jnp; levels unrolled in Python — all static)
# ---------------------------------------------------------------------------


def _level_matvec(offsets, planes, x):
    """Block stencil matvec: x (C, nI, nJ) -> (C, nI, nJ)."""
    from conservation_fem_tpu.ops import lattice as lat

    C = x.shape[0]
    out = []
    for s in range(C):
        y = None
        for d in range(C):
            if offsets[s][d] is None:
                continue
            t = lat.matvec(offsets[s][d], planes[s][d], x[d])
            y = t if y is None else y + t
        out.append(y if y is not None else jnp.zeros_like(x[s]))
    return jnp.stack(out)


def _restrict(x):
    """(C, nI, nJ) -> (C, (nI+1)//2, (nJ+1)//2): tent MAC + stride-2
    slice (the transpose of _prolong; both are static-slice only)."""
    from conservation_fem_tpu.ops.lattice import _shift_read

    t = sum(jnp.asarray(w, x.dtype)
            * jnp.stack([_shift_read(x[c], di, dj)
                         for c in range(x.shape[0])])
            for di, dj, w in _TENT)
    return t[:, ::2, ::2]


def _prolong(xc, shape):
    """(C, mI, mJ) -> (C, nI, nJ) bilinear: interior zero-pad + tent."""
    from conservation_fem_tpu.ops.lattice import _shift_read

    nI, nJ = shape
    mI, mJ = xc.shape[1], xc.shape[2]
    zero = jnp.asarray(0.0, xc.dtype)
    e = jax.lax.pad(xc, zero, ((0, 0, 0),
                               (0, nI - (2 * mI - 1), 1),
                               (0, nJ - (2 * mJ - 1), 1)))
    return sum(jnp.asarray(w, xc.dtype)
               * jnp.stack([_shift_read(e[c], di, dj)
                            for c in range(xc.shape[0])])
               for di, dj, w in _TENT)


def _cycle(static: MGStatic, arrs, l, b2):
    """The V-cycle recursion from level ``l`` (levels unrolled in
    Python — all static)."""
    if l == len(static.shapes):
        C = static.ncomp
        nc = static.coarse_shape[0] * static.coarse_shape[1]
        e = arrs["cinv"] @ b2.reshape(C * nc)
        return e.reshape(C, *static.coarse_shape)
    off, pl = static.offsets[l], arrs["planes"][l]
    dinv = arrs["dinv"][l]
    om = jnp.asarray(static.omega[l], b2.dtype)
    A = lambda v: _level_matvec(off, pl, v)
    x = om * dinv * b2
    for _ in range(static.nu - 1):
        x = x + om * dinv * (b2 - A(x))
    e = _cycle(static, arrs, l + 1, _restrict(b2 - A(x)))
    x = x + _prolong(e, static.shapes[l])
    for _ in range(static.nu):
        x = x + om * dinv * (b2 - A(x))
    return x


def vcycle(static: MGStatic, arrs, b):
    """One V(nu,nu) cycle from a ZERO initial guess: b (C, nI, nJ) ->
    approximate A^-1 b. A linear, symmetric (for symmetric A) operator —
    usable directly as a Krylov preconditioner."""
    return _cycle(static, arrs, 0, b)


def coarse_correction(static: MGStatic, arrs, r_full):
    """The replicated TAIL of a row-sharded V-cycle: take the FULL
    fine-grid residual (already level-0 pre-smoothed by the sharded
    caller), restrict, run levels >= 1 as usual, and prolong the error
    back to the full fine grid. Pure function of replicated data — the
    sharded caller (parallel/stokes_sharded.py) all_gathers the residual
    (a few MB at most even at nx=512), slices its local rows from the
    result, and keeps the dominant level-0 smoothing distributed.
    ``arrs`` may carry None at level 0 (planes/dinv) — they are unused.
    Requires at least one stencil level (static.shapes non-empty); the
    dense-only degenerate is the caller's trivial gather+matmul case."""
    assert static.shapes, "coarse_correction needs a stencil level 0"
    e = _cycle(static, arrs, 1, _restrict(r_full))
    return _prolong(e, static.shapes[0])


def preconditioner(static: MGStatic, arrs):
    """Flat-vector V-cycle preconditioner for the grid-space Krylov
    drivers (models/stokes.py solves on (C*nI*nJ,) flats)."""
    C = static.ncomp
    if static.shapes:
        nI, nJ = static.shapes[0]
    else:                                  # degenerate: dense-only
        nI, nJ = static.coarse_shape
    return lambda r: vcycle(static, arrs, r.reshape(C, nI, nJ)).reshape(-1)
