"""Matrix-free Newton solver with jvp Jacobian action.

Replaces dolfinx NonlinearProblem + NewtonSolver
(ref Code/KPP/KPP_NodeRV.py:136-163, Code/Burgers_equation/
Exact_Burger_RV.py:192-221). Semantics matched:

  * convergence_criterion "residual" (dolfinx default, used for the
    stabilized CN solves): converged when ||F(u)|| <= rtol ||F(u0)|| + atol.
  * convergence_criterion "incremental" (used for the BDF2 residual
    projections): converged when ||du|| <= rtol ||du_0|| + atol.
  * the linear step J du = -F is solved with BiCGStab to a tolerance far
    tighter than Newton's (the reference uses exact LU).

The Jacobian action is jax.jvp of the residual — no assembled Jacobian, no
per-step re-JIT (the reference re-creates forms and LU factors every step,
ref KPP_NodeRV.py:136-145).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from conservation_fem_tpu.ops.krylov import (bicgstab, bicgstab_fixed,
                                             chebyshev_fixed)


class NewtonResult(NamedTuple):
    u: object
    iters: object
    converged: object       # metric <= tol OR stagnated at the dtype floor
    residual_norm: object


def newton_solve(
    residual_fn: Callable,
    u0,
    *,
    rtol=1e-4,
    atol=1e-10,
    max_it=100,
    criterion: str = "residual",
    linear_rtol=1e-12,
    linear_maxiter=2000,
    precond_fn: Callable | None = None,
    jacobian_fn: Callable | None = None,
    freeze_jacobian: bool = False,
    dot: Callable = jnp.vdot,
) -> NewtonResult:
    """Solve residual_fn(u) = 0.

    precond_fn: optional u -> (r -> z) preconditioner factory for the inner
    BiCGStab (e.g. inverse Jacobian diagonal).
    jacobian_fn: optional u -> (matvec, precond). When given, the Jacobian
    action uses this (e.g. an ELL matrix assembled once per Newton
    iteration — far cheaper per Krylov iteration than jvp re-quadrature);
    otherwise jax.jvp of the residual is used.
    freeze_jacobian: modified Newton — assemble the Jacobian once at u0 and
    reuse it every iteration. The residual-based stopping criterion is
    unchanged, so the converged solution satisfies the same tolerance;
    only the iterate path (and possibly the iteration count) differs.
    """
    norm = lambda v: jnp.sqrt(dot(v, v))

    F0 = residual_fn(u0)
    r0_norm = norm(F0)

    frozen = jacobian_fn(u0) if (jacobian_fn is not None and freeze_jacobian) else None

    def linear_solve(u, F):
        if frozen is not None:
            matvec, precond = frozen
        elif jacobian_fn is not None:
            matvec, precond = jacobian_fn(u)
        else:
            matvec = lambda v: jax.jvp(residual_fn, (u,), (v,))[1]
            precond = precond_fn(u) if precond_fn is not None else (lambda r: r)
        res = bicgstab(
            matvec, -F, precond=precond, rtol=linear_rtol, maxiter=linear_maxiter,
            dot=dot,
        )
        return res.x

    # first iteration done outside the loop to set the incremental reference
    du0 = linear_solve(u0, F0)
    u1 = u0 + du0
    du0_norm = norm(du0)
    F1 = residual_fn(u1)

    if criterion == "residual":
        ref = jnp.maximum(r0_norm, jnp.asarray(1e-300, u0.dtype))
        metric1 = norm(F1)
        tol = rtol * ref + atol
    elif criterion == "incremental":
        ref = jnp.maximum(du0_norm, jnp.asarray(1e-300, u0.dtype))
        metric1 = du0_norm  # checked after first update, as dolfinx does
        tol = rtol * ref + atol
    else:
        raise ValueError(f"unknown criterion {criterion!r}")

    # stagnation guard: in low precision (f32) the residual floors
    # above rtol*||F0||; once an iteration fails to shrink the metric by
    # 10%, further iterations are pure roundoff churn — stop. A stalled
    # solve only counts as converged if the metric actually reached the
    # machine-floor neighborhood (sqrt(rtol) relative) — a *growing*
    # metric (e.g. modified Newton diverging at large dt/h) must report
    # converged=False so callers/guards can catch it.
    stall_tol = jnp.sqrt(jnp.asarray(rtol, u0.dtype)) * (
        r0_norm if criterion == "residual" else du0_norm
    ) + atol

    def cond(state):
        u, F, metric, prev, k = state
        stalled = metric > 0.9 * prev
        return (metric > tol) & (k < max_it) & (~stalled)

    def body(state):
        u, F, metric, prev, k = state
        du = linear_solve(u, F)
        u = u + du
        F = residual_fn(u)
        new_metric = norm(F) if criterion == "residual" else norm(du)
        return u, F, new_metric, metric, k + 1

    big = jnp.asarray(jnp.inf, u0.dtype)
    u, F, metric, prev, k = jax.lax.while_loop(
        cond, body, (u1, F1, metric1, big, jnp.int32(1))
    )
    stalled_ok = (metric > 0.9 * prev) & (metric <= stall_tol)
    return NewtonResult(u, k, (metric <= tol) | stalled_ok, norm(F))


def newton_fixed(
    residual_fn: Callable,
    u0,
    *,
    iters: int,
    linear_iters: int,
    jacobian_fn: Callable,
    freeze_jacobian: bool = False,
    rtol=1e-4,
    atol=1e-10,
    dot: Callable = jnp.vdot,
    linear_solver: str = "bicgstab",
    cheby_bounds: tuple = (0.4, 2.2),
    final_residual: bool = True,
    unroll: bool = True,
) -> NewtonResult:
    """Newton with FIXED unrolled outer and inner iteration counts.

    Fixed-count counterpart of newton_solve for throughput paths: no
    lax.while_loop anywhere, so no iteration waits on a data-dependent
    exit test (see krylov.cg_fixed). The returned ``converged`` flag
    still reports whether the residual criterion was met, so callers'
    blow-up guards keep working; iteration counts must be validated against
    the adaptive solver for each workload (tests do this on CPU).

    linear_solver="cheby" swaps the inner BiCGStab for the dot-free
    Chebyshev semi-iteration (krylov.chebyshev_fixed) over cheby_bounds —
    one matvec and zero reductions per iteration vs BiCGStab's two and
    four, so callers typically double linear_iters for matvec parity.

    unroll=False switches the INNER solves to lax.fori_loop bodies
    (krylov._fixed_loop): same math, but the emitted program is
    linear_iters times smaller (bench.py uses it at mesh >= 256). The
    outer Newton loop stays a Python loop (iters is 2-3 everywhere).
    """
    norm = lambda v: jnp.sqrt(dot(v, v))
    F = residual_fn(u0)
    r0_norm = norm(F)
    frozen = jacobian_fn(u0) if freeze_jacobian else None
    u = u0
    for k in range(iters):
        matvec, precond = frozen if frozen is not None else jacobian_fn(u)
        if linear_solver == "cheby":
            du = chebyshev_fixed(matvec, -F, precond=precond,
                                 iters=linear_iters,
                                 lmin=cheby_bounds[0],
                                 lmax=cheby_bounds[1], unroll=unroll).x
        else:
            du = bicgstab_fixed(matvec, -F, precond=precond,
                                iters=linear_iters, dot=dot,
                                unroll=unroll).x
        u = u + du
        # final_residual=False: skip the residual at the LAST iterate —
        # it only feeds the converged flag (one whole quadrature pass per
        # step on throughput paths); the flag then reports the residual
        # BEFORE the last correction, still a valid stagnation signal.
        if k < iters - 1 or final_residual:
            F = residual_fn(u)
    rnorm = norm(F)
    return NewtonResult(u, jnp.int32(iters),
                        rnorm <= rtol * r0_norm + atol, rnorm)
