"""Matrix-free Krylov solvers: CG and BiCGStab with Jacobi preconditioning.

Replaces the reference's PETSc KSP direct-LU solves
(ref Code/Linear_advection/linear_advection.py:128-131 PREONLY+LU;
Code/Compressible_euler/stokes.py:107-125 BCGS+AMG/CG+SOR). There is
no distributed LU here; parity with the exact solves is achieved by running the
iterative solvers to tolerances far below the accuracy gate (<=1e-12 rel).

All solvers are pure jittable functions built on lax.while_loop with
reduction-based stopping criteria; dot products are plain jnp.vdot (replace
with psum-reductions in the sharded path, see parallel/dist_krylov.py).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class KrylovResult(NamedTuple):
    x: object
    iters: object        # int32
    residual: object     # final ||r||
    converged: object    # bool


def _identity(x):
    return x


def cg(
    matvec: Callable,
    b,
    x0=None,
    *,
    precond: Callable = _identity,
    rtol=1e-12,
    atol=0.0,
    maxiter=1000,
    dot: Callable = jnp.vdot,
) -> KrylovResult:
    """Preconditioned conjugate gradient for SPD operators."""
    x0 = jnp.zeros_like(b) if x0 is None else x0
    r0 = b - matvec(x0)
    z0 = precond(r0)
    bnorm = jnp.sqrt(dot(b, b))
    tol2 = jnp.maximum(rtol * bnorm, atol) ** 2

    def cond(state):
        x, r, z, p, rz, k = state
        return (dot(r, r) > tol2) & (k < maxiter)

    def body(state):
        x, r, z, p, rz, k = state
        Ap = matvec(p)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = dot(r, z)
        p = z + (rz_new / rz) * p
        return x, r, z, p, rz_new, k + 1

    init = (x0, r0, z0, z0, dot(r0, z0), jnp.int32(0))
    x, r, z, p, rz, k = jax.lax.while_loop(cond, body, init)
    rnorm = jnp.sqrt(dot(r, r))
    return KrylovResult(x, k, rnorm, rnorm <= jnp.sqrt(tol2))


def bicgstab(
    matvec: Callable,
    b,
    x0=None,
    *,
    precond: Callable = _identity,
    rtol=1e-12,
    atol=0.0,
    maxiter=2000,
    dot: Callable = jnp.vdot,
) -> KrylovResult:
    """Preconditioned BiCGStab for nonsymmetric operators (CN advection,
    Newton Jacobians)."""
    x0 = jnp.zeros_like(b) if x0 is None else x0
    r0 = b - matvec(x0)
    rhat = r0
    bnorm = jnp.sqrt(dot(b, b))
    tol = jnp.maximum(rtol * bnorm, atol)
    eps_break = jnp.asarray(1e-300, dtype=b.dtype) if b.dtype == jnp.float64 else jnp.asarray(1e-30, dtype=b.dtype)

    # state: x, r, p, v, rho, alpha, omega, k, breakdown
    def cond(state):
        x, r, p, v, rho, alpha, omega, k, brk = state
        return (jnp.sqrt(dot(r, r)) > tol) & (k < maxiter) & (~brk)

    def body(state):
        x, r, p, v, rho, alpha, omega, k, brk = state
        rho_new = dot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        phat = precond(p)
        v = matvec(phat)
        denom = dot(rhat, v)
        alpha = rho_new / denom
        s = r - alpha * v
        shat = precond(s)
        t = matvec(shat)
        tt = dot(t, t)
        omega = dot(t, s) / jnp.where(tt == 0, 1.0, tt)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        brk = (jnp.abs(rho_new) < eps_break) | (jnp.abs(denom) < eps_break) | (jnp.abs(omega) < eps_break)
        return x, r, p, v, rho_new, alpha, omega, k + 1, brk

    one = jnp.ones((), dtype=b.dtype)
    init = (x0, r0, jnp.zeros_like(b), jnp.zeros_like(b), one, one, one,
            jnp.int32(0), jnp.asarray(False))
    x, r, p, v, rho, alpha, omega, k, brk = jax.lax.while_loop(cond, body, init)
    rnorm = jnp.sqrt(dot(r, r))
    return KrylovResult(x, k, rnorm, rnorm <= tol)


def _fixed_loop(body, carry, iters, unroll):
    """Run ``body(i, carry) -> carry`` a static number of times.

    unroll=True emits straight-line XLA; unroll=False uses lax.fori_loop —
    same math, but the body is compiled ONCE, which keeps heavily-unrolled
    programs (e.g. Stokes krylov_iters=25 x 3 solves) small. Which form is
    faster on the H100 is not measured.
    """
    if unroll:
        for i in range(iters):
            carry = body(i, carry)
        return carry
    return jax.lax.fori_loop(0, iters, body, carry)


def cg_fixed(
    matvec: Callable,
    b,
    *,
    iters: int,
    precond: Callable = _identity,
    x0=None,
    dot: Callable = jnp.vdot,
    unroll: bool = True,
) -> KrylovResult:
    """CG with a FIXED iteration count (no adaptive stopping reduction).

    Use on throughput paths where the needed iteration count is known
    (validated against the adaptive solver); accuracy-gated f64 paths
    keep the adaptive `cg`. See _fixed_loop for unroll semantics.
    """
    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - matvec(x) if x0 is not None else b
    z = precond(r)
    p = z
    rz = dot(r, z)
    tiny = jnp.asarray(1e-300 if b.dtype == jnp.float64 else 1e-30, b.dtype)

    def body(_, c):
        x, r, p, rz = c
        Ap = matvec(p)
        pAp = dot(p, Ap)
        alpha = rz / jnp.where(jnp.abs(pAp) > 0, pAp, tiny)
        # freeze once converged (rz ~ 0): take a zero step
        alpha = jnp.where(rz > 0, alpha, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = dot(r, z)
        beta = rz_new / jnp.where(rz > 0, rz, tiny)
        return (x, r, z + beta * p, rz_new)

    x, r, p, rz = _fixed_loop(body, (x, r, p, rz), iters, unroll)
    rnorm = jnp.sqrt(dot(r, r))
    return KrylovResult(x, jnp.int32(iters), rnorm, jnp.asarray(True))


def bicgstab_fixed(
    matvec: Callable,
    b,
    *,
    iters: int,
    precond: Callable = _identity,
    x0=None,
    dot: Callable = jnp.vdot,
    unroll: bool = True,
) -> KrylovResult:
    """BiCGStab with a FIXED iteration count (see cg_fixed / _fixed_loop).

    Breakdown-safe: when a denominator underflows (exact convergence), the
    remaining iterations take zero-length steps instead of producing NaNs.
    """
    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - matvec(x) if x0 is not None else b
    rhat = r
    tiny = jnp.asarray(1e-300 if b.dtype == jnp.float64 else 1e-30, b.dtype)

    def safe_div(num, den):
        ok = jnp.abs(den) > tiny
        return jnp.where(ok, num / jnp.where(ok, den, 1.0), 0.0)

    def body(_, c):
        x, r, p, rho = c
        phat = precond(p)
        v = matvec(phat)
        alpha = safe_div(rho, dot(rhat, v))
        s = r - alpha * v
        shat = precond(s)
        t = matvec(shat)
        omega = safe_div(dot(t, s), dot(t, t))
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho_new = dot(rhat, r)
        beta = safe_div(rho_new, rho) * safe_div(alpha, omega)
        p = r + beta * (p - omega * v)
        return (x, r, p, rho_new)

    x, r, p, rho = _fixed_loop(body, (x, r, r, dot(rhat, r)), iters, unroll)
    rnorm = jnp.sqrt(dot(r, r))
    return KrylovResult(x, jnp.int32(iters), rnorm, jnp.asarray(True))


def chebyshev_fixed(
    matvec: Callable,
    b,
    *,
    iters: int,
    lmin: float,
    lmax: float,
    precond: Callable = _identity,
    x0=None,
    unroll: bool = True,
) -> KrylovResult:
    """Preconditioned Chebyshev semi-iteration — ZERO inner products.

    The fixed-iteration Krylov twins (cg_fixed / bicgstab_fixed) still
    serialize on 2-4 global dot-reductions per iteration (psum collectives
    when sharded). Chebyshev replaces the data-dependent step
    sizes with a precomputed three-term recurrence from eigenvalue bounds
    [lmin, lmax] of the preconditioned operator, so the whole solve is
    straight-line MACs with no reductions at all.

    Bounds: for a Jacobi-preconditioned P1 mass matrix lambda(D^-1 M) in
    [1/2, 2] on ANY triangulation (Wathen's bounds); rows pinned to
    identity contribute lambda = 1. Mildly nonsymmetric operators (the CN
    Newton Jacobian M + dt/2 (K_eps + C), convection-perturbed) converge
    for eigenvalues inside the ellipse around [lmin, lmax]; callers
    accuracy-gate per config (bench.py asserts vs the f64 anchor).

    Error after k steps <= 2 ((sqrt(kappa)-1)/(sqrt(kappa)+1))^k with
    kappa = lmax/lmin.
    """
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta
    f = lambda c: jnp.asarray(c, b.dtype)
    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - matvec(x) if x0 is not None else b
    d = precond(r) / f(theta)

    def body(_, c):
        x, r, d, rho = c
        x = x + d
        r = r - matvec(d)
        z = precond(r)
        rho_new = 1.0 / (f(2.0 * sigma1) - rho)
        d = rho_new * rho * d + rho_new * f(2.0 / delta) * z
        return (x, r, d, rho_new)

    x, r, d, rho = _fixed_loop(body, (x, r, d, f(1.0 / sigma1)), iters,
                               unroll)
    # One norm AFTER the sweep (not per-iteration, so the solve itself
    # stays dot-free) so rnorm/converged carry a real blow-up signal like
    # the other fixed solvers; XLA DCEs it when the caller drops rnorm.
    rnorm = jnp.linalg.norm(r)
    return KrylovResult(x, jnp.int32(iters), rnorm, jnp.isfinite(rnorm))


def jacobi_preconditioner(diag):
    """Inverse-diagonal preconditioner; safe where diag == 0."""
    inv = jnp.where(diag != 0, 1.0 / diag, 1.0)
    return lambda r: inv * r
