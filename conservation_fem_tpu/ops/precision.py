"""Exact-f32 einsum for geometry/quadrature contractions.

FEM assembly contractions have tiny contraction dims (space dim d=2,
local basis a/b <= 10, quadrature q <= 12), but XLA may still lower them
to matrix-unit dot_generals whose DEFAULT precision rounds f32 operands
(to TF32 on the H100). That rounding is a SYSTEMATIC perturbation of the
assembled operators, not noise, and it is shared by the gather and
blocked backends through the per-step ``assemble_eps_stiffness``
einsums. ``Precision.HIGHEST`` keeps these contractions exact f32; what
it costs on the H100 is not measured.

The blocked-window backend (ops/blocked.py and its sharded twins) is
deliberately NOT routed through this helper: its one-hot gather/scatter
contractions choose bf16 vs f32 per-plan (``plan_precision`` /
``precise``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def einsum_exact(*args, **kwargs):
    return jnp.einsum(*args, precision=jax.lax.Precision.HIGHEST, **kwargs)


# -- deterministic-enough f32 reductions -------------------------------------
# Sharded f32 trajectories diverge from the single-device run at ~1e-3
# over the KPP horizon (measured on virtual CPU devices): the psum'd dots / means reduce
# in a different order than the single-device reductions, the ~f32-eps
# difference seeds the shock dynamics, and chaos amplifies it ~4 orders.
# Accumulating BOTH sides' reductions in f64 (inputs stay f32) shrinks the
# seed to f64-summation-order eps and the trajectory gap to ~1e-9
# (asserted by __graft_entry__.dryrun_multichip path 10). Requires
# jax_enable_x64 (else astype(f64) silently stays f32 and these degrade
# to the plain reductions); the O(N) f64 reductions are small next to the
# O(N*window) matvecs.


def dot_acc64(a, b):
    """jnp.vdot with f64 accumulation, result cast back to input dtype."""
    if a.dtype == jnp.float64:
        return jnp.vdot(a, b)
    return jnp.vdot(a.astype(jnp.float64),
                    b.astype(jnp.float64)).astype(a.dtype)


def sum_acc64(x):
    """jnp.sum with f64 accumulation, cast back to input dtype."""
    if x.dtype == jnp.float64:
        return jnp.sum(x)
    return jnp.sum(x.astype(jnp.float64)).astype(x.dtype)


def pdot_acc64(axis):
    """Sharded twin of dot_acc64: f64 local partial + f64 psum."""
    def pdot(a, b):
        if a.dtype == jnp.float64:
            return jax.lax.psum(jnp.vdot(a, b), axis)
        p = jnp.vdot(a.astype(jnp.float64), b.astype(jnp.float64))
        return jax.lax.psum(p, axis).astype(a.dtype)

    return pdot


def psum_acc64(val, axis):
    """psum a scalar f32 partial with f64 carriage (partials are cast up,
    reduced in f64, cast back)."""
    if val.dtype == jnp.float64:
        return jax.lax.psum(val, axis)
    return jax.lax.psum(val.astype(jnp.float64), axis).astype(val.dtype)
