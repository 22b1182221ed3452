"""Per-step timing by differencing chained repetitions.

Runs R back-to-back full solves inside ONE jitted call (chained so XLA
cannot elide them), times two different R values with a hard host-pull
sync, and differences out every per-call constant:

    per_step = (t(R2) - t(R1)) / ((R2 - R1) * num_steps)

Usage: python scripts/timeharness.py [mesh ...]   (on a GPU machine)
"""

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_runner(p, reps):
    """R chained full trajectories in one jitted call."""

    @jax.jit
    def run(state, u0):
        with p.bound_jit_state(state):
            ts = (jnp.arange(p.num_steps, dtype=u0.dtype) + 1.0) * p.dt

            def rep(u, _):
                (uh, _, _), _ = jax.lax.scan(p.step, (u, u, u), ts)
                return uh, None

            u, _ = jax.lax.scan(rep, u0, None, length=reps)
        return u

    return run


def measure_per_step(p, r1=1, r2=4, trials=3, verbose=False):
    """Seconds per step on the device, per-call constants removed."""
    times = {}
    for reps in (r1, r2):
        run = make_runner(p, reps)
        t0 = time.perf_counter()
        _ = float(jnp.sum(run(p._jit_state(), p.u0)))    # compile + warm
        if verbose:
            print(f"  reps={reps}: compile+run {time.perf_counter()-t0:.1f}s",
                  file=sys.stderr, flush=True)
        best = float("inf")
        for _ in range(trials):
            t0 = time.perf_counter()
            s = float(jnp.sum(run(p._jit_state(), p.u0)))    # hard sync
            best = min(best, time.perf_counter() - t0)
        if not np.isfinite(s):
            raise RuntimeError("solve diverged in timing harness")
        times[reps] = best
    per_step = (times[r2] - times[r1]) / ((r2 - r1) * p.num_steps)
    return per_step, times


def main():
    from conservation_fem_tpu.models import kpp
    from conservation_fem_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    meshes = [int(a) for a in sys.argv[1:]] or [64, 128, 256]
    for ms in meshes:
        cfg = kpp.KPPConfig(
            mesh_size=ms, dtype="float32",
            dt=0.01 * min(1.0, 64.0 / ms),     # CFL-matched (see bench.py)
            modified_newton=True, cg_iters=10,
            newton_iters=2, newton_linear_iters=16,
            inner_solver="cheby")
        p = kpp.build(cfg)
        per_step, times = measure_per_step(p, verbose=True)
        n = int(p.u0.shape[0])
        print(f"mesh {ms}: {per_step*1e6:8.1f} us/step, "
              f"{n/per_step/1e6:10.1f} M DOF-steps/s  "
              f"(t1={times[1]*1e3:.1f}ms t4={times[4]*1e3:.1f}ms)",
              flush=True)


if __name__ == "__main__":
    main()
