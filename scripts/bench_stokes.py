"""GPU timing: Stokes IPCS step — gather-ELL vs lattice vs lattice+fixed.

Repeat-difference timing (see scripts/timeharness.py): per-step cost is
(t(R2) - t(R1)) / ((R2 - R1) * steps) over R chained repetitions of the
step scan inside one jit, so per-call constants cancel.

The fixed-iteration mode (krylov_iters) passes the operator buffers
through jit as ARGUMENTS (stokes.step_buffers) rather than embedding
them in the program.

Usage: python scripts/bench_stokes.py [nx ...]   (default 32 64)
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(prob_fd, num_steps, reps=(1, 3)):
    import jax
    import jax.numpy as jnp
    from conservation_fem_tpu.models.stokes import make_step, step_buffers

    p, fd = prob_fd
    aux, bufs = step_buffers(p, fd)

    def runner(R):
        @jax.jit
        def _run(bufs, u0, p0):
            step = make_step(p, fd, aux=aux, bufs=bufs)

            def rep(carry, _):
                (u, pn), _ = jax.lax.scan(step, carry, None,
                                          length=num_steps)
                return (u, pn), None

            (u, pn), _ = jax.lax.scan(rep, (u0, p0), None, length=R)
            return u, pn

        return _run

    times = {}
    u = None
    for R in reps:
        f = runner(R)
        u, pn = f(bufs, p.u0, p.p0)
        s = float(jnp.sum(u))                       # hard sync
        assert np.isfinite(s)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            u, pn = f(bufs, p.u0, p.p0)
            s = float(jnp.sum(u))
            best = min(best, time.perf_counter() - t0)
        times[R] = best
    per_step = (times[reps[1]] - times[reps[0]]) / (
        (reps[1] - reps[0]) * num_steps)
    return per_step, np.asarray(u)


def main():
    from conservation_fem_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from conservation_fem_tpu.models import stokes

    sizes = [int(s) for s in sys.argv[1:]] or [32, 64]
    steps = 10
    for nx in sizes:
        n2 = (2 * nx + 1) ** 2
        base = dict(nx=nx, num_steps=500, T=10.0, dtype="float32",
                    krylov_rtol=1e-6)
        t_e, u_e = run(stokes.build(**base), steps)
        print(f"nx {nx:4d} (N2={n2})  ell:     {t_e*1e3:8.2f} ms/step",
              flush=True)
        t_l, u_l = run(stokes.build(**base, backend="lattice"), steps)
        d = np.abs(u_l - u_e).max()
        print(f"nx {nx:4d} (N2={n2})  lattice: {t_l*1e3:8.2f} ms/step   "
              f"speedup {t_e/t_l:.2f}x   Linf vs ell {d:.2e}", flush=True)
        # nx-scaled fixed counts (models/stokes.auto_kip calibration:
        # ki ~ nx momentum/mass iters, kip = 3*nx pressure default)
        ki = max(25, nx)
        t_f, u_f = run(stokes.build(**base, backend="lattice",
                                    krylov_iters=ki), steps)
        d = np.abs(u_f - u_e).max()
        print(f"nx {nx:4d} (N2={n2})  lattice+fixed(ki={ki},kip={3*nx}): "
              f"{t_f*1e3:8.2f} ms/step   speedup {t_e/t_f:.2f}x   "
              f"Linf vs ell {d:.2e}", flush=True)
        # geometric multigrid (V(2,2) Galerkin) — iteration counts become
        # resolution-independent (MG-CG ~7 iters at any nx, auto_kip)
        t_m, u_m = run(stokes.build(**base, backend="lattice",
                                    multigrid=True), steps)
        d = np.abs(u_m - u_e).max()
        print(f"nx {nx:4d} (N2={n2})  lattice+MG adaptive: "
              f"{t_m*1e3:8.2f} ms/step   speedup {t_e/t_m:.2f}x   "
              f"Linf vs ell {d:.2e}", flush=True)
        t_mf, u_mf = run(stokes.build(**base, backend="lattice",
                                      multigrid=True, krylov_iters=6),
                         steps)
        d = np.abs(u_mf - u_e).max()
        print(f"nx {nx:4d} (N2={n2})  lattice+MG fixed(ki=6,kip=6): "
              f"{t_mf*1e3:8.2f} ms/step   speedup {t_e/t_mf:.2f}x   "
              f"Linf vs ell {d:.2e}", flush=True)
        # fully gather-free grid-space step (backend="grid": the SPMD
        # formulation on a 1-device mesh) — removes the solve-independent
        # gather-RHS floor
        t_g, u_g = run_grid(stokes.build(**base, backend="grid",
                                         multigrid=True, krylov_iters=6),
                            steps)
        d = np.abs(u_g - u_e).max()
        print(f"nx {nx:4d} (N2={n2})  grid+MG fixed(ki=6,kip=6): "
              f"{t_g*1e3:8.2f} ms/step   speedup {t_e/t_g:.2f}x   "
              f"Linf vs ell {d:.2e}", flush=True)


def run_grid(prob_fd, num_steps, reps=(1, 3)):
    """Amortized timing of the gather-free grid-space step (the
    ShardedStokes formulation on a 1-device mesh), mapped back to dof
    vectors for the Linf check (same mapping as ShardedStokes.solve)."""
    import jax
    import numpy as np

    from conservation_fem_tpu.parallel.stokes_sharded import ShardedStokes

    import time

    p, fd = prob_fd
    dmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("i",))
    sh = ShardedStokes(p, fd, dmesh)
    step = sh.make_step()
    u0, p0 = sh.init_state()

    times = {}
    u = None
    for R in reps:
        @jax.jit
        def _run(u0, p0):
            def rep(carry, _):
                def body(c, _):
                    return step(*c), None

                c, _ = jax.lax.scan(body, carry, None, length=num_steps)
                return c, None

            (uu, pn), _ = jax.lax.scan(rep, (u0, p0), None, length=R)
            return uu, pn

        u, pn = _run(u0, p0)
        s = float(np.asarray(u).sum())
        assert np.isfinite(s)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            u, pn = _run(u0, p0)
            s = float(np.asarray(u).sum())
            best = min(best, time.perf_counter() - t0)
        times[R] = best
    per_step = (times[reps[1]] - times[reps[0]]) / (
        (reps[1] - reps[0]) * num_steps)
    uh = np.asarray(u)[:, :sh.nI2]
    u_dof = np.stack([uh[s].reshape(-1)[np.asarray(sh.plan2.idx)]
                      for s in range(2)])
    return per_step, u_dof


if __name__ == "__main__":
    main()
