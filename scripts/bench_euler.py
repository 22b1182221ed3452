"""GPU timing: compressible Euler (4-component group FEM + density RV +
SSP-RK2) — Sod tube (the reference euler_RV.py config, nx=100) and the
2D Riemann config-3 four-shock problem at larger meshes.

Explicit scheme (lumped mass, no linear solves), so per-step cost is the
flux/RV kernel streams; on structured grids the stencil backend carries
every operator. Amortized chained-trajectory timing (cf. bench.py /
timeharness) with hard accuracy gates vs committed f64 CPU anchors
(scripts/make_anchor.py euler_sod:100 euler_2d:128 ... —
f32 tracks f64 at ~5e-7 on CPU for these explicit runs, so gates are
set 3-4 orders above that floor and still far below any lowering bug).

ref parity: Code/Compressible_euler/euler_RV.py (abandoned prototype in
the reference; complete here — see models/euler.py docstring).

Usage: python scripts/bench_euler.py [sod:100 riemann2d:128 ...]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

GATE = 1e-3


def main():
    from conservation_fem_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import time

    import jax
    import jax.numpy as jnp

    from conservation_fem_tpu.models import euler

    tokens = sys.argv[1:] or ["sod:100", "riemann2d:128", "riemann2d:256",
                              "riemann2d:512"]
    gdir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "golden")
    failures = []

    def bench(prob, nx):
        # shared anchor/bench config (riemann2d nx>=128 needs CRV=4 —
        # see make_anchor.euler_problem docstring)
        from make_anchor import euler_problem

        p = euler_problem(prob, nx, "float32")
        n = int(p.U0.shape[0])
        assert p.sd is not None, "bench expects the stencil backend"
        sd = p.sd

        # R CHAINED full trajectories in ONE jitted call (each starts
        # from the previous end state, so XLA cannot hoist the loop);
        # difference two R values to cancel the per-call constant.
        def runner(R):
            @jax.jit
            def _run(U0):
                U0g = jnp.moveaxis(U0.reshape(sd.nx + 1, sd.ny + 1, 4),
                                   -1, 0)

                def traj(c, _):
                    (U, _), _ = jax.lax.scan(
                        lambda cc, x: euler._step_structured(p, cc, x),
                        (c, c), None, length=p.num_steps)
                    return U, None

                Ug, _ = jax.lax.scan(traj, U0g, None, length=R)
                return jnp.moveaxis(Ug, 0, -1).reshape(-1, 4)
            return _run

        times = {}
        U1 = None
        for R in (1, 3):
            f = runner(R)
            U = f(p.U0)
            _ = float(jnp.sum(U))                # hard sync
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                U = f(p.U0)
                _ = float(jnp.sum(U))
                best = min(best, time.perf_counter() - t0)
            times[R] = best
            if R == 1:
                U1 = np.asarray(U, np.float64)
        per_step = (times[3] - times[1]) / (2 * p.num_steps)

        anchor = os.path.join(gdir, f"euler_{prob}_anchor_nx{nx}.npy")
        rel = None
        if os.path.exists(anchor):
            ref = np.load(anchor).astype(np.float64)
            rel = float(np.linalg.norm(U1 - ref) / np.linalg.norm(ref))
            if not (np.isfinite(rel) and rel < GATE):
                failures.append((prob, nx, rel))
        print(f"{prob:10s} nx={nx:4d} N={n:7d}  {per_step*1e6:9.1f} us/step"
              f"  {n/per_step/1e6:8.2f} M node-steps/s "
              f"({p.num_steps} steps/run)  "
              f"l2rel_vs_f64_anchor "
              f"{'%.3e' % rel if rel is not None else 'no anchor'}",
              flush=True)

    for tok in tokens:
        prob, nx = tok.split(":")
        bench(prob, int(nx))

    if failures:
        print(f"ACCURACY GATE FAILED: {failures}", flush=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
