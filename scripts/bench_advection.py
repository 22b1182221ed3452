"""GPU timing: linear advection RV-node on the reference gmsh disk mesh.

The reference's primary workload family (Code/Linear_advection) runs on
its stored gmsh disk mesh (1011 nodes). Amortized timing (timeharness);
gather vs blocked backends, adaptive vs fixed-iteration solvers.

Usage: python scripts/bench_advection.py [mesh_size ...] (default: the
reference Data mesh + a 4x-refined disk)
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REF_H5 = "/root/reference/Code/Linear_advection/Data/RV/RV_cell.h5"


def main():
    from conservation_fem_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import time

    import jax
    import jax.numpy as jnp

    from conservation_fem_tpu.models import linear_advection as la
    from conservation_fem_tpu.ops.mesh import load_h5_mesh

    host = load_h5_mesh(REF_H5, geometry="Mesh/mesh/geometry",
                        topology="Mesh/mesh/topology")
    print(f"reference disk mesh: {host.n_nodes} nodes", flush=True)

    # f64 adaptive gather anchor (scripts/make_anchor.py adv) in NATIVE
    # numbering; blocked solutions live in RCM order (u_native = u[perm])
    anchor_path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "golden", "adv_rvnode_anchor_refdisk.npy")
    anchor = np.load(anchor_path).astype(np.float64)
    from conservation_fem_tpu.ops.mesh import rcm_permutation
    rcm = rcm_permutation(host)
    failures = []

    def bench(label, host_mesh, tol, **kw):
        cfg = la.AdvectionConfig(T=1.0, stabilization="rv_node",
                                 dtype="float32", **kw)
        p = la.build(cfg, host_mesh=host_mesh)
        n = int(p.u0.shape[0])
        step = la._STEPS["rv_node"]

        # hard accuracy gate: the REAL solver trajectory (with the gfem
        # bootstrap step, unlike the chained timing runner below) vs the
        # committed f64 anchor. CPU-measured levels: adaptive 5e-6,
        # fixed-cheby 3e-4, bf16 streams 0.34 (the failure mode this
        # gate exists to catch — see blocked.make_blocked_plan)
        u = np.asarray(la.solve(p).u, dtype=np.float64)
        if kw.get("ell_matvec_backend") == "blocked":
            u = u[rcm]
        l2rel = float(np.linalg.norm(u - anchor) / np.linalg.norm(anchor))
        ok = np.isfinite(l2rel) and l2rel < tol
        if not ok:
            failures.append((label, l2rel, tol))
        print(f"{label:38s} l2rel_vs_f64_anchor {l2rel:.3e} "
              f"(tol {tol:g}) {'OK' if ok else 'FAIL'}", flush=True)

        # CHAINED steps: difference two scan lengths so per-call
        # constants cancel and XLA cannot hoist the loop body
        # (each step consumes the previous state — cf. timeharness)
        def runner(nsteps):
            @jax.jit
            def _run(p):
                from functools import partial as _pt
                (u, up), _ = jax.lax.scan(_pt(step, p), (p.u0, p.u0),
                                          None, length=nsteps)
                return u
            return _run

        n1, n2 = p.num_steps, 3 * p.num_steps
        times = {}
        for nsteps in (n1, n2):
            f = runner(nsteps)
            u = f(p)
            _ = float(jnp.sum(u))
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                u = f(p)
                _ = float(jnp.sum(u))
                best = min(best, time.perf_counter() - t0)
            times[nsteps] = best
        per_step = (times[n2] - times[n1]) / (n2 - n1)
        print(f"{label:38s} {per_step*1e6:9.1f} us/step  "
              f"{n/per_step/1e6:7.2f} M DOF-steps/s "
              f"({p.num_steps} steps/run)", flush=True)

    bench("gather adaptive (1e-5)", host, 5e-3, krylov_rtol=1e-5)
    bench("blocked adaptive (1e-5)", host, 5e-3, krylov_rtol=1e-5,
          ell_matvec_backend="blocked")
    bench("blocked fixed (cg10, bicg8)", host, 1e-2, cg_iters=10,
          krylov_iters=8, ell_matvec_backend="blocked")
    bench("blocked fixed cheby (cg8, cn12)", host, 1e-2, cg_iters=8,
          krylov_iters=12, inner_solver="cheby",
          ell_matvec_backend="blocked")
    # bf16-stream speed datapoint: quality cost documented (the loose
    # gate only catches blow-ups; see blocked_precise in AdvectionConfig)
    bench("blocked fixed cheby bf16 streams", host, 0.5, cg_iters=8,
          krylov_iters=12, inner_solver="cheby",
          ell_matvec_backend="blocked", blocked_precise=False)

    if failures:
        print(f"ACCURACY GATE FAILED: {failures}", flush=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
