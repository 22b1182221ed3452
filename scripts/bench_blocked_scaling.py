"""Blocked unstructured KPP throughput vs mesh size (GPU).

Blocked evidence was once all at the reference mesh (N=4,886); this
measures whether the backend scales to the 5-50k window
its docstring claims (ops/blocked.py). Meshes: the stored reference gmsh
mesh plus deterministic jittered-Delaunay rectangles (ops/mesh.
irregular_mesh, seed=1) at N~20k, N~50k and N~100k — same irregular
valence and non-banded sparsity as gmsh output, reproducible so the
committed f64 anchors (scripts/make_anchor.py irr140 irr224 irr316) gate
the f32 runs.

Scaling expectation (written analysis): the window width is
W = nb + 2B with B the RCM half-bandwidth ~ sqrt(2N) — inherent for 2D
meshes — so one-hot bytes/DOF grow ~sqrt(N) (measured: Wpad 384/768/1024
at N 4.9k/19.9k/50.6k). Per-DOF throughput therefore falls ~1/sqrt(N)
once bandwidth-bound, while the gather-ELL path's per-DOF cost is
constant; where the two cross on the H100 is not measured. The
practical per-device ceiling is memory capacity, not plan-build time (one-hot
operators are materialized on device, blocked.build_onehot): at N~100k
the plan + CN operators total ~5 GB; N~200k would be ~15 GB, and past
one card's memory the sharded twin (parallel/blocked_sharded.py) takes
over by splitting band ranges across devices.

Usage: python scripts/bench_blocked_scaling.py   (on a GPU machine)
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

GATE = 2e-2     # L2rel vs the committed f64 anchor


def main():
    import jax.numpy as jnp
    from conservation_fem_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from make_anchor import IRR_FIXED, irr_problem

    from timeharness import measure_per_step

    from conservation_fem_tpu.models import kpp

    fixed = IRR_FIXED
    golden = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "golden")

    fails = []

    def gate(label, u, anchor_name):
        path = os.path.join(golden, anchor_name)
        if not os.path.exists(path):
            print(f"  {label}: NO ANCHOR ({anchor_name})", flush=True)
            return
        ref = np.load(path).astype(np.float64)
        rel = float(np.linalg.norm(u - ref) / np.linalg.norm(ref))
        ok = rel <= GATE
        print(f"  {label}: L2rel vs f64 anchor {rel:.3e} "
              f"{'OK' if ok else 'FAIL'}", flush=True)
        if not ok:
            fails.append(label)

    # reference gmsh mesh (the round-3 headline config)
    p = kpp.build(kpp.KPPConfig(mesh_source=kpp.KPP_REFERENCE_H5,
                                dtype="float32", backend="ell",
                                ell_matvec_backend="blocked", **fixed))
    per_step, _ = measure_per_step(p, verbose=True)
    n = int(p.u0.shape[0])
    print(f"refmesh  N={n:6d}  {per_step*1e6:8.1f} us/step  "
          f"{n/per_step/1e6:8.2f} M DOF-steps/s", flush=True)
    gate("refmesh", np.asarray(p.solve().u, np.float64),
         "kpp_rv_anchor_refmesh.npy")

    # blocked vs gather-ELL at each N: the written sqrt(N) analysis above
    # predicts the blocked one-hot bytes/DOF grow ~sqrt(2N) while the
    # gather path's stay constant — these rows measure where (whether)
    # the crossover happens inside the single-chip HBM envelope.
    # BENCH_GATHER=0 skips the gather rows (they share the same anchors).
    # All blocked rows run FIRST so that a failing comparison row cannot
    # cost the headline rows. BENCH_GATHER_MAX_NX caps the gather
    # comparison (default 140: one crossover point is enough).
    do_gather = os.environ.get("BENCH_GATHER", "1") != "0"
    gather_max = int(os.environ.get("BENCH_GATHER_MAX_NX", "140"))
    # blocked2d (ops/tiling): constant-width 3-run windows — the
    # large-N rows 448 (N~200k) / 640 (N~410k) are only reachable on
    # this backend (the 1D band's one-hots pass the HBM ceiling there);
    # the shared small rows measure the 1D-vs-2D crossover directly.
    # BENCH_2D_MAX_NX caps the large rows (e.g. 316 for a quick sweep).
    d2_max = int(os.environ.get("BENCH_2D_MAX_NX", "640"))
    runs = [(nx, "blocked") for nx in (140, 224, 316)]
    runs += [(nx, "blocked2d")
             for nx in (140, 224, 316, 448, 640) if nx <= d2_max]
    if do_gather:
        runs += [(nx, "gather") for nx in (140, 224, 316) if nx <= gather_max]
    only = os.environ.get("BENCH_2D_ONLY_NX")
    if only:
        runs = [(int(only), "blocked2d")]
    for nx, mv in runs:
        try:
            p = irr_problem(nx, "float32", ell_matvec_backend=mv,
                            **fixed)
            if nx >= 640:
                # time the single trajectory per call: a rep-chained
                # program at N~400k is long, and per-call constants are
                # negligible against a whole trajectory at this size
                import time as _t

                from timeharness import make_runner

                run1 = make_runner(p, 1)
                _ = float(jnp.sum(run1(p._jit_state(), p.u0)))  # compile
                t0 = _t.perf_counter()
                _ = float(jnp.sum(run1(p._jit_state(), p.u0)))
                per_step = (_t.perf_counter() - t0) / p.num_steps
            else:
                per_step, _ = measure_per_step(p, verbose=True)
        except Exception as e:
            # one row failing (e.g. HBM OOM at the largest N) must not
            # lose the rest of the sweep
            print(f"irr{nx}/{mv}: RUN FAIL {type(e).__name__}: "
                  f"{str(e)[:160]}", flush=True)
            fails.append(f"irr{nx}/{mv}:run")
            continue
        n = int(np.asarray(getattr(p, "slot_of_node", p.u0)).shape[0]) \
            if mv == "blocked2d" else int(p.u0.shape[0])
        print(f"irr{nx}/{mv:9s} N={n:6d}  {per_step*1e6:8.1f} us/step"
              f"  {n/per_step/1e6:8.2f} M DOF-steps/s", flush=True)
        u = np.asarray(p.solve().u, np.float64)
        if mv == "blocked2d":
            u = u[p.slot_of_node]
        gate(f"irr{nx}/{mv}", u, f"kpp_rv_anchor_irr{nx}.npy")

    if fails:
        print(f"SCALING BENCH ACCURACY FAIL: {fails}", flush=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
