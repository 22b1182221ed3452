"""Time the blocked unstructured KPP step on the reference gmsh mesh (GPU).

Repeat-difference timing (timeharness), and the matrix-free per-step
operators (blocked_matrix_free, ops/blocked.local_apply) vs the windowed
assembled path. Accuracy: fixed-iteration f32 vs an adaptive
tight-tolerance run.

Usage: python scripts/bench_blocked.py          (on a GPU machine)
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    from conservation_fem_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from timeharness import measure_per_step

    from conservation_fem_tpu.models import kpp

    common = dict(mesh_source=kpp.KPP_REFERENCE_H5, dtype="float32",
                  backend="ell", ell_matvec_backend="blocked")
    fixed = dict(modified_newton=True, cg_iters=10, newton_iters=3,
                 newton_linear_iters=8)

    def bench(label, **kw):
        p = kpp.build(kpp.KPPConfig(**{**common, **kw}))
        per_step, _ = measure_per_step(p, verbose=True)
        n = int(p.u0.shape[0])
        print(f"{label:42s} {per_step*1e6:8.1f} us/step  "
              f"{n/per_step/1e6:8.2f} M DOF-steps/s", flush=True)
        return p

    bench("blocked adaptive (assembled)",
          krylov_rtol=1e-5, newton_linear_rtol=1e-3, modified_newton=True,
          blocked_matrix_free=False)
    bench("blocked adaptive (matrix-free)",
          krylov_rtol=1e-5, newton_linear_rtol=1e-3, modified_newton=True)
    bench("blocked fixed (assembled)", blocked_matrix_free=False, **fixed)
    bench("blocked fixed n=2 (assembled)", blocked_matrix_free=False,
          **{**fixed, "newton_iters": 2})
    bench("blocked fixed n=2 trim (no final resid)",
          blocked_matrix_free=False,
          **{**fixed, "newton_iters": 2, "newton_final_residual": False})
    bench("blocked fixed n=2 trim cheby",
          blocked_matrix_free=False, inner_solver="cheby",
          **{**fixed, "newton_iters": 2, "newton_linear_iters": 8,
             "cg_iters": 5, "newton_final_residual": False})
    p_f = bench("blocked fixed (matrix-free)", **fixed)

    # accuracy: fixed matrix-free f32 vs adaptive tight f32 (same mesh)
    p_a = kpp.build(kpp.KPPConfig(
        krylov_rtol=1e-6, newton_linear_rtol=1e-4, **common))
    u_a = np.asarray(p_a.solve().u)
    u_f = np.asarray(p_f.solve().u)
    ok = np.isfinite(u_f).all() and 0.5 < u_f.min() and u_f.max() < 12.0
    print(f"fixed-vs-adaptive Linf: {np.abs(u_f - u_a).max():.3e}  "
          f"sane={ok}  (field range {u_a.min():.3f}..{u_a.max():.3f})",
          flush=True)

    # hard gate vs the committed f64 CPU anchor (cf. bench.py): a
    # lowering/scheme regression cannot ship a fast-but-wrong number
    ref = np.load(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "golden", "kpp_rv_anchor_refmesh.npy"))
    for label, u in (("adaptive", u_a), ("fixed", u_f)):
        rel = np.linalg.norm(u - ref) / np.linalg.norm(ref)
        print(f"L2rel vs f64 anchor ({label}): {rel:.3e}", flush=True)
        assert rel < 1e-2, (label, rel)


if __name__ == "__main__":
    main()
