"""GPU timing: P2 SI Burgers (higher_order_SI.py workload), lattice backend.

Repeat-difference timing (timeharness) + fixed-iteration solvers with per-degree Chebyshev
bounds (BurgersConfig.inner_solver='cheby', committed spectra)
vs the adaptive anchor.

Usage: python scripts/bench_pk.py [mesh ...]   (default 32 64)
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

    from conservation_fem_tpu.models import burgers

    meshes = [int(a) for a in sys.argv[1:]] or [32, 64]
    for ms in meshes:
        common = dict(mesh_size=ms, degree=2, stabilization="si",
                      T=0.25, dtype="float32",
                      ell_matvec_backend="lattice")

        def bench(label, **kw):
            p = burgers.build(burgers.BurgersConfig(**{**common, **kw}))
            per_step, _ = measure_per_step(p, verbose=True)
            n = int(p.u0.shape[0])
            print(f"mesh {ms} {label:34s} {per_step*1e6:9.1f} us/step  "
                  f"{n/per_step/1e6:8.2f} M DOF-steps/s", flush=True)
            return p

        p_ad = bench("lattice adaptive", krylov_rtol=1e-5,
                     newton_linear_rtol=1e-3, modified_newton=True)
        p_fx = bench("lattice fixed-cheby", modified_newton=True,
                     cg_iters=12, newton_iters=2, newton_linear_iters=10,
                     inner_solver="cheby")
        bench("blocked adaptive", krylov_rtol=1e-5,
              newton_linear_rtol=1e-3, modified_newton=True,
              ell_matvec_backend="blocked")
        p_bf = bench("blocked fixed-cheby", modified_newton=True,
                     cg_iters=12, newton_iters=2, newton_linear_iters=10,
                     inner_solver="cheby", newton_final_residual=False,
                     ell_matvec_backend="blocked")
        u_a = np.asarray(p_ad.solve().u)
        u_f = np.asarray(p_fx.solve().u)
        u_b = np.asarray(p_bf.solve().u)[p_bf.dof_perm]  # -> native order
        print(f"mesh {ms} fixed-vs-adaptive Linf: "
              f"{np.abs(u_f - u_a).max():.3e}  blocked-vs-adaptive: "
              f"{np.abs(u_b - u_a).max():.3e}  "
              f"(range {u_a.min():.3f}..{u_a.max():.3f})", flush=True)
        if ms == 32:
            # hard gate vs the committed f64 CPU anchor (pointwise Linf
            # at the shock is O(1) for ANY f32 perturbation; L2rel is
            # the meaningful measure)
            ref = np.load(os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                "golden", "burgers_p2si_anchor_mesh32.npy"))
            for label, u in (("lattice adaptive", u_a),
                             ("lattice fixed", u_f), ("blocked", u_b)):
                rel = np.linalg.norm(u - ref) / np.linalg.norm(ref)
                print(f"mesh 32 L2rel vs f64 anchor ({label}): {rel:.3e}",
                      flush=True)
                assert rel < 5e-2, (label, rel)


if __name__ == "__main__":
    main()
