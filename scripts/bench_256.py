"""Tune mesh-256 KPP configs; verify sanity of each."""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(p):
    import jax

    res = p.solve()
    jax.block_until_ready(res.u)
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        res = p.solve()
        jax.block_until_ready(res.u)
        best = min(best, time.perf_counter() - t0)
    return best / p.num_steps, np.asarray(res.u)


def main():
    from conservation_fem_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from conservation_fem_tpu.models import kpp

    ms = int(os.environ.get("MS", 256))
    n_dofs = (4 * ms + 1) ** 2

    def report(tag, t, u):
        ok = np.isfinite(u).all() and 0.5 < u.min() and u.max() < 12.0
        print(f"{tag}: {t*1e3:8.3f} ms/step = {n_dofs/t/1e6:8.1f} M "
              f"DOF-steps/s sane={ok} range=[{u.min():.3f},{u.max():.3f}]",
              flush=True)

    t, u = run(kpp.build(kpp.KPPConfig(
        mesh_size=ms, dtype="float32", krylov_rtol=1e-5,
        newton_linear_rtol=1e-3, modified_newton=False)))
    report("adaptive r1", t, u)

    for (cgi, ni, li) in [(10, 3, 14), (10, 3, 18), (12, 4, 14), (10, 2, 20)]:
        t, u = run(kpp.build(kpp.KPPConfig(
            mesh_size=ms, dtype="float32", modified_newton=False,
            cg_iters=cgi, newton_iters=ni, newton_linear_iters=li)))
        report(f"fixed cg={cgi} n={ni} l={li} exact", t, u)


if __name__ == "__main__":
    main()
