"""Structured (stencil) KPP bench sweep: fixed-iteration vs adaptive config.

Usage: python scripts/bench_structured.py [mesh_size ...]
"""

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
    for _ in range(3):
        t0 = time.perf_counter()
        res = p.solve()
        jax.block_until_ready(res.u)
        best = min(best, time.perf_counter() - t0)
    return best / p.num_steps, np.asarray(res.u)


def main():
    from conservation_fem_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from conservation_fem_tpu.models import kpp

    sizes = [int(s) for s in sys.argv[1:]] or [32, 64]

    for ms in sizes:
        n_dofs = (4 * ms + 1) ** 2

        # adaptive config, modified newton below 128
        cfg = kpp.KPPConfig(
            mesh_size=ms, dtype="float32", krylov_rtol=1e-5,
            newton_linear_rtol=1e-3, modified_newton=(ms <= 64))
        t, u = run(kpp.build(cfg))
        print(f"mesh {ms} (N={n_dofs}) adaptive: {t*1e3:8.3f} ms/step "
              f"= {n_dofs/t/1e6:8.1f} M DOF-steps/s", flush=True)

        for (cgi, ni, li, frz) in [(10, 3, 8, True), (10, 3, 10, False),
                                   (10, 2, 8, True)]:
            cfg = kpp.KPPConfig(
                mesh_size=ms, dtype="float32",
                modified_newton=frz, cg_iters=cgi, newton_iters=ni,
                newton_linear_iters=li)
            t, u = run(kpp.build(cfg))
            ok = np.isfinite(u).all() and 0.5 < u.min() and u.max() < 12.0
            print(f"mesh {ms} fixed cg={cgi} n={ni} l={li} frz={frz}: "
                  f"{t*1e3:8.3f} ms/step = {n_dofs/t/1e6:8.1f} M DOF-steps/s"
                  f" sane={ok}", flush=True)


if __name__ == "__main__":
    main()
