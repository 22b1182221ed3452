"""CLI entry point: ``python -m conservation_fem_tpu <workload> [--key value ...]``.

Replaces the reference's "run each script with PYTHONPATH set" UX
(ref README.md:3); every workload family is addressable with config
overrides, e.g.::

    python -m conservation_fem_tpu kpp --mesh_size 16 --stabilization si
    python -m conservation_fem_tpu advection --stabilization rv_node
    python -m conservation_fem_tpu burgers --mesh_size 100
    python -m conservation_fem_tpu euler --problem sod --nx 200
    python -m conservation_fem_tpu stokes --num_steps 200
    python -m conservation_fem_tpu convergence --workload advection

Prints a one-line JSON result per run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time


def _apply_overrides(cfg_cls, args_list):
    """Parse --key value pairs against a dataclass config's fields."""
    fields = {f.name: f for f in dataclasses.fields(cfg_cls)}
    parser = argparse.ArgumentParser()
    for name, f in fields.items():
        ftype = f.type if callable(f.type) else str
        caster = {int: int, float: float, bool: lambda s: s in ("1", "true", "True"),
                  str: str}.get(
            {"int": int, "float": float, "bool": bool, "str": str,
             "float | None": float, "int | None": int}.get(str(f.type), str),
            str,
        )
        parser.add_argument(f"--{name}", type=caster, default=None)
    ns = parser.parse_args(args_list)
    overrides = {k: v for k, v in vars(ns).items() if v is not None}
    return cfg_cls(**overrides)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 1
    workload, rest = argv[0], argv[1:]
    t0 = time.perf_counter()

    if workload == "advection":
        from conservation_fem_tpu.models import linear_advection as la

        cfg = _apply_overrides(la.AdvectionConfig, rest)
        res = la.solve(la.build(cfg))
        out = {"workload": "advection", "stabilization": cfg.stabilization,
               "mesh_size": cfg.mesh_size, "num_steps": res.num_steps,
               "L2_error_vs_ic": float(res.error_l2)}
    elif workload == "advection_ho":
        from conservation_fem_tpu.models import advection_ho as ho

        cfg = _apply_overrides(ho.HOAdvectionConfig, rest)
        _, _, err = ho.run(cfg)
        out = {"workload": "advection_ho", "degree": cfg.degree,
               "stabilization": cfg.stabilization, "L2_error_vs_ic": err}
    elif workload == "kpp":
        from conservation_fem_tpu.models import kpp

        cfg = _apply_overrides(kpp.KPPConfig, rest)
        cfg = dataclasses.replace(cfg, record_metrics=True)
        res = kpp.run(cfg)
        import numpy as np

        out = {"workload": "kpp", "stabilization": cfg.stabilization,
               "mesh_size": cfg.mesh_size, "num_steps": res.num_steps,
               "u_min": float(np.asarray(res.u).min()),
               "u_max": float(np.asarray(res.u).max()),
               "newton_all_converged": bool(res.metrics["newton_converged"].all())}
    elif workload == "burgers":
        from conservation_fem_tpu.models import burgers

        cfg = _apply_overrides(burgers.BurgersConfig, rest)
        res, err = burgers.run(cfg)
        out = {"workload": "burgers", "stabilization": cfg.stabilization,
               "mesh_size": cfg.mesh_size, "num_steps": res.num_steps,
               "L2_error_vs_exact": err}
    elif workload == "euler":
        from conservation_fem_tpu.models import euler

        cfg = _apply_overrides(euler.EulerConfig, rest)
        p = euler.build(cfg)
        res = euler.solve(p)
        out = {"workload": "euler", "problem": cfg.problem, "nx": cfg.nx,
               "num_steps": res.num_steps}
        if cfg.problem == "sod":
            out["L1_rho_error"] = euler.sod_density_error(
                p, res.U, res.num_steps * res.dt)
    elif workload == "stokes":
        from conservation_fem_tpu.models import stokes

        cfg = _apply_overrides(stokes.StokesConfig, rest)
        res = stokes.solve(stokes.build(cfg))
        out = {"workload": "stokes", "num_steps": res.num_steps,
               "L2_error_vs_poiseuille": res.error_l2}
    elif workload == "convergence":
        from conservation_fem_tpu.models import linear_advection as la
        from conservation_fem_tpu.utils.convergence import run_convergence

        stab = "gfem"
        if "--stabilization" in rest:
            stab = rest[rest.index("--stabilization") + 1]
        res = run_convergence(
            lambda n: la.run(mesh_size=n, stabilization=stab).error_l2,
            (4, 8, 16, 32),
        )
        out = {"workload": "convergence", "stabilization": stab,
               "errors": [float(e) for e in res.errors],
               "slope": res.slope, "rates": res.rates().tolist()}
    else:
        print(f"unknown workload {workload!r}; see --help text in module doc")
        return 2

    out["wall_s"] = round(time.perf_counter() - t0, 2)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    from conservation_fem_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    sys.exit(main())
