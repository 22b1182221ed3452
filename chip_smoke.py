"""Chip smoke test: the KPP RV main path and the CLI entry points on a GPU.

Usage, from the root of a checkout on a machine with an NVIDIA GPU:

    python chip_smoke.py              # one GPU: phases 0-5 below
    python chip_smoke.py --four-gpus  # four GPUs: the sharded paths only

Phases of the one-GPU run, in order; any failure raises, and the process
exits nonzero without printing the result line:

  0. before JAX starts: the card's name and power limit (nvidia-smi), then
     the `gpu`-marked tests (tests/test_gpu.py) in a pytest subprocess,
     which has the card to itself and exits before this process opens it;
  1. device and settings: refuse anything but a GPU, print the versions,
     XLA_FLAGS, matmul precision and compile-cache directory;
  2. main path, mesh 64 (N = 66,049), T = 1.0, bench.py's f32 config,
     through kpp.build(cfg).solve(): L2rel vs golden/kpp_rv_anchor_mesh64
     <= bench.ACCURACY_GATE;
  3. the same at mesh 512 (N = 4,198,401), T = 0.1 (80 steps) vs
     golden/kpp_rv_anchor_mesh512_T0.1;
  4. unstructured KPP on irr140 (scripts/make_anchor.irr_problem), blocked
     backend, f32 fixed-iteration config: L2rel vs golden/kpp_rv_anchor_
     irr140 <= IRR_GATE;
  5. the CLI (conservation_fem_tpu.__main__.main) in-process for each
     workload in CLI_CASES, each reported error checked against the bound
     of its CPU test.

The last line of standard output is the result:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import operator
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "golden")

# L2rel gate vs the f64 irregular-mesh anchors (scripts/bench_blocked_scaling)
IRR_GATE = 2e-2

# Phase 5: (argv, ((JSON key, op, bound), ...)). Each bound is the one the
# CPU test of that workload asserts:
#   kpp       - converged Newton and u within the anchor sanity window
#               (0.5, 12) of scripts/make_anchor.py;
#   burgers   - L2 error < 0.15 (tests/test_burgers.py::test_rv_n50_error,
#               at mesh 50; the default mesh 200 is finer);
#   euler     - L1 density error < 0.035 (tests/test_euler.py::
#               test_sod_density_profile, the same nx = 100);
#   stokes    - L2 error vs Poiseuille < 1e-4 (tests/test_stokes.py::
#               test_poiseuille_converges_to_exact);
#   advection - L2 error < 5e-3 (tests/test_linear_advection.py::
#               test_convergence, gfem at mesh 32, the default).
CLI_CASES = (
    (["kpp", "--mesh_size", "32", "--dtype", "float32"],
     (("newton_all_converged", "==", True), ("u_min", ">", 0.5),
      ("u_max", "<", 12.0))),
    (["burgers"], (("L2_error_vs_exact", "<", 0.15),)),
    (["euler", "--problem", "sod"], (("L1_rho_error", "<", 0.035),)),
    (["stokes"], (("L2_error_vs_poiseuille", "<", 1e-4),)),
    (["advection"], (("L2_error_vs_ic", "<", 5e-3),)),
)
_OPS = {"<": operator.lt, ">": operator.gt, "==": operator.eq}

# --four-gpus tolerances (L2rel between the sharded and the one-card run).
# The two programs reduce in a different order, so their f32 trajectories
# part at roundoff and the shock dynamics amplify that; each run must
# also meet its anchor gate.
#   structured: a tenth of the anchor gate (4 virtual CPU devices, mesh 32,
#     10 steps: 5.4e-8);
#   blocked, with f64-accumulated dots (precise_reductions): its bf16
#     one-hot streams turn reduction-order differences into bf16 rounding
#     flips, so the runs part about as far as each sits from the f64
#     anchor (4 virtual CPU devices, irr60, 50 steps: 6.4e-4 apart, 8.7e-4
#     from the anchor); a quarter of the anchor gate.
SHARDED_VS_SINGLE = 1e-3
BLOCKED_VS_SINGLE = 5e-3


def log(msg):
    print(msg, flush=True)


def l2rel(u, ref):
    u = np.asarray(u, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(u - ref) / np.linalg.norm(ref))


def load_anchor(name):
    return np.load(os.path.join(GOLDEN, name)).astype(np.float64)


def gate(tag, u, ref, tol):
    """L2rel of u vs ref; raises unless finite and <= tol."""
    u = np.asarray(u)
    if not np.isfinite(u).all():
        raise AssertionError(f"{tag}: non-finite values")
    rel = l2rel(u, ref)
    log(f"{tag}: L2rel {rel:.4e} (gate {tol:g})")
    if not rel <= tol:
        raise AssertionError(f"{tag}: L2rel {rel:.4e} > {tol:g}")
    return rel


# -- phase 0 -----------------------------------------------------------------

def run_gpu_tests():
    """The gpu-marked tests, in a child that exits before this process
    touches the card. Fails unless at least one test ran and all passed."""
    env = dict(os.environ, CFT_TESTS_ON_GPU="1")
    cmd = [sys.executable, "-m", "pytest", "tests/test_gpu.py", "-m", "gpu",
           "-q", "-rA", "-p", "no:cacheprovider"]
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=900)
    tail = r.stdout.strip().splitlines()[-15:]
    log("gpu tests: " + " ".join(cmd[2:]))
    for line in tail:
        log(f"  | {line}")
    summary = tail[-1] if tail else ""
    if (r.returncode != 0 or not re.search(r"\d+ passed", summary)
            or re.search(r"skipped|failed|error", summary)):
        sys.stderr.write(r.stderr[-4000:])
        raise AssertionError(f"gpu tests failed (rc={r.returncode}): "
                             f"{summary!r}")


# -- phase 1 -----------------------------------------------------------------

def check_device(devices):
    """{platform, kind, count}; raises RuntimeError unless a GPU."""
    from conservation_fem_tpu.utils.device_info import require_gpu

    return require_gpu(devices)


def print_settings(cache_dir):
    from conservation_fem_tpu.utils.device_info import jax_settings

    import jax

    d = jax.devices()[0]
    s = jax_settings()
    log(f"jax {s['jax']}; device_kind {d.device_kind!r}; "
        f"count {len(jax.devices())}")
    log(f"XLA_FLAGS={s['xla_flags']!r}; jax_default_matmul_precision="
        f"{s['matmul_precision']}; x64={jax.config.jax_enable_x64}")
    log(f"compile cache: {cache_dir}")


# -- phases 2-3 --------------------------------------------------------------

def peak_bytes(device=None):
    import jax

    device = device or jax.devices()[0]
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def timed_solve(tag, p, timed_runs=2):
    """Solve through p.solve(): the first call compiles. Prints compile
    time, the steady per-step time and the step program's memory."""
    import jax

    t0 = time.perf_counter()
    u = np.asarray(p.solve().u)
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(timed_runs):
        t0 = time.perf_counter()
        jax.block_until_ready(p.solve().u)
        best = min(best, time.perf_counter() - t0)
    log(f"{tag}: N={p.u0.shape[0]} steps={p.num_steps} "
        f"compile+first {first:.2f}s; steady {best / p.num_steps * 1e3:.4f}"
        f" ms/step (best of {timed_runs} solves)")
    if p._solve_jit is not None:
        compiled = p._solve_jit.lower(p._jit_state(), p.u0).compile()
        log(f"{tag}: memory_analysis {compiled.memory_analysis()}")
    log(f"{tag}: peak_bytes_in_use so far {peak_bytes()}")
    return u


def main_path(mesh_size, T, reference, tol=None):
    import bench

    tol = bench.ACCURACY_GATE if tol is None else tol
    tag = f"main path mesh {mesh_size} T={T}"
    u = timed_solve(tag, bench.build_problem(mesh_size, T))
    return gate(tag, u, reference, tol)


# -- phase 4 -----------------------------------------------------------------

def irr_problem(nx, dtype="float32", **kw):
    scripts = os.path.join(ROOT, "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    from make_anchor import IRR_FIXED, irr_problem as build

    return build(nx, dtype, ell_matvec_backend="blocked",
                 **{**IRR_FIXED, **kw})


def unstructured_path(nx, reference, tol=IRR_GATE, **kw):
    tag = f"unstructured irr{nx} blocked"
    u = timed_solve(tag, irr_problem(nx, **kw))
    return gate(tag, u, reference, tol)


# -- phase 5 -----------------------------------------------------------------

def entry_points(cases=CLI_CASES):
    """Run the CLI in-process per case; check each reported error."""
    from conservation_fem_tpu.__main__ import main as cli

    results = []
    for argv, checks in cases:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli(list(argv))
        line = buf.getvalue().strip().splitlines()[-1]
        out = json.loads(line)
        log(f"cli {' '.join(argv)} -> {line}")
        if rc != 0:
            raise AssertionError(f"cli {argv}: rc={rc}")
        for key, op, bound in checks:
            if not _OPS[op](out[key], bound):
                raise AssertionError(f"cli {argv}: {key}={out[key]!r}, "
                                     f"bound {op} {bound!r}")
        results.append(out)
    return results


# -- --four-gpus -------------------------------------------------------------

def four_gpu_paths(devices, mesh_size=512, T=0.1, irr_nx=140,
                   structured_ref=None, irr_ref=None,
                   structured_tol=None, irr_tol=IRR_GATE,
                   irr_dt=None, irr_T=None):
    """ShardedStructuredKPP and DistributedBlocked over a 1-D mesh of
    `devices`, each against a one-device run of the same config in this
    process and against its f64 anchor (None skips the anchor gate).
    irr_dt/irr_T override the irregular mesh's table entry."""
    import jax

    import bench
    from conservation_fem_tpu.models import kpp
    from conservation_fem_tpu.parallel.blocked_sharded import (
        DistributedBlocked,
    )
    from conservation_fem_tpu.parallel.structured_sharded import (
        ShardedStructuredKPP,
    )

    structured_tol = (bench.ACCURACY_GATE if structured_tol is None
                      else structured_tol)
    dmesh = jax.sharding.Mesh(np.array(devices), ("i",))
    log(f"device mesh: {len(devices)} x {devices[0].device_kind}")

    # the sharded structured step runs the adaptive solvers, at an f32
    # tolerance (1e-5) since f32 cannot reach the default 1e-12
    cfg = kpp.KPPConfig(mesh_size=mesh_size, dtype="float32", T=T,
                        dt=0.01 * min(1.0, 64.0 / mesh_size),
                        krylov_rtol=1e-5)
    t0 = time.perf_counter()
    u_sh = np.asarray(ShardedStructuredKPP(kpp.build(cfg), dmesh).solve())
    log(f"sharded structured mesh {mesh_size}: {time.perf_counter() - t0:.1f}"
        f"s incl. compile")
    with jax.default_device(devices[0]):
        u_1 = np.asarray(kpp.build(cfg).solve().u)
    if structured_ref is not None:
        gate("sharded structured vs anchor", u_sh, structured_ref,
             structured_tol)
        gate("1-card structured vs anchor", u_1, structured_ref,
             structured_tol)
    gate("sharded vs 1-card structured", u_sh, u_1, SHARDED_VS_SINGLE)

    # f64-accumulated dots/means (precise_reductions) need x64
    jax.config.update("jax_enable_x64", True)
    irr_kw = dict(precise_reductions=True, dt=irr_dt, T=irr_T)
    p_sh = irr_problem(irr_nx, **irr_kw)
    t0 = time.perf_counter()
    u_bsh = np.asarray(DistributedBlocked(p_sh, dmesh).solve())
    log(f"sharded blocked irr{irr_nx}: {time.perf_counter() - t0:.1f}s "
        f"incl. compile")
    with jax.default_device(devices[0]):
        u_b1 = np.asarray(irr_problem(irr_nx, **irr_kw).solve().u)
    if irr_ref is not None:
        gate("sharded blocked vs anchor", u_bsh, irr_ref, irr_tol)
        gate("1-card blocked vs anchor", u_b1, irr_ref, irr_tol)
    gate("sharded vs 1-card blocked", u_bsh, u_b1, BLOCKED_VS_SINGLE)
    for d in devices:
        log(f"peak_bytes_in_use {d}: {peak_bytes(d)}")


# -- driver ------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the sharded paths over four GPUs")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "conservation_fem_tpu")):
        sys.exit(f"chip_smoke: no checkout around {ROOT}")
    sys.path.insert(0, ROOT)
    from conservation_fem_tpu.utils.compile_cache import enable_compile_cache
    from conservation_fem_tpu.utils.device_info import nvidia_smi

    log(f"nvidia-smi: {nvidia_smi()}")
    if not args.four_gpus:
        run_gpu_tests()

    cache_dir = enable_compile_cache()
    import jax

    device = check_device(jax.devices())
    print_settings(cache_dir)
    if args.four_gpus:
        if device["count"] < 4:
            raise RuntimeError(f"--four-gpus needs 4 GPUs, found "
                               f"{device['count']}")
        four_gpu_paths(jax.devices()[:4],
                       structured_ref=load_anchor(
                           "kpp_rv_anchor_mesh512_T0.1.npy"),
                       irr_ref=load_anchor("kpp_rv_anchor_irr140.npy"))
        device["count"] = 4
    else:
        main_path(64, 1.0, load_anchor("kpp_rv_anchor_mesh64.npy"))
        main_path(512, 0.1, load_anchor("kpp_rv_anchor_mesh512_T0.1.npy"))
        unstructured_path(140, load_anchor("kpp_rv_anchor_irr140.npy"))
        # the CLI defaults are float64; their CPU tests run with x64 on
        jax.config.update("jax_enable_x64", True)
        entry_points()
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
