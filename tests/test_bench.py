"""bench.py: one process that needs a GPU; its fixed-iteration config."""

import os
import subprocess
import sys

import bench
from conservation_fem_tpu.models import kpp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=os.path.join(ROOT, ".jax_cache"))
    r = subprocess.run([sys.executable, "bench.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""            # no metric, no JSON line
    assert "GPU is required" in r.stderr


def test_bench_config_is_the_fixed_iteration_main_path():
    c64 = bench._config(kpp, 64, "float32")
    assert (c64.cg_iters, c64.newton_iters, c64.newton_linear_iters) == \
        (6, 2, 4)
    assert c64.modified_newton and c64.inner_solver == "bicgstab"
    assert c64.dt == 0.01 and c64.solver_unroll
    c512 = bench._config(kpp, 512, "float32")
    assert c512.dt == 0.01 * 64 / 512          # CFL held at 0.64
    assert not c512.solver_unroll
