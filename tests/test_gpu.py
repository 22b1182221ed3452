"""Tests that need an NVIDIA GPU (marker ``gpu``).

Elsewhere they skip; whether a GPU is present is decided in the fixture.
On a GPU machine (chip_smoke.py runs this first):

    CFT_TESTS_ON_GPU=1 python -m pytest tests/test_gpu.py -m gpu
"""

import jax
import numpy as np
import pytest

import bench
from conservation_fem_tpu.models import kpp


@pytest.fixture
def gpu():
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU: run with CFT_TESTS_ON_GPU=1 on a GPU "
                    "machine")
    return devs[0]


def _solve_on(device, build):
    with jax.default_device(device):
        p = build()
        u = p.solve().u
    assert list(u.devices()) == [device]
    return p, np.asarray(u, np.float64)


@pytest.mark.gpu
def test_structured_step_on_gpu_matches_cpu_f64(gpu):
    """bench.py's f32 structured step compiled for the card, mesh 16,
    20 steps, against the adaptive f64 run on the CPU: the bench gate."""
    _, u_gpu = _solve_on(gpu, lambda: bench.build_problem(16, 0.2))
    _, u_cpu = _solve_on(jax.devices("cpu")[0], lambda: kpp.build(
        kpp.KPPConfig(mesh_size=16, dtype="float64", T=0.2)))
    rel = np.linalg.norm(u_gpu - u_cpu) / np.linalg.norm(u_cpu)
    assert rel <= bench.ACCURACY_GATE, rel


@pytest.mark.gpu
def test_structured_step_keeps_f32_contractions_exact(gpu):
    """The quadrature einsums run at Precision.HIGHEST, so the card does
    not round them to TF32: one f32 step on the GPU and on the CPU give
    the same update to f32 roundoff. TF32 (10-bit mantissa) would put the
    two updates ~1e-3 apart."""
    build = lambda: bench.build_problem(16, 0.01)
    p, u_gpu = _solve_on(gpu, build)
    assert p.num_steps == 1
    _, u_cpu = _solve_on(jax.devices("cpu")[0], build)
    u0 = np.asarray(p.u0, np.float64)
    d_gpu, d_cpu = u_gpu - u0, u_cpu - u0
    rel = np.linalg.norm(d_gpu - d_cpu) / np.linalg.norm(d_cpu)
    assert rel <= 1e-4, rel
