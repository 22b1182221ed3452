"""chip_smoke.py rehearsed on the CPU at tiny sizes: its device check,
each phase function, and that it refuses to run without a GPU or outside
a checkout. (On the GPU it runs the same functions at full size.)"""

import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import chip_smoke as cs
from conservation_fem_tpu.models import kpp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
from make_anchor import irr_problem  # noqa: E402

IRR = dict(dt=0.005, T=0.05)          # irr16 is not in make_anchor's table


@pytest.fixture(scope="module")
def irr16_anchor():
    """f64 gather-ELL run, the recipe of the committed irr anchors."""
    return np.asarray(irr_problem(16, "float64", krylov_rtol=1e-12,
                                  **IRR).solve().u)


def test_check_device_refuses_cpu():
    with pytest.raises(RuntimeError, match="GPU is required"):
        cs.check_device(jax.devices())


def test_check_device_refuses_empty_list():
    with pytest.raises(RuntimeError, match="no device"):
        cs.check_device([])


def test_check_device_accepts_gpu():
    gpu = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    assert cs.check_device([gpu]) == {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}


def test_main_path_phase_meets_gate():
    """Phases 2-3 at mesh 8: bench f32 config vs the make_anchor recipe
    (f64, adaptive 1e-12, same CFL-matched dt)."""
    ref = np.asarray(kpp.build(kpp.KPPConfig(
        mesh_size=8, dtype="float64", T=0.1, krylov_rtol=1e-12)).solve().u)
    assert cs.main_path(8, 0.1, ref) <= 1e-2


def test_main_path_phase_fails_on_wrong_reference():
    ref = np.asarray(kpp.build(kpp.KPPConfig(
        mesh_size=8, dtype="float64", T=0.1, krylov_rtol=1e-12)).solve().u)
    with pytest.raises(AssertionError, match="L2rel"):
        cs.main_path(8, 0.1, 1.1 * ref)


def test_unstructured_phase_meets_gate(irr16_anchor):
    assert cs.unstructured_path(16, irr16_anchor, **IRR) <= cs.IRR_GATE


# tiny arguments per workload; each case keeps its CLI_CASES keys
TINY_ARGS = {
    "kpp": ["--mesh_size", "4", "--T", "0.05"],
    "burgers": ["--mesh_size", "10", "--T", "0.05"],
    "euler": ["--problem", "sod", "--nx", "20"],
    "stokes": ["--num_steps", "20", "--T", "0.4"],
    "advection": ["--mesh_size", "8", "--T", "0.05"],
}


@pytest.mark.parametrize("case", cs.CLI_CASES, ids=lambda c: c[0][0])
def test_entry_point_phase(case):
    argv, checks = case
    # the bounds hold at the default sizes; at tiny sizes check that each
    # key is reported, finite where numeric, and that Newton converged
    tiny = tuple((k, "==", True) if isinstance(b, bool) else (k, "<", 1e3)
                 for k, _, b in checks)
    (out,) = cs.entry_points([([argv[0]] + TINY_ARGS[argv[0]], tiny)])
    assert out["workload"] == argv[0]


def test_four_gpu_phase_on_virtual_devices(irr16_anchor):
    """--four-gpus on 4 virtual CPU devices: sharded structured and
    blocked runs against their one-device twins."""
    cs.four_gpu_paths(jax.devices()[:4], mesh_size=16, T=0.05, irr_nx=16,
                      irr_ref=irr16_anchor, irr_dt=IRR["dt"],
                      irr_T=IRR["T"])


def test_gpu_test_phase_fails_when_the_gpu_tests_skip():
    """Without a GPU the gpu-marked tests skip, and a skip is no pass."""
    with pytest.raises(AssertionError, match="gpu tests failed"):
        cs.run_gpu_tests()


def test_refuses_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
