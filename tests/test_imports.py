"""Importing the package's modules needs no optional dependency:
matplotlib is imported only when a plot is made."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# sys.modules[name] = None makes any later `import name` raise ImportError
BLOCK_MPL = "import sys; sys.modules['matplotlib'] = None; "


def _run(code):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-c", BLOCK_MPL + code], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("stmt", [
    "from conservation_fem_tpu.utils.riemann_exact import sod_exact",
    "import conservation_fem_tpu.utils as u; u.riemann_exact.sod_exact",
    "from conservation_fem_tpu.utils.baseline_proxy import make_kpp_proxy",
    "from conservation_fem_tpu.models import euler; euler.sod_density_error",
])
def test_module_imports_with_matplotlib_blocked(stmt):
    r = _run(stmt)
    assert r.returncode == 0, r.stderr[-2000:]


def test_plotting_needs_matplotlib_only_to_plot():
    r = _run("from conservation_fem_tpu.utils import plotting\n"
             "try:\n"
             "    plotting.plot_convergence([1.0, 0.5], [4, 8], 't', 'f', '.')\n"
             "except ImportError:\n"
             "    print('needs matplotlib')\n")
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "needs matplotlib"
