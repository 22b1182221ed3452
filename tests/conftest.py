"""Test configuration: CPU backend, 8 virtual devices, float64.

The backend is chosen via jax.config (backends initialize lazily, at the
first jax operation, which has not happened yet at conftest time). Tests
run on a virtual 8-device CPU mesh so multi-device sharding paths are
exercised without several GPUs (`__graft_entry__.dryrun_multichip` runs
the same paths outside pytest). x64 is enabled for the accuracy-gated
numerics (f64 is native on CPU).

With CFT_TESTS_ON_GPU=1 the CPU pin is left out, so JAX keeps its default
platforms (the GPU first, the CPU beside it). That is the command for the
`gpu`-marked tests on a GPU machine, which chip_smoke.py also runs:

    CFT_TESTS_ON_GPU=1 python -m pytest tests/test_gpu.py -m gpu
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

if os.environ.get("CFT_TESTS_ON_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
