"""What a measurement ran on: the JAX device, the card and the settings.

Every result the benchmark or the chip smoke test prints names its
device. A path that finds no GPU fails here; nothing falls back to the
CPU.
"""

from __future__ import annotations

import os
import subprocess

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


def nvidia_smi() -> str:
    """The card's name and power limit as nvidia-smi reports them (one
    line per card), read in a child process that never touches JAX."""
    try:
        r = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True, text=True,
                           timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    if r.returncode != 0:
        return f"nvidia-smi failed (rc={r.returncode}): {r.stderr.strip()}"
    return r.stdout.strip()


def require_gpu(devices) -> dict:
    """{platform, kind, count} of a device list whose first device is a
    GPU; raises RuntimeError for any other list (CPU, empty)."""
    devices = list(devices)
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "no device"
        raise RuntimeError(f"a GPU is required, JAX found {found!r}")
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices)}


def jax_settings() -> dict:
    """JAX version, XLA_FLAGS and the default matmul precision in force."""
    import jax

    return {"jax": jax.__version__,
            "xla_flags": os.environ.get("XLA_FLAGS", ""),
            "matmul_precision": str(jax.config.jax_default_matmul_precision)}
