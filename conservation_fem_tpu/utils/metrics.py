"""Per-step metrics, timers and profiling helpers.

Replaces the reference's tqdm bars + C++ tic/toc prints
(ref Code/KPP/KPP_exact.py:117-119, Burger_CPP/main.cpp:458-462) with
structured metrics (models already emit dicts from lax.scan when
record_metrics=True) and wall-clock utilities, plus a jax.profiler trace
context for device timeline capture.
"""

from __future__ import annotations

import contextlib
import json
import time

import numpy as np


class StepTimer:
    """Wall-clock timer with per-step throughput accounting."""

    def __init__(self, n_dofs: int):
        self.n_dofs = n_dofs
        self._t0 = None
        self.elapsed = 0.0
        self.steps = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed += time.perf_counter() - self._t0

    def count(self, steps: int):
        self.steps += steps

    @property
    def dof_steps_per_sec(self):
        return self.n_dofs * self.steps / max(self.elapsed, 1e-12)

    def summary(self):
        return {
            "steps": self.steps,
            "elapsed_s": round(self.elapsed, 4),
            "steps_per_sec": round(self.steps / max(self.elapsed, 1e-12), 2),
            "dof_steps_per_sec": round(self.dof_steps_per_sec, 1),
        }


@contextlib.contextmanager
def profile_trace(logdir="/tmp/cft_trace"):
    """jax.profiler trace context (view with tensorboard/xprof)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def metrics_to_json(metrics: dict) -> str:
    """Stacked scan metrics dict -> one JSON summary line."""
    out = {}
    for k, v in (metrics or {}).items():
        arr = np.asarray(v)
        if arr.dtype == bool:
            out[k] = {"all": bool(arr.all()), "frac": float(arr.mean())}
        else:
            out[k] = {
                "min": float(arr.min()), "max": float(arr.max()),
                "last": float(arr.reshape(-1)[-1]),
            }
    return json.dumps(out)
