"""Utilities. Submodules load on first access, so importing one of them
(e.g. ``riemann_exact``) does not import another's optional dependency
(matplotlib for ``plotting``, orbax for ``checkpoint``)."""

import importlib

_SUBMODULES = frozenset((
    "baseline_proxy", "checkpoint", "compile_cache", "convergence",
    "device_info", "guards", "interpolate", "io", "metrics", "plotting",
    "riemann_exact", "streaming", "sweeps",
))


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
