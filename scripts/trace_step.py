"""Trace the bench KPP RV solve on the GPU and reduce the trace.

Usage (on a GPU machine, from the checkout root):

    python scripts/trace_step.py [--out DIR] [mesh[:T] ...]   # default 64 512:0.1

For each mesh: bench.py's f32 config is built, compiled and warmed
through kpp.build(cfg).solve(); one untraced solve is timed with
block_until_ready; then one more solve runs under jax.profiler. From the
device plane of that trace it reports kernels per step, device busy time
per step and the idle share of the traced window (from the first kernel's
start to the last kernel's end). Prints one JSON line per mesh and keeps
the traces under DIR (default: traces/).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def kernel_events(xplane_path):
    """{line name: [(start_ns, end_ns, name), ...]} of the first GPU
    device plane; kernels are the events of its "Stream" lines."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane_path)
    planes = [pl for pl in pd.planes if pl.name.startswith("/device:GPU")]
    if not planes:
        raise RuntimeError(f"no GPU device plane in {xplane_path}: "
                           f"{[pl.name for pl in pd.planes]}")
    lines = {}
    for line in planes[0].lines:
        lines[line.name] = [(e.start_ns, e.start_ns + e.duration_ns, e.name)
                            for e in line.events]
    return lines


def reduce_trace(lines, steps):
    """Kernel count, busy time (union of kernel intervals) and idle share
    of the window spanned by the kernels."""
    kernels = [ev for name, evs in lines.items() if name.startswith("Stream")
               for ev in evs]
    if not kernels:
        raise RuntimeError(f"no kernel events on lines {sorted(lines)}")
    kernels.sort()
    busy, cur_s, cur_e = 0, kernels[0][0], kernels[0][1]
    for s, e, _ in kernels[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(e for _, e, _ in kernels) - kernels[0][0]
    return {"kernels_per_step": len(kernels) / steps,
            "device_busy_ms_per_step": busy / steps / 1e6,
            "traced_window_ms": window / 1e6,
            "idle_share": 1.0 - busy / window,
            "lines": {k: len(v) for k, v in sorted(lines.items())}}


def trace_mesh(mesh_size, T, out_dir):
    import jax

    import bench

    p = bench.build_problem(mesh_size, T)
    for _ in range(2):                       # compile + warm
        jax.block_until_ready(p.solve().u)
    t0 = time.perf_counter()
    jax.block_until_ready(p.solve().u)
    step_ms = (time.perf_counter() - t0) / p.num_steps * 1e3
    tdir = os.path.join(out_dir, f"mesh{mesh_size}")
    with jax.profiler.trace(tdir):
        jax.block_until_ready(p.solve().u)
    path = sorted(glob.glob(os.path.join(tdir, "plugins", "profile", "*",
                                         "*.xplane.pb")))[-1]
    out = {"mesh": mesh_size, "T": T, "n_dofs": int(p.u0.shape[0]),
           "steps": p.num_steps, "untraced_ms_per_step": step_ms,
           **reduce_trace(kernel_events(path), p.num_steps)}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "traces"))
    ap.add_argument("meshes", nargs="*", default=["64", "512:0.1"])
    args = ap.parse_args(argv)

    from conservation_fem_tpu.utils.compile_cache import enable_compile_cache
    from conservation_fem_tpu.utils.device_info import nvidia_smi, require_gpu

    enable_compile_cache()
    import jax

    print(f"nvidia-smi: {nvidia_smi()}; device {require_gpu(jax.devices())}",
          flush=True)
    for tok in args.meshes:
        mesh, _, T = tok.partition(":")
        trace_mesh(int(mesh), float(T or 1.0), args.out)


if __name__ == "__main__":
    main()
