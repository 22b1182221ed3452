"""scripts/trace_step.py's reduction from device-trace events to metrics,
checked on hand-made events (the chip run feeds it a real trace)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
from trace_step import reduce_trace  # noqa: E402


def test_busy_time_is_the_union_of_kernel_intervals():
    lines = {
        "Stream #13(Compute)": [(0, 10, "a"), (5, 20, "b"), (30, 40, "c")],
        "Stream #14(MemcpyD2D)": [(35, 50, "copy")],
        "XLA Ops": [(0, 50, "op")],          # derived line: not kernels
    }
    out = reduce_trace(lines, steps=2)
    assert out["kernels_per_step"] == 2.0      # 4 kernels over 2 steps
    # union: [0,20) + [30,50) = 40 ns busy in a 50 ns window
    assert out["device_busy_ms_per_step"] == pytest.approx(40 / 2 / 1e6)
    assert out["traced_window_ms"] == pytest.approx(50 / 1e6)
    assert out["idle_share"] == pytest.approx(0.2)
    assert out["lines"] == {"Stream #13(Compute)": 3,
                            "Stream #14(MemcpyD2D)": 1, "XLA Ops": 1}


def test_no_kernel_lines_is_an_error():
    with pytest.raises(RuntimeError, match="no kernel events"):
        reduce_trace({"XLA Ops": [(0, 5, "op")]}, steps=1)
