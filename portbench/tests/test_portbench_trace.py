"""The reading of a traced window, on a synthetic Chrome trace."""

from __future__ import annotations

import re

import pytest

from portbench import trace


def _ev(name, cat, ts, dur, tid=1):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1,
            "tid": tid}


def test_busy_idle_and_where_the_host_was():
    events = [
        _ev("portbench.window", "user_annotation", 0, 100),
        _ev("portbench.next", "user_annotation", 0, 50),
        _ev("aten::mm", "cpu_op", 5, 10),
        _ev("cudaMemcpyAsync", "cuda_runtime", 30, 15),
        _ev("portbench.plant", "user_annotation", 55, 20),
        _ev("void pm_fused_solve_kernel<6, 3>(x)", "kernel", 20, 20, tid=7),
        _ev("elementwise_kernel", "kernel", 38, 7, tid=7),
        _ev("Memcpy DtoH", "gpu_memcpy", 45, 2, tid=7),
        _ev("late_kernel", "kernel", 120, 5, tid=7),
    ]
    r = trace.read(events, re.compile(r"\bpm_fused_solve_kernel\b"))
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(27e-6)          # [20, 47)
    assert (r["n_kernels"], r["n_solve_kernels"]) == (2, 1)
    assert r["solve_kernel_s"] == pytest.approx(20e-6)
    assert r["kernel_s"] == pytest.approx(27e-6)
    idle = dict(r["idle_gaps"])
    # gaps [0, 20) and [47, 100) over the innermost host ranges
    assert idle == pytest.approx({"portbench.next": 13e-6,
                                  "portbench.next/aten::mm": 10e-6,
                                  "portbench.plant": 20e-6,
                                  "portbench.window": 30e-6})
    assert sum(idle.values()) == pytest.approx(r["window_s"] - r["busy_s"])
