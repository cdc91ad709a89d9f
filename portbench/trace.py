"""The traced window: ``torch.profiler`` over a fixed amount of a cell's
work, read back from its Chrome trace.

What it yields: every device operation (kernels, copies, sets) inside the
window, the seconds in which one ran (``busy_s``, the union of their
intervals) against the window's length (``window_s``, the host range
``portbench.window``), the kernels split into the solve's (by the names
``solve_kernels/*.json`` list) and the rest, the ten device operations
that took most time, and the idle time summed by what the host was
doing during it (the innermost host range open on the thread that drove
the window, under the benchmark's own annotation). The profiler
has lost kernel records of replayed graphs on the H100, so a window whose
named kernels fall short of the launches the port counted is profiled
again, up to ``TRIES`` times, and the fullest try is kept.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from pathlib import Path

TRIES = 3
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")


def solve_names() -> list:
    """The solve's kernel names, from every file of ``solve_kernels/``."""
    names = []
    for p in sorted((Path(__file__).parent / "solve_kernels").glob("*.json")):
        names += json.loads(p.read_text())["kernels"]
    return names


def profile(cell, amount: int, launch_counts) -> dict:
    """Profile ``cell.trace_work(amount, annotate)`` on the card; returns
    the fullest try's reading with ``tries`` and ``launched`` (the port's
    own count of its named kernels' launches)."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    rx = re.compile(r"\b(" + "|".join(map(re.escape, solve_names()))
                    + r")\b")
    best = None
    for attempt in range(1, TRIES + 1):
        before = launch_counts()
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            with record_function("portbench.window"):
                units = cell.trace_work(amount, record_function)
                torch.cuda.synchronize()
        after = launch_counts()
        launched = sum(after[k] - before.get(k, 0) for k in after)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        got = read(events, rx)
        got.update(units=units, launched=launched, tries=attempt)
        if best is None or got["n_solve_kernels"] > best["n_solve_kernels"]:
            best = got
        best["tries"] = attempt
        if got["n_solve_kernels"] >= launched:
            break
    return best


def _merge(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read(events: list, solve_rx) -> dict:
    """The reading of one trace's events (Chrome trace format, times in
    microseconds)."""
    win = next(e for e in events if e.get("name") == "portbench.window"
               and e.get("cat") == "user_annotation")
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and w0 <= float(e["ts"]) < w1]
    busy = _merge([[float(e["ts"]), min(float(e["ts"]) + float(e["dur"]),
                                         w1)] for e in dev])
    by_op, kernel_s, solve_s = {}, 0.0, 0.0
    n_kernels = n_solve = 0
    for e in dev:
        s = float(e["dur"]) * 1e-6
        name = e["name"][:120]
        by_op[name] = by_op.get(name, 0.0) + s
        if e["cat"] == "kernel":
            n_kernels += 1
            kernel_s += s
            if solve_rx.search(e["name"]):
                n_solve += 1
                solve_s += s
    gaps, edge = [], w0
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if edge < w1:
        gaps.append((edge, w1))
    idle = _idle_by_host(events, win, gaps)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "n_kernels": n_kernels, "kernel_s": kernel_s,
            "n_solve_kernels": n_solve, "solve_kernel_s": solve_s,
            "device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in
                          sorted(idle.items(), key=lambda kv: -kv[1])[:10]]}


def _idle_by_host(events: list, win: dict, gaps: list) -> dict:
    """Idle seconds by what the host was doing during them, on the
    window's thread: each gap split over the innermost host ranges then
    open, labelled '<the benchmark's range>/<the innermost range>'."""
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"][:80]) for e in events
                   if e.get("cat") in HOST_CATS and e.get("tid") ==
                   win.get("tid") and e.get("pid") == win.get("pid")
                   and "dur" in e),
                  key=lambda h: (h[0], -h[1]))
    out, i = {}, 0
    for a, b, label in _innermost(host):
        while i < len(gaps) and gaps[i][1] <= a:
            i += 1
        j = i
        while j < len(gaps) and gaps[j][0] < b:
            cut = min(b, gaps[j][1]) - max(a, gaps[j][0])
            if cut > 0:
                out[label] = out.get(label, 0.0) + cut * 1e-6
            j += 1
    return out


def _innermost(host: list) -> list:
    """The host's nested ranges cut into segments, each labelled by the
    innermost range open over it and the benchmark's own range around
    it: [(start, end, label)] in time order."""
    segs, stack = [], []   # stack entries: [start, end, name, cursor, ours]

    def label(r):
        return r[2] if r[2] == r[4] else f"{r[4]}/{r[2]}"

    def close(t):
        while stack and stack[-1][1] <= t:
            r = stack.pop()
            if r[3] < r[1]:
                segs.append((r[3], r[1], label(r)))
            if stack:
                stack[-1][3] = r[1]

    for a, b, name in host:
        close(a)
        if stack:
            top = stack[-1]
            b = min(b, top[1])
            if top[3] < a:
                segs.append((top[3], a, label(top)))
            top[3] = a
        ours = (name if name.startswith("portbench.") else
                stack[-1][4] if stack else "outside")
        stack.append([a, b, name, a, ours])
    close(float("inf"))
    return sorted(segs)
