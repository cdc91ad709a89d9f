"""One run of one cell: set-up, the measured window, the traced window,
the judge, the metrics.

Everything is found by name. ``BENCHMARK.json`` lists the cells and the
metrics; a cell is ``workloads/<cell>.json`` (its configuration, driver,
traffic and the limits of its judge); a configuration is
``configs/<config>.json``, whose ``reference`` names its plain reference
(``reference/<name>.py``) and whose ``counts`` names its family's counts
(``counts/<name>.py``); a driver is ``drivers/<driver>.py``; a metric is
``metrics/<metric>.py`` with ``read(run) -> number or None``.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

#: top-level modules the run must not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "mppi_tf_tpu")


class Context:
    """A cell, its configuration and the run's seed and device."""

    def __init__(self, root, cell: str, seed: int, device: str = "cuda",
                 kernel_dtype: str = "float32", t0: float | None = None):
        self.root = Path(root)
        self.bench = self.root / "portbench"
        self.manifest = json.loads((self.root / "BENCHMARK.json").read_text())
        self.cell = json.loads(
            (self.bench / "workloads" / f"{cell}.json").read_text())
        self.config = json.loads(
            (self.bench / "configs" / f"{self.cell['config']}.json")
            .read_text())
        self.traffic = self.cell["params"]
        self.seed = int(seed)
        self.device = device
        self.kernel_dtype = kernel_dtype
        self.t0 = time.perf_counter() if t0 is None else t0

    def reference(self, device):
        mod = importlib.import_module(
            f"portbench.reference.{self.config['reference']}")
        return mod.Reference(self.config, device)

    def driver(self):
        return importlib.import_module(
            f"portbench.drivers.{self.cell['driver']}")

    def counts(self) -> dict:
        """The cell's frozen counts a step (a fleet step or a period)."""
        from .counts import mppi

        fam = importlib.import_module(
            f"portbench.counts.{self.config['counts']}")
        n = int(self.traffic.get("vehicles", 1))
        work = fam.solve_work(self.config, self.traffic)
        ops, n_bytes = n * work["ops"], n * work["bytes"]
        ms, by = mppi.bound_ms(ops, n_bytes)
        plant = (fam.plant_ops(self.config, self.traffic)
                 if self.driver().PLANT_ON_DEVICE else 0.0)
        return {"solve_ops": ops, "solve_bytes": n_bytes,
                "solve_bound_ms": ms, "bound_by": by, "plant_ops": plant,
                "peaks": mppi.PEAKS}

    def metrics(self, trace: bool) -> list:
        """The manifest's metrics this cell reports in this mode."""
        group = self.manifest["per_layer" if trace else "end_to_end"]
        name = self.cell["name"]
        return [m for m in group
                if "workloads" not in m or name in m["workloads"]]

    @staticmethod
    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)


def reader(bench: Path, name: str):
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run(ctx: Context, seconds: float, trace: bool) -> dict:
    """One run of ``ctx``'s cell; returns the result line's object."""
    import torch

    cuda = ctx.device.startswith("cuda")
    driver = ctx.driver()
    cell = driver.Cell(ctx)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.t0
    spans = {}
    win = cell.window(float(seconds), spans)
    for name, d in spans.items():
        q = sorted(d)
        if q:
            ctx.log(f"spans {name}: {len(q)}, median "
                    f"{q[len(q) // 2] * 1e3:.4f} ms, max {q[-1] * 1e3:.4f} ms, "
                    f"window {win['window_s']:.4f} s")
    if cuda:
        ctx.log("card after the window: "
                + smi("clocks.sm,clocks.mem,power.draw,temperature.gpu"))
    traced = None
    if trace and cuda:
        from . import program, trace as tr

        traced = tr.profile(cell, int(ctx.traffic["trace_amount"]),
                            program.launch_counts)
        ctx.log(f"traced window: {traced['units']} units, "
                f"{traced['tries']} tries, {traced['n_solve_kernels']} of "
                f"{traced['launched']} launches of the port's named kernels "
                f"recorded")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    out = cell.outputs()
    cell.free()
    del cell
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = driver.judge(ctx, out, ctx.reference(ctx.device))
    ctx.log(f"reference: {time.perf_counter() - t_ref:.3f} s")
    limits = ctx.cell["limits"]
    compared = {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}
    correct = (win["failed"] == 0
               and all(v == v and v <= limits[k] for k, v in checks.items()))
    view = SimpleNamespace(cell=ctx.cell, config=ctx.config,
                           traffic=ctx.traffic, setup_s=setup_s, window=win,
                           spans=spans, counts=ctx.counts(), trace=traced)
    metrics = {}
    for m in ctx.metrics(trace):
        value = reader(ctx.bench, m["name"])(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": int(win["attempted"]),
              "failed": int(win["failed"]), "metrics": metrics,
              "device": device_info(cuda, int(ctx.cell["chips"]), peak,
                                     traced)}
    if traced is not None:
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    result["checks"] = compared
    return result


def device_info(cuda: bool, chips: int, peak: int, traced) -> dict:
    import torch

    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak),
            "power_limit": smi("name,power.limit")}
    if traced is not None:
        info.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
    return info


def smi(fields: str) -> str:
    """``nvidia-smi``'s reading of the card's ``fields`` (its name and
    power limit beside each result; its clocks, power and temperature
    after the window, on standard error)."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read: {e!r}"
