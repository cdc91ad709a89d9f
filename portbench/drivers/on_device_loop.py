"""Driver ``on_device_loop``: closed-loop experiments run on the device.

The port's on-device loop (``build_on_device_loop``) runs ``periods``
control periods of [solve -> the action held -> ``plant_substeps`` steps
of the port's plant on the card -> the waypoint pop, for a mission] as one
captured CUDA graph a period, replayed, with one host sync a run. The
window replays such runs back to back, each from the cell's start state
with a zero sequence, a mission re-armed before each; run r's period j
draws the normals of solve r * periods + j. A span is each run, host
clock, the sync included.

What is judged: one run of the window, drawn from the seed once it has
closed. The plain reference follows the run's own trajectory
(each period's state as the program's plant left it, as a served model's
tokens are followed): at each period it solves from the state the period
started at with its own sequence, started at zeros and shifted as the
controller shifts it, and compares the program's action (the action gap,
in units of each action's noise scale); it steps its own plant from the
same state under the program's action and compares the state the
program's plant reached (the state gap, each entry relative to 1 + its
size); it pops the mission where the program's state reached the leading
waypoint, and compares the legs the program popped (exact). The states
and pops are judged over the whole run; the actions over its first
``judge_periods`` periods (all, without the key), which keeps the
reference's solves, a period at a time, shorter than the window.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import program
from ..reference import mppi as ref_mppi

#: whether a period's plant steps count as device work (the plant's steps are device work of each period)
PLANT_ON_DEVICE = True


class Cell:
    """Set-up builds the controller, the port's plant and the loop, and
    runs ``warmup_runs`` whole runs (the first captures the graph)."""

    def __init__(self, ctx):
        self.ctx = ctx
        t = self.traffic = ctx.traffic
        self.periods = int(t["periods"])
        self.ctrl = program.controller(ctx.config, t, ctx.seed, ctx.device,
                                       ctx.kernel_dtype)
        self.plant = program.device_plant(ctx.config, t)
        self.loop = program.on_device_loop(self.ctrl, self.plant, t)
        self.x0 = np.asarray(t["start"], np.float64)
        self.mission = t.get("mission")
        self.runs = 0
        for _ in range(int(t["warmup_runs"])):
            self._run()

    def _run(self) -> tuple:
        """One run: (its first solve index, states [P, sdim], actions
        [P, adim], legs popped)."""
        if self.mission is not None:
            self.ctrl.set_waypoints(self.mission)
        step0 = self.runs * self.periods
        self.runs += 1
        states, actions = self.loop(self.x0, step0=step0)
        popped = (len(self.mission) - self.ctrl.waypoints_remaining()
                  if self.mission is not None else 0)
        return step0, states, actions, popped

    def window(self, seconds: float, spans: dict) -> dict:
        """Runs back to back until ``seconds`` have passed."""
        self.rec = []
        durations = spans.setdefault("run", [])
        raised = False
        begin = time.perf_counter()
        end = begin
        while end - begin < seconds:
            t0 = time.perf_counter()
            try:
                self.rec.append(self._run())
            except Exception as e:    # a launch that raised: the run failed
                self.ctx.log(f"run raised: {e!r}")
                raised = True
                end = time.perf_counter()
                break
            end = time.perf_counter()
            durations.append(end - t0)
        done = len(self.rec) * self.periods
        bad = sum(int((~torch.isfinite(s).all(dim=1)
                       | ~torch.isfinite(a).all(dim=1)).sum())
                  for _, s, a, _ in self.rec)
        return {"window_s": end - begin, "units": done,
                "periods": done, "attempted": done + raised * self.periods,
                "failed": bad + raised * self.periods,
                "nodes": dict(self.loop.nodes),
                "captures": self.loop.captures}

    def trace_work(self, runs: int, annotate) -> int:
        """``runs`` more runs, annotated for the profiler."""
        for _ in range(runs):
            if self.mission is not None:
                with annotate("portbench.rearm"):
                    self.ctrl.set_waypoints(self.mission)
            step0 = self.runs * self.periods
            self.runs += 1
            with annotate("portbench.run"):
                self.loop(self.x0, step0=step0)
        return runs * self.periods

    def outputs(self) -> dict:
        """The run the judge follows, drawn from the seed once the window
        has closed, on the host."""
        rng = np.random.default_rng([self.ctx.seed, 1])
        step0, states, actions, popped = self.rec[
            int(rng.integers(len(self.rec)))]
        return {"step0": step0, "states": states.double().cpu(),
                "actions": actions.double().cpu(), "popped": popped}

    def free(self) -> None:
        self.rec = None
        self.loop = self.ctrl = self.plant = None


def judge(ctx, out: dict, ref) -> dict:
    """{check: value} of the run ``out`` against the plain reference."""
    t = ctx.traffic
    dev = ref.device
    states = out["states"].to(dev)
    actions = out["actions"].to(dev)
    periods, adim = actions.shape
    mission = t.get("mission")
    cp = (ref.mission_params(mission) if mission is not None
          else ref.static_params())
    useq = torch.zeros(int(t["tau"]), adim, dtype=torch.float64, device=dev)
    x = torch.as_tensor(t["start"], dtype=torch.float64, device=dev)
    judged = min(periods, int(t.get("judge_periods", periods)))
    planner = ref_mppi.Planner(ref, ctx.seed, int(t["k"]),
                               bool(t["normalize"]))
    a_gap = s_gap = 0.0
    pops = []
    for j in range(periods):
        if j < judged:
            new = planner(x, useq, cp, out["step0"] + j)
            a_gap = max(a_gap, float(((actions[j] - new[0]).abs()
                                      / ref.action_scale).max()))
            useq = ref_mppi.shift(new)
        x_ref = ref.plant(x, actions[j], float(t["plant_dt"]),
                          int(t["plant_substeps"]))
        s_gap = max(s_gap, float(((states[j] - x_ref).abs()
                                  / (1.0 + x_ref.abs())).max()))
        x = states[j]
        if mission is not None:
            before = cp["count"]
            cp = ref.pop(cp, x, float(t["radius"]))
            if cp["count"] < before:
                pops.append(j)
    ctx.log(f"judged the actions of periods 0-{judged - 1} and the states "
            f"of all {periods} of the run from solve {out['step0']}; "
            f"the reference popped after periods {pops}")
    checks = {"action_gap": a_gap, "state_gap": s_gap}
    if mission is not None:
        popped = len(mission) - cp["count"]
        checks["pops_differ"] = float(abs(out["popped"] - popped))
    return checks
