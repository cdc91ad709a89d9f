"""Driver ``fleet_replan``: a fleet of vehicles replanned from the host.

Every step hands the states of all n vehicles to the port's
``FleetMPPI.next`` (one whole-fleet solve on the device, the actions
copied back), then advances each vehicle through the configuration's plain
plant on the host, as a fleet's vehicle stack would. The window is a closed
loop of such steps back to back; a span is each ``next``, host clock, up to
the actions' copy.

What is judged: each vehicle-solve's action and the sequence it leaves for
the next step (``FleetMPPI.useq``, which is the updated sequence shifted
by one row). A sample of (step, vehicle) pairs drawn from the seed once
the window has closed is solved again by the plain reference from the
same state and the sequence the vehicle held before that step, with the
normals of solve (step n + vehicle); the gap is the largest difference
over the sequence in units of each action's noise scale. The start (the
sequences before the first step: zeros) and the shift (each step's last
row: zeros) are checked exactly on every step, so that the reference's
stepping from the program's own sequences skips nothing.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import program
from ..reference import mppi as ref_mppi

#: whether a period's plant steps count as device work (the plant runs on the host)
PLANT_ON_DEVICE = False


def goals(traffic: dict, n: int, rng) -> np.ndarray:
    """Each vehicle's goal: ``goal_base`` with the entries ``goal_draw``
    names drawn uniform(low, high) from the seed."""
    g = np.tile(np.asarray(traffic["goal_base"], np.float64), (n, 1))
    draw = traffic["goal_draw"]
    for i in draw["indices"]:
        g[:, i] = rng.uniform(draw["low"], draw["high"], n)
    return g


class Cell:
    """Set-up builds the fleet, its goals and the host plant, and warms up
    the cell's own shapes (``warmup_steps`` whole steps)."""

    def __init__(self, ctx):
        self.ctx = ctx
        t = self.traffic = ctx.traffic
        self.n = int(t["vehicles"])
        rng = np.random.default_rng([ctx.seed, 0])
        self.goals = goals(t, self.n, rng)
        self.plant = ctx.reference("cpu")
        self.fleet = program.fleet(ctx.config, t, ctx.seed, ctx.device,
                                   self.goals, ctx.kernel_dtype)
        self.start_gap = float(self.fleet.useq.abs().max())
        self.x = np.tile(np.asarray(t["start"], np.float64), (self.n, 1))
        self.steps = 0
        for _ in range(int(t["warmup_steps"])):
            self.x = self._advance(self.x, self.fleet.next(self.x))
            self.steps += 1

    def _advance(self, x, actions):
        t = self.traffic
        return self.plant.host_plant(x, np.asarray(actions, np.float64),
                                     float(t["plant_dt"]),
                                     int(t["plant_substeps"]))

    def window(self, seconds: float, spans: dict) -> dict:
        """Steps back to back until ``seconds`` have passed; each step's
        inputs and outputs are kept for the judge (the sequences as the
        program's own tensors, which no later step writes)."""
        self.rec = {"x": [], "useq": [], "actions": [], "step0": self.steps}
        durations = spans.setdefault("next", [])
        failed, raised = 0, False
        begin = time.perf_counter()
        end = begin
        while end - begin < seconds:
            x = self.x
            useq = self.fleet.useq
            t0 = time.perf_counter()
            try:
                actions = self.fleet.next(x)
            except Exception as e:    # a launch that raised: all n failed
                self.ctx.log(f"next raised: {e!r}")
                failed, raised = failed + self.n, True
                end = time.perf_counter()
                break
            end = time.perf_counter()
            durations.append(end - t0)
            self.rec["x"].append(x)
            self.rec["useq"].append(useq)
            self.rec["actions"].append(actions)
            failed += int((~np.isfinite(actions).all(axis=1)).sum())
            self.steps += 1
            self.x = self._advance(x, actions)
            end = time.perf_counter()
        self.rec["useq"].append(self.fleet.useq)
        done = len(self.rec["actions"])
        return {"window_s": end - begin, "units": done,
                "attempted": self.n * (done + raised), "failed": failed,
                "vehicle_solves": self.n * done}

    def trace_work(self, steps: int, annotate) -> int:
        """``steps`` more steps, annotated for the profiler."""
        for _ in range(steps):
            with annotate("portbench.next"):
                actions = self.fleet.next(self.x)
            self.steps += 1
            with annotate("portbench.plant"):
                self.x = self._advance(self.x, actions)
        return steps

    def outputs(self) -> dict:
        """What the judge needs, on the host, drawn once the window has
        closed; the fleet is freed afterwards."""
        rec, n = self.rec, self.n
        done = len(rec["actions"])
        rng = np.random.default_rng([self.ctx.seed, 1])
        m = min(int(self.traffic["judge_solves"]), done * n)
        picks = sorted(int(i) for i in rng.choice(done * n, size=m,
                                                  replace=False))
        tails = torch.stack([u[:, -1, :] for u in rec["useq"][1:]])
        out = {"start_gap": self.start_gap,
               "shift_fill": float(tails.abs().max()) if done else 0.0,
               "picks": []}
        for p in picks:
            s, v = divmod(p, n)
            out["picks"].append({
                "step": rec["step0"] + s, "vehicle": v,
                "x": rec["x"][s][v].copy(),
                "useq_in": rec["useq"][s][v].double().cpu(),
                "action": np.asarray(rec["actions"][s][v], np.float64),
                "useq_out": rec["useq"][s + 1][v].double().cpu()})
        return out

    def free(self) -> None:
        self.rec = None
        self.fleet = None


def judge(ctx, out: dict, ref) -> dict:
    """{check: value} of the fleet's outputs against the plain reference
    ``ref`` (on the device the reference runs on)."""
    t = ctx.traffic
    n = int(t["vehicles"])
    goals_ = goals(t, n, np.random.default_rng([ctx.seed, 0]))
    planner = ref_mppi.Planner(ref, ctx.seed, int(t["k"]),
                               bool(t["normalize"]))
    gap = 0.0
    for p in out["picks"]:
        new = planner(p["x"], p["useq_in"],
                      ref.static_params(goals_[p["vehicle"]]),
                      p["step"] * n + p["vehicle"])
        prog = torch.cat([torch.as_tensor(p["action"], dtype=torch.float64,
                                          device=ref.device)[None],
                          p["useq_out"][:-1].to(ref.device)])
        g = ((prog - new).abs() / ref.action_scale).max()
        gap = max(gap, float(g))
    ctx.log(f"judged {len(out['picks'])} vehicle-solves")
    return {"sequence_gap": gap, "start": out["start_gap"],
            "shift_fill": out["shift_fill"]}
