#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root:  python3 chip_smoke.py

Builds the CUDA kernels of ``mppi_tf_tpu_torch`` from the sources in the
checkout (one nvcc per source, in parallel), holds each kernel against its
plain PyTorch version, checks the in-kernel noise stream, and drives the
port's paths through ``MPPI.next`` closed loop against the analytic plants:

- the point mass with the static cost at K=100,000 samples, H=50 (the
  fused solve; then the two-phase normalized solve);
- the rexrov2 AUV flagship with the static quaternion cost at K=262,144,
  H=25: the normalized dive (the two-phase solve: auv_fused_costs, then
  mppi_weights) and the unnormalized fused solve;
- the learned NNAUVModel (3x32 MLP) with the static quaternion cost at
  K=65,536, H=25: its kernels against their plain versions, then a dive
  through the NN kernels (kernel="cuda") and the torch route, with a
  network built to compute a known plant, in both solve modes;
- the tracking slice: the point-mass waypoint and 2D ellipse costs and the
  AUV quaternion-waypoint and 3D ellipse costs, each kernel variant against
  its plain version; the 3-leg point-mass mission through
  ``run_experiment`` (K=100,000, H=50), the 2-DoF ellipse loop on the
  kernels and the plain path, the rexrov2 waypoint mission (K=262,144,
  H=25) and the 3D ellipse on envs/bluerov, mission loops held to one host
  sync a step;
- the config CLI (``mppi_tf_tpu_torch.cli.main``) on the card for the
  point-mass, rexrov2 and NN configs and the four tracking tasks;
- the noise variants: ``point_mass_h100`` (H=100, exp noise schedule) with
  the scheduled solve and costs against their plain versions and 300-step
  loops in both modes, c_t = 1 set at run time against no schedule; the
  antithetic dump (pairs sum to exactly 0), solve, costs and weights
  (adim 3 and 6) and 300-step loops; the rexrov2 AUV and the NN with both
  options, their kernels against the plain versions and their dives;
- log mode: the CLI with ``-l`` and ``MPPI(observer=...)`` at
  ``point_mass_h100``, held to the JAX observer's JSONL tags;
- the DMD slice: the dynamic_ab solve and costs (runtime A and B scale in
  ``dyn``) against their plain versions at K=100,000, H=50 (seeded,
  dense random and refit (A, B), injected z and Philox) and at K=700, H=7
  for (4, 2) quadratic and ellipse, and against the point mass's kernel
  on the same map; the JAX bench's dmd row, 300 ``DMDMPPI`` steps a mode
  on the kernels; the adaptive loop (mass-1 prior, mass-3 plant, refits
  from ``save`` through ``ClosedLoopRunner``) held to its identification,
  its goal, one sync a step and no rebuild; the CLI with
  ``--model models/dmd_model``.

The build phase reports each instantiation's registers beside those it
had before the noise variants (PERF.md). It
times every kernel, each noise variant beside the same kernel without
it, and the dynamic_ab variant beside the constant-(A, B) kernel. Each phase prints one JSON line; any failed check
raises and the script exits non-zero. Without a CUDA device it exits
non-zero before printing any result.

The last lines are the ``kernels`` JSON line, the card's name and power
limit as ``nvidia-smi`` prints them, and
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

# the workload of the main path (mppi_tf_tpu/bench.py::_build_workload,
# "point_mass"): 3-DoF point mass, state 6, action 3
K, H = 100_000, 50
SIGMA = np.diag([0.25, 0.25, 0.25])
LAM, GAMMA, UPSILON, MASS, DT = 0.8, 0.2, 1.0, 1.0, 0.1
GOAL = [1.0, 0.0, 0.5, 0.0, -0.5, 0.0]
Q = [5.0, 1.0, 5.0, 1.0, 5.0, 1.0]
LOOP_STEPS = 300
GOAL_TOL = 0.05
# H100 SXM published peaks (NVIDIA datasheet): HBM bytes/s and
# f32 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
# operations per generated normal: Philox4x32-10 is 98 integer ops per 4
# words (10 rounds of 2 mul-hi, 2 mul-lo, 4 xor; 9 key bumps of 2 adds);
# Box-Muller ~15 per pair (2 uniforms of 4 ops, log, mul, sqrt, sin, cos,
# 2 muls); every op counted at the f32 rate, so the bound is a floor
OPS_PER_NORMAL = 98 / 4 + 15 / 2

# the AUV flagship (mppi_tf_tpu/bench.py "auv_rexrov2" row): rexrov2, rk2,
# state 13, action 6, K=262,144, H=25
AUV_K, AUV_H = 262_144, 25
AUV_SIGMA = 1500.0 * np.eye(6)
AUV_LAM, AUV_GAMMA, AUV_UPSILON = 0.5, 0.2, 1.0
# the normalized dive (tests/test_envs.py:416-455 at full width): goal
# z = -1, 160 control steps of 0.1 s, each 5 plant substeps of 0.02 s
DIVE_SIGMA = np.diag([2000.0] * 3 + [200.0] * 3)
DIVE_Q = [60.0, 60.0, 60.0, 10.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]
DIVE_STEPS, DIVE_SUBSTEPS, DIVE_TOL = 160, 5, 0.2
# the unnormalized flagship loop: a path for auv_fused_solve
AUV_PLAIN_STEPS = 40
# per-sample AUV costs of O(1e4-1e5) in f32, summed in another order:
# rtol 1e-4; the theta term 2 acos(dot) carries ~3e-4 rad of rounding near
# dot = 1, where acos is steep, hence a small absolute floor
COST_RTOL, COST_ATOL = 1e-4, 1e-2
# per-sample point-mass costs of O(10-100)
PM_COST_RTOL, PM_COST_ATOL = 1e-4, 1e-4


# the learned-dynamics slice (mppi_tf_tpu/bench.py "auv_nn_mlp", the `nn`
# workload): NNAUVModel 16->32->32->32->13, K=65,536, H=25, the flagship
# sigma, lambda, gamma and task
NN_K, NN_H = 65_536, 25
# the known-plant closed loop: the 3x32 network computes a double
# integrator in the body frame (mass and inertia 10, no damping); the
# same loop at K=1,024 meets the gate on the CPU in both packages
# (tests/test_torch_nn_controller.py)
NN_MASS = NN_INERTIA = 10.0
NN_LOOP_SIGMA = np.diag([5.0] * 3 + [2.0] * 3)
NN_LOOP_Q = [60.0, 60.0, 60.0, 10.0] + [1.0] * 6
NN_LOOP_STEPS, NN_LOOP_TOL = 80, 0.2
NN_CLI_STEPS = 5

# the tracking slice. Point-mass mission: the bundled envs/point_mass (lambda
# 1, gamma 1, sigma 0.25 I) and tasks/waypoints_task (3 legs, radius 0.3) at
# K, H; 150 steps end within 0.025 of the last leg at K=4,000 on the CPU,
# the gate is the JAX serve drive's 0.25
PM_WP_STEPS, PM_WP_TOL = 150, 0.25
# the ellipse: tasks/elipse_task (a 4, b 2, speed 5) on a 2-DoF point mass
# from (4, 0, 0, 0); gate over the last 100 of 300 steps, set from the CPU
# rehearsal in both packages (tests/test_torch_tracking_costs.py::
# test_elipse_loop_tracks_in_both: radial 0.26 / 0.25, speed error 4.27 /
# 4.28, a lap); the normalized loop is a path for pm_fused_costs
EL_PATCH = {"state-dim": 4, "action-dim": 2, "init-act": [0.0, 0.0],
            "max-a": [1.0, 1.0], "noise": [[0.25, 0.0], [0.0, 0.25]]}
EL_X0 = [4.0, 0.0, 0.0, 0.0]
EL_STEPS, EL_NORM_STEPS, EL_RAD_TOL, EL_SPEED_TOL = 300, 100, 0.4, 4.5
# the rexrov2 mission (tests/test_missions.py:141-187 at full width): the
# dive's sigma and Q, legs at z = -1 and -2, radius 0.5; 240 steps (the
# CPU rehearsal at K=2,048 overshoots to z = -2.22 near step 160 and is
# back at -2.10 by step 200)
AUV_WP_STEPS, AUV_WP_RADIUS, AUV_WP_TOL = 240, 0.5, 0.2
# the 3D ellipse on envs/bluerov with the rexrov2 vehicle
E3_STEPS = 40

# the long-horizon row of the JAX bench suite, "point_mass_h100"
# (mppi_tf_tpu/bench.py:83-87, :183, BASELINE.json configs[3]): the point
# mass above at K, H=100 with the per-step noise schedule exp 1 -> 0.25
H100 = 100
SCHED = {"type": "exp", "start": 1.0, "end": 0.25}
# its gates: the normalized loop ends within GOAL_TOL; the unnormalized one
# does not settle that close in either package (the softmax over H=100
# costs is near one-hot), so it is held to the goal error's mean over the
# last SCHED_WINDOW steps. That mean falls with K: 0.28-0.36 at K=1,000
# in both packages (tests/test_torch_noise_variants.py::
# test_point_mass_h100_loops_in_both_packages)
SCHED_WINDOW, SCHED_MEAN_TOL = 100, 0.2
# registers a thread of each instantiation before the noise variants were
# added (PERF.md, the tracking slice's Findings): exact for the AUV's
# <RK, MODE, COST>, a range where PERF.md recorded one
BASE_REGISTERS = {
    **{("auv_fused_solve_kernel", (rk, mode, cost)): r
       for mode, by_cost in ((0, ((161, 204, 210), (128, 205, 198),
                                  (141, 202, 198))),
                             (1, ((168, 208, 220), (128, 205, 207),
                                  (148, 202, 207))))
       for cost, regs in enumerate(by_cost)
       for rk, r in zip((1, 2, 4), regs)},
    "pm_fused_solve_kernel": [32, 48],
    ("nn_fused_solve_kernel", (8, 8, 0, 0)): 80,
    ("nn_fused_solve_kernel", (8, 8, 0, 1)): 80,
    "nn_fused_solve_kernel": [172, 178],
}
# both noise options, as MPPI keywords (the AUV dive, the NN dive) and as
# solve-object keywords
BOTH = {"noise_schedule": SCHED, "antithetic": True}
FUSED_BOTH = {"schedule": SCHED, "antithetic": True}
# the steps logged through MPPI(observer=...) at point_mass_h100, and the
# CLI's logged point-mass run
LOG_STEPS, LOG_CLI_STEPS = 5, 20
# the DMD slice: the JAX bench's "dmd" row (mppi_tf_tpu/bench.py:107-116),
# DMDModel(6, 3) seeded with the point mass's (A, B) at mass 1, the static
# cost above, at K, H (dmd_kernels, dmd_loop); its adaptive companion
# (bench.py:722-763, dmd_adaptive): a mass-1 prior against a mass-3
# PointMassEnv at dt 0.01 under ClosedLoopRunner at control dt 0.1, refit
# every 10 saves, reg 1e-8, 200 steps. Its gates: both packages end that
# loop within ~3e-3 of the goal with max |B - B_true/3| ~ 6e-7 at K=2,000,
# H=20 on the CPU (tests/test_torch_dmd.py::
# test_adaptive_loop_in_both_packages)
DMD_PLANT_MASS, DMD_REFIT, DMD_REG = 3.0, 10, 1e-8
DMD_ADAPT_STEPS, DMD_GOAL_TOL, DMD_B_TOL = 200, 0.05, 1e-4
# the adaptive profile's window: steps 151-170 span the refits at saves
# 160 and 170
DMD_PROFILE_FROM, DMD_PROFILE_STEPS = 150, 20
# the CLI with --model models/dmd_model on the bundled envs/point_mass
# (K=3,000, H=50): 100 steps end 0.10 (port) and 0.11 (JAX) from the goal
# on the CPU (tests/test_torch_dmd.py::test_cli_dmd_model_in_both_packages)
DMD_CLI_STEPS, DMD_CLI_TOL = 100, 0.3
# the tag families of the JAX observer's JSONL (observer_base.py:101-187)
LOG_FAMILIES = ("Cost/", "Controller/", "Input/axis_", "State/state")


def known_plant_params(dt: float = 0.1, mass: float = NN_MASS,
                       inertia: float = NN_INERTIA) -> dict:
    """JAX-layout params of a 3x32 ReLU network that computes a known plant
    exactly: layer 1 emits [f, -f]^+ of the 16 features f = [q, v, w, u],
    the two middle layers are the 32x32 identity, and the last maps
    (h^+ - h^-) to dpos = dt v, dq = 0, dv = (dt / m) u_lin,
    dw = (dt / I) u_ang; identity normalisers."""
    eye = np.eye(16)
    m = np.zeros((16, 13))
    for j in range(3):
        m[4 + j, j] = dt
        m[10 + j, 7 + j] = dt / mass
        m[13 + j, 10 + j] = dt / inertia
    net = [{"w": np.concatenate([eye, -eye], axis=1), "b": np.zeros(32)},
           {"w": np.eye(32), "b": np.zeros(32)},
           {"w": np.eye(32), "b": np.zeros(32)},
           {"w": np.concatenate([m, -m], axis=0), "b": np.zeros(13)}]
    return {"net": net, "x_mean": np.zeros(16), "x_std": np.ones(16),
            "y_mean": np.zeros(13), "y_std": np.ones(13)}


def known_plant_task() -> dict:
    """The known-plant loop's StaticQuatCost task: dive to z = -1."""
    goal = np.zeros(13)
    goal[[2, 6]] = [-1.0, 1.0]
    return {"type": "static_quat", "diag": True, "goal": goal.tolist(),
            "Q": NN_LOOP_Q}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def registers_vs_base(ptxas: list) -> list:
    """Each instantiation's registers beside ``BASE_REGISTERS`` (null
    where none was recorded), by kernel name and template arguments read
    from the mangled name."""
    import re

    rows = []
    for r in ptxas:
        m = re.search(r"([a-z_]+_kernel)(?:I((?:Li-?\d+E)+)E)?", r["kernel"])
        name = m.group(1)
        args = tuple(int(a) for a in re.findall(r"Li(-?\d+)E",
                                                m.group(2) or ""))
        base = BASE_REGISTERS.get((name, args), BASE_REGISTERS.get(name))
        rows.append({"kernel": name, "template": list(args),
                     "registers": r.get("registers"), "base": base})
    return rows


def workload(device, dmd: bool = False):
    """The point-mass workload's model and cost; with ``dmd``, the JAX
    bench's dmd row: a DMDModel seeded with the point mass's (A, B)."""
    from mppi_tf_tpu_torch.costs import get_cost
    from mppi_tf_tpu_torch.models import get_model
    from mppi_tf_tpu_torch.models.dmd import DMDModel

    model = get_model({"type": "point_mass", "mass": MASS}, dt=DT,
                      state_dim=6, action_dim=3, device=device)
    if dmd:
        model = DMDModel(6, 3, dt=DT, init_A=model.A.cpu().numpy(),
                         init_B=model.B.cpu().numpy() / MASS, device=device)
    cost = get_cost({"type": "static", "diag": True, "goal": GOAL, "Q": Q},
                    lam=LAM, gamma=GAMMA, upsilon=UPSILON, sigma=SIGMA,
                    device=device)
    return model, cost


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events around the run, after a warm-up)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 50) -> float:
    """The device time of one launch of ``fn``'s kernel (``fn`` launches
    one), from ``torch.profiler`` over ``reps`` calls: without the host's
    launch cost, which back-to-back CUDA-event timing includes where a
    kernel is shorter than its launch. The mean is over the launches the
    profiler recorded, which may be fewer than ``reps``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in kern)
            / max(sum(e.count for e in kern), 1) / 1e3)


def close(a: torch.Tensor, b: torch.Tensor, rtol: float, atol: float):
    """(ok, max abs err, max err / (atol + rtol |b|)) of a against b."""
    err = (a.double() - b.double()).abs()
    ratio = (err / (atol + rtol * b.double().abs())).max().item()
    return ratio <= 1.0, err.max().item(), ratio


def nnz(a) -> int:
    return int(np.count_nonzero(a))


#: operations of one 2D ellipse cost (pm_mppi.cu state_cost<kElipse>): two
#: centred, scaled coordinates (4), their squares summed (3), |. - 1| (2),
#: the speed (3 + sqrt 1), its error squared (2), the weighted sum (3)
ELIPSE_OPS = 18
#: operations of one 3D ellipse cost (auv_mppi.cu elipse3d_cost, FMA = 2,
#: acos 10, rsqrt 1): centring (3), R_plane (18), the scaled squares and
#: |. - 1| (11), q_plane (x) q (28), the tangent and its norm (13),
#: between_two_vectors and its norm (12), the dot, |.| and acos (19), the
#: speed error (7), the weighted sum (4)
ELIPSE3D_OPS = 115


def solve_ops(consts, k: int, tau: int, prng: bool,
              costs_only: bool = False) -> float:
    """Operations of one fused solve, from the nonzeros of this run's
    matrices (FMA = 2): rollout and cost per sample-step, the terminal
    cost, the softmax, the w*z reduction, and one noise pass (the function
    needs each normal once; the kernel's regeneration in its second pass
    is its own choice and not counted). With ``costs_only`` (phase A): no
    softmax or w*z. The state cost is the quadratic around dyn's goal or,
    for the "elipse" kind, ``ELIPSE_OPS``. A dynamic_ab solve's A and B
    scale are runtime data: counted dense, as JAX roofline.py:231-232
    counts them."""
    sdim, adim = consts.dims
    q_ops = (ELIPSE_OPS if consts.cost_kind == "elipse"
             else sdim + 2 * nnz(consts.Q) + 2 * sdim)
    ab = (sdim * (sdim + adim) if consts.dynamic_ab
          else nnz(consts.A) + nnz(consts.Bs))
    step = (2 * ab + 2 * sdim + q_ops
            + 2 * adim + 2 * nnz(consts.Mz) + 2 * adim + 2)
    return _rollout_ops(k, tau, adim, step, q_ops, prng, costs_only)


def _rollout_ops(k, tau, adim, step, q_ops, prng, costs_only):
    n_normals = k * tau * adim
    if costs_only:
        ops = k * (tau * step + q_ops + 1)
    else:
        ops = k * (tau * step + q_ops + 6) + 2 * n_normals
    return float(ops + (n_normals * OPS_PER_NORMAL if prng else 0))


def auv_solve_ops(consts, dyn, k: int, tau: int, prng: bool,
                  costs_only: bool = False) -> float:
    """Operations of one fused AUV solve, counted from auv_mppi.cu with the
    nonzeros of this run's matrices (FMA = 2; acos, rsqrt counted as 10 and
    1): a state_dot is the rotation (36), pose rates (18), quaternion rates
    (24), damping (2 nnz(L) + 2 nnz(L_fwd) + 36), M nu (2 nnz(M)), three
    cross products and their sums (36), restoring forces (24 + 2 nnz(cog)
    + 2 nnz(cob)), the force sum (6) and M^-1 rhs (2 nnz(M^-1)); a step adds
    the generalised force, rk stages, the quaternion norm, the state cost
    (the 10-dim quadratic; twice for "waypoints_quat", with |dot| and the
    blend; ``ELIPSE3D_OPS`` for "elipse3d") and the action-cost terms."""
    m_tot = dyn[:36].cpu().numpy()
    inv_m = dyn[36:72].cpu().numpy()
    sd = (36 + 18 + 24 + 2 * nnz(consts.lin_damp)
          + 2 * nnz(consts.lin_damp_fwd) + 36 + 2 * nnz(m_tot) + 36
          + 24 + 2 * nnz(consts.cog) + 2 * nnz(consts.cob) + 6
          + 2 * nnz(inv_m))
    stages = {1: sd + 26, 2: 2 * sd + 26 + 39, 4: 4 * sd + 3 * 52 + 39}
    q_ops = {"static_quat": 3 + 7 + 2 + 10 + 2 + 6 + 2 * nnz(consts.Q) + 20,
             "waypoints_quat": 2 * (3 + 7 + 3 + 10 + 2 + 6
                                    + 2 * nnz(consts.Q) + 20) + 3,
             "elipse3d": ELIPSE3D_OPS}[consts.cost_kind]
    step = (6 + 2 * nnz(consts.scale) + stages[consts.rk] + 13 + q_ops
            + 12 + 2 * nnz(consts.Mz) + 12 + 2)
    return _rollout_ops(k, tau, 6, step, q_ops, prng, costs_only)


def nn_solve_ops(consts, k: int, tau: int, prng: bool,
                 costs_only: bool = False) -> float:
    """Operations of one fused NN solve, counted from nn_mppi.cu (FMA = 2;
    acos, rsqrt as 10 and 1): a step is the action u = useq + scale z, the
    MLP (2 fan_in fan_out a layer, a ReLU per hidden unit), the delta, the
    quaternion renormalisation, the 10-dim cost and the action-cost
    terms."""
    sizes = consts.sizes
    mlp = sum(2 * i * o for i, o in zip(sizes[:-1], sizes[1:])) + sum(
        sizes[1:-1])
    q_ops = 3 + 7 + 2 + 10 + 2 + 6 + 2 * nnz(consts.Q) + 20
    step = (6 + 2 * nnz(consts.scale) + mlp + 13
            + (12 if consts.renorm else 0) + q_ops + 12 + 2 * nnz(consts.Mz)
            + 12 + 2)
    return _rollout_ops(k, tau, 6, step, q_ops, prng, costs_only)


def weights_ops(k: int, n_z: int, prng: bool) -> float:
    """Phase B: the bounded exponent (4 a sample), one noise pass and the
    w*z reduction (2 a normal)."""
    return float(k * 4 + k * n_z * (2 + (OPS_PER_NORMAL if prng else 0)))


def bound_ms(n_bytes: float, ops: float):
    t_b, t_o = n_bytes / PEAK_BYTES, ops / PEAK_OPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def check_solve(pm, fused, z, label: str) -> dict:
    """Kernel solve + merge against the plain versions on injected z."""
    k, tau = fused.k, fused.tau
    rng = np.random.default_rng(7)
    x0 = torch.zeros(6, device="cuda")
    useq = torch.as_tensor(0.1 * rng.standard_normal((tau, 3)),
                           dtype=torch.float32, device="cuda")
    dyn = fused.pack_dyn(x0, useq)
    part_k = pm.pm_fused_solve(fused.consts, dyn, k, tau, z=z)
    zsum_k, st_k = pm.pm_merge(part_k)
    part_p = pm.fused_solve_plain(fused.consts, dyn, k, tau, z=z)
    zsum_p, st_p = pm.merge_plain(part_p)
    torch.cuda.synchronize()

    def wn(zsum, st):
        return fused.unfold_wnoise(zsum) / st[1]

    out = {"k": k, "tau": tau}
    # end to end: kernel solve + kernel merge vs plain solve + plain merge
    ok, err, ratio = close(wn(zsum_k, st_k), wn(zsum_p, st_p), 1e-3, 1e-5)
    out.update(wnoise_ok=ok, wnoise_max_abs_err=err, wnoise_ratio=ratio,
               wnoise_rtol=1e-3, wnoise_atol=1e-5)
    stats_ok = True
    for name, i_k, i_p in (("cost_min", 2, 2), ("cost_max", 3, 3),
                           ("cost_mean", 4, 4)):
        a, b = st_k[i_k].item(), st_p[i_p].item()
        rel = abs(a - b) / max(abs(b), 1e-30)
        out[f"{name}_rel_err"] = rel
        stats_ok &= rel <= 1e-4
    out.update(cost_stats_ok=stats_ok, cost_stats_rtol=1e-4)
    # the solve kernel alone: both partials merged by the plain merge
    zs, st = pm.merge_plain(part_k)
    ok_s, err_s, _ = close(wn(zs, st), wn(zsum_p, st_p), 1e-3, 1e-5)
    # the merge kernel alone: same (plain) partials on both sides, compared
    # as (zsum / l, m, l, min, max, sum)
    zm, stm = pm.pm_merge(part_p)
    ok_m, err_m, _ = close(torch.cat([zm / stm[1], stm[:5]]),
                           torch.cat([zsum_p / st_p[1], st_p[:5]]),
                           1e-5, 1e-6)
    out.update(solve_only_ok=ok_s, solve_only_max_abs_err=err_s,
               merge_only_ok=ok_m, merge_only_max_abs_err=err_m,
               merge_rtol=1e-5, merge_atol=1e-6)
    emit(f"kernel_vs_plain_{label}", **out)
    if not (out["wnoise_ok"] and stats_ok and ok_s and ok_m):
        raise AssertionError(f"kernel disagrees with its plain version "
                             f"({label}): {out}")
    return out


def noise_phase(pm, seed: int, solve: int) -> dict:
    """Dump against the plain Philox, then the stream's statistics."""
    pm.reset_launch_counts()
    z = pm.pm_noise_dump(seed, solve, K, H, 3, "cuda")
    z2 = pm.pm_noise_dump(seed, solve + 1, K, H, 3, "cuda")
    launches = pm.launch_counts["pm_noise_dump"]
    n_cmp = min(4096, K)
    zp = pm.noise_plain(seed, solve, n_cmp, H, 3, device="cuda")
    err = (z[..., :n_cmp] - zp).abs().max().item()

    zd = z.double()
    n = zd.numel()

    def corr(a, b):
        a, b = a - a.mean(), b - b.mean()
        return ((a * b).sum() / torch.sqrt((a * a).sum() * (b * b).sum())
                ).item()

    s = {
        "mean": zd.mean().item(),
        "var": zd.var().item(),
        "m4": (zd ** 4).mean().item(),
        "tail_3sigma": (zd.abs() > 3.0).double().mean().item(),
        "corr_step": corr(zd[:-1], zd[1:]),
        "corr_dim": corr(zd[:, :-1], zd[:, 1:]),
        "corr_sample": corr(zd[..., :-1], zd[..., 1:]),
        "corr_solve": corr(zd, z2.double()),
    }
    checks = {
        "dump_vs_plain": err <= 1e-5,
        "mean": abs(s["mean"]) < 6 * n ** -0.5,
        "var": abs(s["var"] - 1.0) < 6 * (2.0 / n) ** 0.5,
        # sample 4th moment of N(0,1): mean 3, variance 105 - 9 = 96
        "m4": abs(s["m4"] - 3.0) < 6 * (96.0 / n) ** 0.5,
        "tail_3sigma": abs(s["tail_3sigma"] - 0.0027) < 6e-4,
        **{c: abs(s[c]) < 3e-3 for c in ("corr_step", "corr_dim",
                                         "corr_sample", "corr_solve")},
    }
    failed = sorted(c for c, v in checks.items() if not v)
    emit("noise", n_normals=n, dump_vs_plain_max_abs_err=err,
         launches=launches, failed=failed, **s)
    if failed:
        raise AssertionError(f"noise check failed: {failed}")
    return {"max_abs_err": err, "launches": launches}


def pm_controller(kernel: str = "auto", normalize: bool = False,
                  tau: int = H, dmd: bool = False, **extra):
    """The point-mass workload's controller (``dmd``: the DMD row's, a
    DMDMPPI) through get_controller at K and horizon ``tau``, with
    env-config keys ``extra``."""
    from mppi_tf_tpu_torch.controller import get_controller

    model, cost = workload("cuda", dmd)
    cfg = {"samples": K, "horizon": tau, "lambda": LAM, "upsilon": UPSILON,
           "noise": SIGMA.tolist(), "kernel": kernel,
           "normalize": normalize, **extra}
    return get_controller(model, cost, cfg)


def closed_loop(kernel: str, normalize: bool = False,
                steps: int = LOOP_STEPS, tau: int = H, errs=None,
                dmd: bool = False, **extra):
    """K=100k closed loop (H=50, or ``tau``) through the factories against
    the analytic plant, with env-config keys ``extra`` ("noise-schedule",
    "antithetic"); returns (controller, final goal error, per-step host
    ms, launch counts), and appends each step's goal error to ``errs``
    when given."""
    from mppi_tf_tpu_torch.envs import PointMassEnv
    from mppi_tf_tpu_torch.kernels import pm_mppi as pm

    ctrl = pm_controller(kernel, normalize, tau, dmd, **extra)
    ctrl.trace()  # builds and warms up; restores the controller's state
    env = PointMassEnv(n_dof=3, mass=MASS, dt=DT)
    x = env.reset()
    step_ms = []
    pm.reset_launch_counts()
    for _ in range(steps):
        t0 = time.perf_counter()
        u = ctrl.next(x)  # returns a host array: ends in a sync
        step_ms.append((time.perf_counter() - t0) * 1e3)
        x = env.step(u)
        if errs is not None:
            errs.append(float(np.linalg.norm(x.ravel() - np.asarray(GOAL))))
    counts = dict(pm.launch_counts)
    err = float(np.linalg.norm(x.ravel() - np.asarray(GOAL)))
    return ctrl, err, step_ms, counts


def profile_steps(ctrl, steps: int = 20, x=None, radius=None) -> dict:
    """Where a step's time goes: ``profile_run`` over ``steps`` calls of
    MPPI.next at state ``x`` (default zeros), each followed by
    ``advance_waypoints(x, radius)`` when a radius is given."""
    x = np.zeros(6) if x is None else x
    ctrl.next(x)
    torch.cuda.synchronize()
    pops = []

    def run():
        for _ in range(steps):
            ctrl.next(x)
            if radius is not None:
                pops.append(ctrl.advance_waypoints(x, radius))

    return dict(profile_run(run, steps), pops=sum(pops))


def profile_run(run, steps: int) -> dict:
    """``torch.profiler`` over ``run()``, ``steps`` control steps: device
    busy share = summed kernel time / wall time (one stream, so kernels do
    not overlap); synchronising CUDA runtime calls per step (the action's
    copy to the host is one)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    kern = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    syncs = {e.key: e.count / steps for e in events
             if e.device_type == DeviceType.CPU and "Synchronize" in e.key}
    return {
        "steps": steps, "wall_us_per_step": wall_us / steps,
        "device_us_per_step": dev_us / steps,
        "device_busy_share": dev_us / wall_us,
        "kernel_launches_per_step": sum(e.count for e in kern) / steps,
        "syncs_per_step": syncs,
        "top_kernels_us_per_step": {
            e.key[:60]: e.self_device_time_total / steps for e in top},
    }


def rest_state() -> np.ndarray:
    """The AUV at rest at the surface, unit quaternion qw = 1."""
    x = np.zeros(13)
    x[6] = 1.0
    return x


def auv_modules(device, task, sigma, lam=AUV_LAM, rk=2):
    from mppi_tf_tpu_torch import flagship
    from mppi_tf_tpu_torch.costs import get_cost
    from mppi_tf_tpu_torch.models import get_model

    model = get_model({**flagship.auv_params(), "rk": rk}, dt=0.1,
                      device=device)
    cost = get_cost(task, lam=lam, gamma=AUV_GAMMA, upsilon=AUV_UPSILON,
                    sigma=sigma, device=device)
    return model, cost


def auv_fused(k, tau, rk=2, sigma=AUV_SIGMA, **opts):
    from mppi_tf_tpu_torch import flagship
    from mppi_tf_tpu_torch.kernels import auv_mppi as auv

    model, cost = auv_modules("cuda", flagship.auv_task(), sigma, rk=rk)
    return auv.FusedAUVMPPI(model, cost, k=k, tau=tau, lam=AUV_LAM,
                            upsilon=AUV_UPSILON, sigma=sigma, **opts)


def auv_dyn(fused, useq_scale: float, seed: int, x0=None):
    rng = np.random.default_rng(seed)
    x0 = torch.as_tensor(rest_state() if x0 is None else x0,
                         dtype=torch.float32, device="cuda")
    useq = torch.as_tensor(useq_scale * rng.standard_normal((fused.tau, 6)),
                           dtype=torch.float32, device="cuda")
    with torch.no_grad():
        return fused.pack_dyn(x0, useq)


def quat_kernels(module, prefix: str) -> SimpleNamespace:
    """The fused solve, its costs mode and their plain versions of a
    13-state / 6-action kernel module (kernels/auv_mppi.py, nn_mppi.py)."""
    return SimpleNamespace(
        solve=getattr(module, f"{prefix}_fused_solve"),
        costs=getattr(module, f"{prefix}_fused_costs"),
        sample_costs_plain=module.sample_costs_plain,
        fused_solve_plain=module.fused_solve_plain,
        fused_costs_plain=module.fused_costs_plain, phase=prefix)


def check_auv(kern, pm, fused, z, label: str, useq_scale: float,
              x0=None, end_to_end: bool = False) -> dict:
    """The AUV or NN kernels (``quat_kernels``) against their plain
    versions on injected z: per-sample costs (phase A) and their merged
    stats; the fused rows' merged cost stats against the plain costs (every
    sample's rollout) and their softmax (m, l, zsum / l) against
    block_partials of the kernel's own costs (the softmax apart from the
    rollout); with ``end_to_end`` the whole solve's wnoise, beside its
    first-order reading from the cost errors."""
    k, tau, c = fused.k, fused.tau, fused.consts
    dyn = auv_dyn(fused, useq_scale, seed=11, x0=x0)
    costs_k, rows_k = kern.costs(c, dyn, k, tau, z=z)
    costs_p = kern.sample_costs_plain(c, dyn, z)
    _, st_k = pm.pm_merge(rows_k)
    part_k = kern.solve(c, dyn, k, tau, z=z)
    part_o = pm.block_partials(costs_k, z.reshape(tau * 6, k), c.lam)
    torch.cuda.synchronize()
    out = {"k": k, "tau": tau, "rk": getattr(c, "rk", None),
           "hidden": getattr(c, "hidden", None), "cost_rtol": COST_RTOL,
           "cost_atol": COST_ATOL}
    ok_c, err_c, ratio_c = close(costs_k, costs_p, COST_RTOL, COST_ATOL)
    out.update(costs_ok=ok_c, costs_max_abs_err=err_c, costs_ratio=ratio_c,
               costs_max_rel_err=((costs_k.double() - costs_p.double()).abs()
                                  / costs_p.double().abs()).max().item())
    ref = torch.stack([costs_p.min(), costs_p.max(), costs_p.sum()])
    stats_rel = ((st_k[2:5] - ref).abs() / ref.abs()).max().item()
    out.update(cost_stats_max_rel_err=stats_rel, cost_stats_rtol=1e-4)
    zs_k, sk = pm.merge_plain(part_k)
    zs_o, so = pm.merge_plain(part_o)
    # the fused rows carry every sample's cost: their merged min, max and
    # sum against the plain costs (rtol 1e-4, as phase A's); the abs error
    # is taken over (min, max, mean)
    f_rel = ((sk[2:5] - ref).abs() / ref.abs()).max().item()
    f_abs = (torch.stack([sk[2], sk[3], sk[4] / k]).double()
             - torch.stack([ref[0], ref[1], ref[2] / k]).double()
             ).abs().max().item()
    out.update(fused_cost_stats_max_rel_err=f_rel,
               fused_cost_stats_max_abs_err=f_abs)
    # the fused softmax against block_partials of the kernel's own costs:
    # m, l and the weighted normals zsum / l in units of z (not of sigma z),
    # rtol 1e-3 (summation order of the block sums)
    ok_w, err_w, _ = close(zs_k / sk[1], zs_o / so[1], 1e-3, 1e-5)
    m_rel = abs(sk[0].item() - so[0].item()) / abs(so[0].item())
    l_rel = abs(sk[1].item() - so[1].item()) / so[1].item()
    out.update(fused_vs_own_costs_ok=ok_w, fused_max_abs_err=err_w,
               fused_m_rel_err=m_rel, fused_l_rel_err=l_rel,
               fused_rtol=1e-3, fused_atol=1e-5)
    ok = (ok_c and stats_rel <= 1e-4 and f_rel <= 1e-4 and ok_w
          and m_rel <= 1e-6 and l_rel <= 1e-3)
    if end_to_end:
        # the cost error moves each exponent by up to its size / lam
        # (~0.01 here), so each weight by ~1%: rtol 1e-2, atol 1e-3
        zs_p, sp = pm.merge_plain(kern.fused_solve_plain(c, dyn, k, tau,
                                                         z=z))
        ok_e, err_e, _ = close(zs_k / sk[1], zs_p / sp[1], 1e-2, 1e-3)
        # first-order reading: the exponent errors d = (c_kernel -
        # c_plain) / lam move the weights p by p (mean_p(d) - d), hence
        # wnoise by sum_k p_k (mean_p(d) - d_k) z_k; ess = 1 / sum p^2
        p = torch.softmax(-costs_p.double() / c.lam, 0)
        d = (costs_k.double() - costs_p.double()) / c.lam
        pred = ((p * ((p * d).sum() - d))
                @ z.reshape(tau * 6, k).double().T).abs().max().item()
        out.update(wnoise_ok=ok_e, wnoise_max_abs_err=err_e,
                   wnoise_rtol=1e-2, wnoise_atol=1e-3,
                   wnoise_first_order=pred,
                   exponent_err_max=d.abs().max().item(),
                   ess=(1.0 / (p * p).sum()).item())
        ok &= ok_e
    emit(f"{kern.phase}_kernels_vs_plain_{label}", **out)
    if not ok:
        raise AssertionError(f"{kern.phase} kernel disagrees with its plain "
                             f"version ({label}): {out}")
    return out


def check_weights(pm, fused, label: str) -> dict:
    """mppi_weights + pm_merge against the plain version on phase-A costs
    of this solve object (Philox noise), and the normalized wnoise of the
    kernels' two-phase solve against the plain two-phase solve on the
    kernels' own costs."""
    k, tau, adim = fused.k, fused.tau, fused.adim
    x0 = torch.as_tensor(rest_state() if adim == 6 else np.zeros(6),
                         dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(12)
    useq = torch.as_tensor((200.0 if adim == 6 else 0.1)
                           * rng.standard_normal((tau, adim)),
                           dtype=torch.float32, device="cuda")
    with torch.no_grad():
        dyn = fused.pack_dyn(x0, useq)
    costs, rows = fused._costs(dyn, 21, 4, None)
    _, st = pm.pm_merge(rows)
    beta, cmax = st[2], st[3]
    nrm = torch.stack([beta, 1.0 / ((cmax - beta) * fused.lam)])
    anti = fused.antithetic
    part_k = pm.mppi_weights(nrm, costs, tau, adim, seed=21, solve=4,
                             antithetic=anti)
    part_p = pm.weights_plain(nrm, costs, tau, adim, seed=21, solve=4,
                              antithetic=anti)
    zs_k, st_k = pm.pm_merge(part_k)
    zs_p, st_p = pm.merge_plain(part_p)
    wn_k = fused.unfold_wnoise(zs_k) / st_k[1]
    wn_p = fused.unfold_wnoise(zs_p) / st_p[1]
    # the kernels' two-phase solve through the solve object, against the
    # plain phase B over the same kernel costs
    wn_s, info = fused.solve(x0, useq, seed=21, solve=4, normalize=True)
    torch.cuda.synchronize()
    scale = float(fused._scale.abs().max())
    ok_w, err_w, ratio = close(wn_k, wn_p, 1e-4, 1e-6 * scale)
    ok_s, err_s, _ = close(wn_s, wn_p, 1e-4, 1e-6 * scale)
    l_rel = abs(st_k[1].item() - st_p[1].item()) / st_p[1].item()
    out = {"k": k, "tau": tau, "adim": adim, "antithetic": anti,
           "wnoise_ok": ok_w,
           "wnoise_max_abs_err": err_w, "wnoise_ratio": ratio,
           "solve_wnoise_ok": ok_s, "solve_wnoise_max_abs_err": err_s,
           "l_rel_err": l_rel, "rtol": 1e-4, "atol": 1e-6 * scale,
           "nabla": info["nabla"].item(), "l_bounds": [
               k * float(np.exp(-1.0 / fused.lam)), k]}
    emit(f"weights_vs_plain_{label}", **out)
    if not (ok_w and ok_s and l_rel <= 1e-5):
        raise AssertionError(f"mppi_weights disagrees with its plain "
                             f"version ({label}): {out}")
    return out


def auv_loop(kernel: str, normalize: bool, steps: int, k: int = AUV_K,
             **opts):
    """AUV closed loop through MPPI.next against the analytic plant (rest
    start), with MPPI keywords ``opts``. Normalized: the dive to z = -1;
    unnormalized: the flagship task (z = -5, sigma = 1500 I). Returns
    (controller, states, host ms per step, launch counts)."""
    from mppi_tf_tpu_torch import flagship
    from mppi_tf_tpu_torch.controller import MPPI
    from mppi_tf_tpu_torch.envs import AUVEnv
    from mppi_tf_tpu_torch.kernels import pm_mppi as pm

    if normalize:
        goal = np.zeros(13)
        goal[[2, 6]] = [-1.0, 1.0]
        task = {"type": "static_quat", "diag": True, "goal": goal.tolist(),
                "Q": DIVE_Q}
        sigma = DIVE_SIGMA
    else:
        task, sigma = flagship.auv_task(), AUV_SIGMA
    model, cost = auv_modules("cuda", task, sigma)
    ctrl = MPPI(model, cost, k=k, tau=AUV_H, lam=AUV_LAM,
                upsilon=AUV_UPSILON, sigma=sigma, seed=3,
                normalize_cost=normalize, kernel=kernel, **opts)
    x0 = torch.as_tensor(rest_state(), dtype=torch.float32, device="cuda")
    if ctrl.kernel_path == "cuda":   # warm-up without touching its state
        ctrl._fused.solve(x0, ctrl.useq, normalize=normalize)
    else:
        ctrl._solve(x0, ctrl.useq)
    torch.cuda.synchronize()
    env = AUVEnv(flagship.auv_params(), dt=0.02)
    x = env.reset()
    states, step_ms = [], []
    pm.reset_launch_counts()
    for _ in range(steps):
        t0 = time.perf_counter()
        u = ctrl.next(x)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        for _ in range(DIVE_SUBSTEPS):
            x = env.step(u)
        states.append(x.ravel())
    return ctrl, np.asarray(states), step_ms, dict(pm.launch_counts)


def trained_normalisers(model, sigma) -> None:
    """Normalisers a trained model would have: the quaternion features
    around qw = 0.9, velocities of O(0.5), the action features scaled by
    sigma, and y_std that keeps the deltas at O(0.01-0.1)."""
    x_mean = np.zeros(16)
    x_mean[3] = 0.9
    x_std = np.concatenate([[0.3] * 4, [0.5] * 6, np.diag(sigma)])
    y_std = np.array([0.05] * 3 + [0.01] * 4 + [0.05] * 6)
    model.set_normalization(x_mean, x_std, np.zeros(13), y_std)


def nn_fused(k, tau, hidden=(32, 32, 32), sigma=AUV_SIGMA, **opts):
    """FusedNNMPPI over an NNAUVModel with He weights from a seed and
    trained normalisers, and the flagship StaticQuatCost task."""
    from mppi_tf_tpu_torch import flagship
    from mppi_tf_tpu_torch.costs import get_cost
    from mppi_tf_tpu_torch.kernels.nn_mppi import FusedNNMPPI
    from mppi_tf_tpu_torch.models.nn import NNAUVModel

    model = NNAUVModel(hidden=hidden, seed=17, device="cuda")
    trained_normalisers(model, sigma)
    cost = get_cost(flagship.auv_task(), lam=AUV_LAM, gamma=AUV_GAMMA,
                    upsilon=AUV_UPSILON, sigma=sigma, device="cuda")
    return FusedNNMPPI(model, cost, k=k, tau=tau, lam=AUV_LAM,
                       upsilon=AUV_UPSILON, sigma=sigma, **opts)


def nn_loop(kernel: str, normalize: bool, steps: int = NN_LOOP_STEPS,
            k: int = NN_K, **opts):
    """The known-plant dive through MPPI.next, with MPPI keywords
    ``opts``: the controller's NNAUVModel and the f64 CPU plant are the
    same network (``known_plant_params``). Returns (controller, states,
    host ms per step, launch counts)."""
    from mppi_tf_tpu_torch.controller import MPPI
    from mppi_tf_tpu_torch.costs import get_cost
    from mppi_tf_tpu_torch.interop import from_jax_params
    from mppi_tf_tpu_torch.kernels import pm_mppi as pm
    from mppi_tf_tpu_torch.models.nn import NNAUVModel

    params = known_plant_params()
    model = NNAUVModel(device="cuda")
    plant = NNAUVModel(dtype=torch.float64)
    for m in (model, plant):
        from_jax_params(params, None, m)
    cost = get_cost(known_plant_task(), lam=AUV_LAM, gamma=AUV_GAMMA,
                    upsilon=AUV_UPSILON, sigma=NN_LOOP_SIGMA, device="cuda")
    ctrl = MPPI(model, cost, k=k, tau=NN_H, lam=AUV_LAM, upsilon=AUV_UPSILON,
                sigma=NN_LOOP_SIGMA, seed=3, normalize_cost=normalize,
                kernel=kernel, device="cuda", **opts)
    x0 = torch.as_tensor(rest_state(), dtype=torch.float32, device="cuda")
    if ctrl.kernel_path == "cuda":   # warm-up without touching its state
        ctrl._fused.solve(x0, ctrl.useq, normalize=normalize)
    else:
        ctrl._solve(x0, ctrl.useq)
    torch.cuda.synchronize()
    x = rest_state()
    states, step_ms = [], []
    pm.reset_launch_counts()
    for _ in range(steps):
        t0 = time.perf_counter()
        u = ctrl.next(x)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        with torch.no_grad():
            x = plant.predict(torch.tensor(x), torch.tensor(
                u, dtype=torch.float64)).numpy()
        states.append(x)
    return ctrl, np.asarray(states), step_ms, dict(pm.launch_counts)


def run_cli(workdir: str, name: str, env: dict, task: str, model: str,
            steps: int, *flags):
    """``mppi_tf_tpu_torch.cli.main`` in-process on the card (no --cpu)
    with the env config ``env`` written to ``workdir`` and the extra
    ``flags``: (its JSON summary, the launch counts of the run)."""
    import contextlib
    import io

    from mppi_tf_tpu_torch import cli
    from mppi_tf_tpu_torch.cfg import write_config
    from mppi_tf_tpu_torch.kernels import pm_mppi as pm

    path = write_config(env, os.path.join(workdir, f"{name}.yaml"))
    out = io.StringIO()
    pm.reset_launch_counts()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["--config", path, "--task", task, "--model", model,
                       "-s", str(steps), *flags])
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"cli {name} returned {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1]), dict(
        pm.launch_counts)


def check_syncs(prof: dict) -> None:
    """One synchronising copy a step (the action's); the profiler itself
    makes one cudaDeviceSynchronize per window."""
    syncs = prof["syncs_per_step"]
    if not (syncs.get("cudaStreamSynchronize", 0.0) <= 1.0
            and syncs.get("cudaDeviceSynchronize", 0.0) * prof["steps"]
            <= 1.0):
        raise AssertionError(f"more than the action copy syncs a step: "
                             f"{syncs}")


def mission_profile(ctrl, x, label: str, smi: str) -> dict:
    """The step profile of a mission in flight: a queue of 22 copies of the
    state ``x`` pops on each of the 21 steps (warm-up included), so every
    step uploads a new queue; held to one sync a step."""
    ctrl.set_waypoints([np.ravel(x)] * 22)
    prof = profile_steps(ctrl, x=x, radius=0.1)
    emit("profile", kernel_path=ctrl.kernel_path, model=label,
         mission=True, card=smi, **prof)
    check_syncs(prof)
    if prof["pops"] != prof["steps"]:
        raise AssertionError(f"mission profile popped {prof['pops']} times")
    return prof


def pm_env(sdim: int = 6, **over) -> dict:
    """envs/point_mass at K, H (2-DoF for the ellipse)."""
    from mppi_tf_tpu_torch.cfg import default_config

    env = dict(default_config("envs/point_mass"), samples=K, horizon=H)
    if sdim == 4:
        env.update(EL_PATCH)
    return dict(env, **over)


def tracking_fused(env: dict, task, model_name: str, k: int, tau: int):
    """(model, cost, fused solve object) of a config triple on the card;
    ``task`` is a bundled name or a dict."""
    from mppi_tf_tpu_torch.cfg import default_config
    from mppi_tf_tpu_torch.envs.runner import build_model_and_cost
    from mppi_tf_tpu_torch.kernels.auv_mppi import FusedAUVMPPI
    from mppi_tf_tpu_torch.kernels.pm_mppi import FusedPointMassMPPI

    task = default_config(task) if isinstance(task, str) else task
    model, cost, sigma = build_model_and_cost(
        env, task, default_config(model_name), device="cuda")
    cls = FusedAUVMPPI if model.get_state_dim() == 13 else FusedPointMassMPPI
    return model, cost, cls(model, cost, k=k, tau=tau, lam=env["lambda"],
                            upsilon=env["upsilon"], sigma=sigma)


def check_pm_tracking(pm, fused, z, x0, label: str) -> dict:
    """A point-mass tracking variant against its plain version on injected
    z: per-sample costs (pm_fused_costs), the fused solve through the
    solve object (pm_fused_solve + pm_merge, stats with the waypoint offset
    added back) against the plain solve plus the same offset, and the
    normalized two-phase solve (pm_fused_costs, mppi_weights, merges)
    against the plain phases."""
    k, tau, adim, c = fused.k, fused.tau, fused.adim, fused.consts
    rng = np.random.default_rng(7)
    x0 = torch.as_tensor(x0, dtype=torch.float32, device="cuda")
    useq = torch.as_tensor(0.1 * rng.standard_normal((tau, adim)),
                           dtype=torch.float32, device="cuda")
    dyn = fused.pack_dyn(x0, useq)
    costs_k, _ = pm.pm_fused_costs(c, dyn, k, tau, z=z)
    costs_p = pm.sample_costs_plain(c, dyn, z)
    wn_k, info_k = fused.solve(x0, useq, z=z)
    zs_p, st_p = pm.merge_plain(pm.fused_solve_plain(c, dyn, k, tau, z=z))
    cst_p = fused._with_offset(st_p)
    wn_p = fused.unfold_wnoise(zs_p) / st_p[1]
    wn_kn, info_kn = fused.solve(x0, useq, z=z, normalize=True)
    cp_off, cst_pn = fused._with_offset(pm.merge_plain(
        pm.cost_partials(costs_p))[1], costs_p)
    nrm = torch.stack([cst_pn["cost_min"], 1.0 / (
        (cst_pn["cost_max"] - cst_pn["cost_min"]) * fused.lam)])
    zs_pn, st_pn = pm.merge_plain(pm.weights_plain(nrm, cp_off, tau, adim,
                                                   z=z))
    wn_pn = fused.unfold_wnoise(zs_pn) / st_pn[1]
    torch.cuda.synchronize()
    off = fused._cost_offset()
    out = {"k": k, "tau": tau, "cost_kind": c.cost_kind,
           "offset": None if off is None else off.item(),
           "cost_rtol": PM_COST_RTOL, "cost_atol": PM_COST_ATOL}
    ok_c, err_c, _ = close(costs_k, costs_p, PM_COST_RTOL, PM_COST_ATOL)
    ok_w, err_w, _ = close(wn_k, wn_p, 1e-3, 1e-5)
    scale = float(fused._scale.abs().max())
    ok_n, err_n, _ = close(wn_kn, wn_pn, 1e-4, 1e-6 * scale)
    rel = 0.0
    for info, cst, n in ((info_k, cst_p, k), (info_kn, cst_pn, k)):
        for key, ref in (("cost_min", cst["cost_min"]),
                         ("cost_max", cst["cost_max"]),
                         ("cost_mean", cst["cost_sum"] / n)):
            rel = max(rel, abs(info[key].item() - ref.item())
                      / max(abs(ref.item()), 1e-30))
    out.update(costs_ok=ok_c, costs_max_abs_err=err_c, wnoise_ok=ok_w,
               wnoise_max_abs_err=err_w, wnoise_rtol=1e-3, wnoise_atol=1e-5,
               normalized_wnoise_ok=ok_n, normalized_max_abs_err=err_n,
               normalized_rtol=1e-4, normalized_atol=1e-6 * scale,
               stats_max_rel_err=rel, stats_rtol=1e-4)
    emit(f"pm_tracking_vs_plain_{label}", **out)
    if not (ok_c and ok_w and ok_n and rel <= 1e-4):
        raise AssertionError(f"point-mass tracking kernel disagrees with "
                             f"its plain version ({label}): {out}")
    return out


def elipse_errors(states) -> dict:
    """Mean radial error |(x/a)^2 + (y/b)^2 - 1| and speed error ||v| - 5|
    over the last 100 states of tasks/elipse_task (a 4, b 2), and the
    angle travelled around the ellipse."""
    tail = states[-100:]
    rad = np.abs((tail[:, 0] / 4.0) ** 2 + (tail[:, 2] / 2.0) ** 2 - 1.0)
    speed = np.abs(np.hypot(tail[:, 1], tail[:, 3]) - 5.0)
    ang = np.unwrap(np.arctan2(states[:, 2] / 2.0, states[:, 0] / 4.0))
    return {"radial_err": float(rad.mean()), "speed_err": float(speed.mean()),
            "angle": float(abs(ang[-1] - ang[0]))}


def elipse_loop(kernel: str, normalize: bool, steps: int):
    """The 2-DoF point mass on tasks/elipse_task from EL_X0 through
    MPPI.next at K, H. Returns (controller, states, host ms, counts)."""
    from mppi_tf_tpu_torch.controller import get_controller
    from mppi_tf_tpu_torch.envs import PointMassEnv
    from mppi_tf_tpu_torch.kernels import pm_mppi as pm

    env = pm_env(4, kernel=kernel, normalize=normalize)
    model, cost, _ = tracking_fused(env, "tasks/elipse_task",
                                    "models/point_mass_model", 8, 2)
    ctrl = get_controller(model, cost, env, seed=0)
    x0 = torch.as_tensor(EL_X0, dtype=torch.float32, device="cuda")
    if ctrl.kernel_path == "cuda":   # warm-up without touching its state
        ctrl._fused.solve(x0, ctrl.useq, normalize=normalize)
    else:
        ctrl._solve(x0, ctrl.useq)
    torch.cuda.synchronize()
    penv = PointMassEnv(n_dof=2, dt=DT)
    x = penv.reset(np.asarray(EL_X0))
    states, step_ms = [], []
    pm.reset_launch_counts()
    for _ in range(steps):
        t0 = time.perf_counter()
        u = ctrl.next(x)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        x = penv.step(u)
        states.append(np.ravel(x))
    return ctrl, np.asarray(states), step_ms, dict(pm.launch_counts)


def auv_mission_loop(steps: int = AUV_WP_STEPS):
    """The rexrov2 two-leg mission (z = -1, then z = -2) through MPPI.next
    and advance_waypoints on the normalized kernels, 5 AUVEnv substeps a
    step. Returns (controller, states, pop steps, host ms, counts)."""
    from mppi_tf_tpu_torch import flagship
    from mppi_tf_tpu_torch.controller import MPPI
    from mppi_tf_tpu_torch.envs import AUVEnv
    from mppi_tf_tpu_torch.kernels import pm_mppi as pm

    wps = [rest_state(), rest_state()]
    wps[0][2], wps[1][2] = -1.0, -2.0
    task = {"type": "waypoints_quat", "diag": True, "Q": DIVE_Q,
            "waypoints": [wps[0].tolist()], "alpha": 0.2}
    model, cost = auv_modules("cuda", task, DIVE_SIGMA)
    ctrl = MPPI(model, cost, k=AUV_K, tau=AUV_H, lam=AUV_LAM,
                upsilon=AUV_UPSILON, sigma=DIVE_SIGMA, seed=3,
                normalize_cost=True, kernel="auto")
    ctrl.set_waypoints(wps)
    x0 = torch.as_tensor(rest_state(), dtype=torch.float32, device="cuda")
    if ctrl.kernel_path == "cuda":   # warm-up without touching its state
        ctrl._fused.solve(x0, ctrl.useq, normalize=True)
    torch.cuda.synchronize()
    env = AUVEnv(flagship.auv_params(), dt=0.02)
    x = env.reset()
    states, pops, step_ms = [], [], []
    pm.reset_launch_counts()
    for step in range(steps):
        t0 = time.perf_counter()
        u = ctrl.next(x)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        for _ in range(DIVE_SUBSTEPS):
            x = env.step(u)
        if ctrl.advance_waypoints(x, AUV_WP_RADIUS):
            pops.append(step)
        states.append(x.ravel())
    return ctrl, np.asarray(states), pops, step_ms, dict(pm.launch_counts)


def rel_err(va, vb) -> float:
    return ((va - vb).abs().max() / vb.abs().max()).item()


def merged(pm, part) -> torch.Tensor:
    """(zsum / l, m, l, cost min, max, sum) of block rows, by pm_merge."""
    zsum, st = pm.pm_merge(part)
    return torch.cat([zsum / st[1], st[:5]])


def check_pm_variant(pm, fused, z, label: str, x0=None) -> dict:
    """A point-mass solve object's variant (scheduled, antithetic and / or
    dynamic_ab) of pm_fused_solve and pm_fused_costs against their plain
    versions on injected z and on the Philox stream from state ``x0``
    (default zeros), with the tolerances of row 1: per-sample costs
    (PM_COST_RTOL, PM_COST_ATOL), the merged cost stats (rel 1e-4) and the
    weighted noise in action units, c_t applied (rtol 1e-3, atol 1e-5)."""
    k, tau, c = fused.k, fused.tau, fused.consts
    rng = np.random.default_rng(7)
    useq = torch.as_tensor(0.1 * rng.standard_normal((tau, fused.adim)),
                           dtype=torch.float32, device="cuda")
    x0 = torch.as_tensor(np.zeros(fused.sdim) if x0 is None else x0,
                         dtype=torch.float32, device="cuda")
    dyn = fused.pack_dyn(x0, useq)
    out = {"k": k, "tau": tau, "cost_kind": c.cost_kind,
           "scheduled": c.scheduled, "antithetic": c.antithetic,
           "dynamic_ab": c.dynamic_ab, "cost_rtol": PM_COST_RTOL,
           "cost_atol": PM_COST_ATOL, "wnoise_rtol": 1e-3,
           "wnoise_atol": 1e-5, "stats_rtol": 1e-4}
    ok = True
    for src, kw in (("injected", {"z": z}), ("philox", {"seed": 9,
                                                        "solve": 2})):
        costs_k, _ = pm.pm_fused_costs(c, dyn, k, tau, **kw)
        costs_p, _ = pm.fused_costs_plain(c, dyn, k, tau, **kw)
        zs_k, st_k = pm.pm_merge(pm.pm_fused_solve(c, dyn, k, tau, **kw))
        zs_p, st_p = pm.merge_plain(pm.fused_solve_plain(c, dyn, k, tau,
                                                         **kw))
        torch.cuda.synchronize()
        ok_c, err_c, _ = close(costs_k, costs_p, PM_COST_RTOL, PM_COST_ATOL)
        ok_w, err_w, _ = close(fused.unfold_wnoise(zs_k) / st_k[1],
                               fused.unfold_wnoise(zs_p) / st_p[1], 1e-3,
                               1e-5)
        rel = ((st_k[2:5] - st_p[2:5]).abs() / st_p[2:5].abs()).max().item()
        out[src] = {"costs_ok": ok_c, "costs_max_abs_err": err_c,
                    "wnoise_ok": ok_w, "wnoise_max_abs_err": err_w,
                    "stats_max_rel_err": rel}
        ok &= ok_c and ok_w and rel <= 1e-4
    emit(f"pm_variant_vs_plain_{label}", ok=ok, **out)
    if not ok:
        raise AssertionError(f"point-mass variant disagrees with its plain "
                             f"version ({label}): {out}")
    return out


def antithetic_noise(pm, seed: int, solve: int) -> dict:
    """The antithetic dump at K, H (adim 3): every mirrored pair sums to
    exactly 0, the dump equals the plain mirrored stream, and the first
    half passes the noise phase's moment bounds."""
    pm.reset_launch_counts()
    half = pm.antithetic_half(K)
    z = pm.pm_noise_dump(seed, solve, K, H, 3, "cuda", half=half)
    launches = pm.launch_counts["pm_noise_dump"]
    pair_err = (z[..., half:] + z[..., :K - half]).abs().max().item()
    err = (z - pm.noise_plain(seed, solve, K, H, 3, device="cuda",
                              half=half)).abs().max().item()
    zd = z[..., :half].double()
    n = zd.numel()
    s = {"mean": zd.mean().item(), "var": zd.var().item(),
         "m4": (zd ** 4).mean().item(),
         "tail_3sigma": (zd.abs() > 3.0).double().mean().item()}
    checks = {
        "pair_sum_exactly_zero": pair_err == 0.0,
        "dump_vs_plain": err <= 1e-5,
        "mean": abs(s["mean"]) < 6 * n ** -0.5,
        "var": abs(s["var"] - 1.0) < 6 * (2.0 / n) ** 0.5,
        "m4": abs(s["m4"] - 3.0) < 6 * (96.0 / n) ** 0.5,
        "tail_3sigma": abs(s["tail_3sigma"] - 0.0027) < 6e-4}
    failed = sorted(c for c, v in checks.items() if not v)
    emit("antithetic_noise", k=K, tau=H, half=half, n_first_half=n,
         pair_max_abs_sum=pair_err, dump_vs_plain_max_abs_err=err,
         launches=launches, failed=failed, **s)
    if failed:
        raise AssertionError(f"antithetic noise check failed: {failed}")
    return {"max_abs_err": err, "launches": launches, "pair": pair_err}


def check_quat_prng(kern, pm, fused, label: str) -> dict:
    """An AUV or NN solve object's kernels with its options on the Philox
    stream: per-sample costs against the plain versions (COST_RTOL,
    COST_ATOL), and both kernels against themselves on the dumped
    (mirrored) stream, rel 1e-6."""
    k, tau, c = fused.k, fused.tau, fused.consts
    dyn = auv_dyn(fused, 200.0, seed=8)
    costs_k, _ = kern.costs(c, dyn, k, tau, seed=31, solve=5)
    costs_p, _ = kern.fused_costs_plain(c, dyn, k, tau, seed=31, solve=5)
    zd = pm.pm_noise_dump(31, 5, k, tau, 6, "cuda",
                          half=pm.antithetic_half(k, fused.antithetic))
    rels = {"costs": rel_err(costs_k, kern.costs(c, dyn, k, tau, z=zd)[0]),
            "fused": rel_err(merged(pm, kern.solve(c, dyn, k, tau, seed=31,
                                                   solve=5)),
                             merged(pm, kern.solve(c, dyn, k, tau, z=zd)))}
    torch.cuda.synchronize()
    ok_c, err_c, _ = close(costs_k, costs_p, COST_RTOL, COST_ATOL)
    out = {"k": k, "tau": tau, "scheduled": c.scheduled,
           "antithetic": c.antithetic, "costs_ok": ok_c,
           "costs_max_abs_err": err_c, "cost_rtol": COST_RTOL,
           "cost_atol": COST_ATOL, "prng_vs_dump_max_rel_err": rels,
           "prng_vs_dump_tol": 1e-6}
    emit(f"{kern.phase}_prng_vs_plain_{label}", **out)
    if not (ok_c and max(rels.values()) <= 1e-6):
        raise AssertionError(f"{kern.phase} Philox variant disagrees "
                             f"({label}): {out}")
    return out


def jsonl_tags(logdir: str) -> set:
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return {key for line in f for key in json.loads(line)
                if key != "step"}


def log_phase(pm, workdir: str) -> dict:
    """Log mode on the card: the CLI with -l on the bundled point-mass
    config, then LOG_STEPS point_mass_h100 steps through MPPI(observer=)
    with save(x, u, x_next) and the solve's program (dump_hlo) saved; both
    JSONL records hold the JAX observer's tag families (State/state is a
    histogram: in the JSONL where tensorboard is missing)."""
    from mppi_tf_tpu_torch.cfg import default_config
    from mppi_tf_tpu_torch.controller import MPPI
    from mppi_tf_tpu_torch.envs import PointMassEnv
    from mppi_tf_tpu_torch.observer import Observer
    from mppi_tf_tpu_torch.observer.observer import _summary_writer

    have_tb = _summary_writer() is not None
    out_cli, c_cli = run_cli(workdir, "point_mass_log",
                             default_config("envs/point_mass"),
                             "tasks/static_cost", "models/point_mass_model",
                             LOG_CLI_STEPS, "-l", "--log-dir",
                             os.path.join(workdir, "cli"))
    cli_tags = jsonl_tags(out_cli["logdir"])
    model, cost = workload("cuda")
    obs = Observer(os.path.join(workdir, "mppi"), use_tensorboard=False)
    ctrl = MPPI(model, cost, k=K, tau=H100, lam=LAM, upsilon=UPSILON,
                sigma=SIGMA, noise_schedule=SCHED, observer=obs, log=True,
                kernel="auto")
    env = PointMassEnv(n_dof=3, mass=MASS, dt=DT)
    x = env.reset()
    pm.reset_launch_counts()
    for _ in range(LOG_STEPS):
        u = ctrl.next(x)
        x_next = env.step(u)
        ctrl.save(x, u, x_next)
        x = x_next
    counts = dict(pm.launch_counts)
    hlo = ctrl.dump_hlo()
    obs.save_graph(hlo)
    obs.close()
    tags = jsonl_tags(obs.get_logdir())
    families = LOG_FAMILIES if not have_tb else LOG_FAMILIES[:3]
    missing = {
        "cli": [f for f in families if not any(t.startswith(f)
                                               for t in cli_tags)],
        "mppi": [f for f in LOG_FAMILIES + ("Predict/error",)
                 if not any(t.startswith(f) for t in tags)]}
    want_cli = {n: 0 for n in c_cli}
    want_cli.update(pm_fused_solve=LOG_CLI_STEPS, pm_fused_costs=LOG_CLI_STEPS,
                    pm_noise_dump=LOG_CLI_STEPS, pm_merge=2 * LOG_CLI_STEPS)
    want = {n: 0 for n in counts}
    want.update(pm_fused_solve=LOG_STEPS, pm_fused_costs=LOG_STEPS,
                pm_noise_dump=LOG_STEPS, pm_merge=2 * LOG_STEPS)
    out = {"have_tensorboard": have_tb, "cli": dict(out_cli, launches=c_cli),
           "cli_tags": sorted(cli_tags), "mppi_tags": sorted(tags),
           "mppi_launches": counts, "mppi_steps": LOG_STEPS,
           "observer_steps": obs.step, "missing": missing,
           "solve_hlo": hlo.splitlines()}
    emit("log", **out)
    if not (out_cli["kernel_path"] == "cuda" and c_cli == want_cli
            and ctrl.kernel_path == "cuda" and counts == want
            and obs.step == LOG_STEPS
            and not missing["cli"] and not missing["mppi"]
            and "pm_fused_solve x1" in hlo and "registers" in hlo):
        raise AssertionError(f"log mode: {out}")
    return out


def variant_times(base_fn, var_fn, plain_fn, reps: int = 200) -> dict:
    """ms per launch of a variant and of its unscheduled, non-antithetic
    counterpart, timed in turns (base, variant, variant, base) with CUDA
    events and then as the kernels' device time, and its plain version's
    ms."""
    b1, v1, v2, b2 = (cuda_ms(base_fn, reps), cuda_ms(var_fn, reps),
                      cuda_ms(var_fn, reps), cuda_ms(base_fn, reps))
    db1, dv1, dv2, db2 = (device_ms(base_fn), device_ms(var_fn),
                          device_ms(var_fn), device_ms(base_fn))
    return {"ms": 0.5 * (v1 + v2), "ms_runs": [v1, v2],
            "unvaried_ms": 0.5 * (b1 + b2), "unvaried_ms_runs": [b1, b2],
            "device_ms": 0.5 * (dv1 + dv2),
            "unvaried_device_ms": 0.5 * (db1 + db2),
            "plain_ms": cuda_ms(plain_fn, 3, 1)}


def mirror_saving(k: int, n_z: int) -> float:
    """The normals an antithetic solve of k samples need not draw: the
    mirrored k - ceil(k/2) samples' n_z each, at OPS_PER_NORMAL."""
    return (k - (k + 1) // 2) * n_z * OPS_PER_NORMAL


def sched_ops(k: int, tau: int, dims: int) -> float:
    """What the schedule adds to a solve: c_t times the noise drive of
    ``dims`` dimensions and times the z-quadratic, a sample and a step."""
    return float(k * tau * (dims + 1))


def pm_loop_phase(phase: str, normalize: bool, tau: int, tol=GOAL_TOL,
                  mean_tol=None, dmd: bool = False, **extra) -> tuple:
    """A LOOP_STEPS point-mass loop (``dmd``: the DMD row's) on the
    kernels with env-config keys ``extra``, held to its launches and gated
    on its final goal error (``tol``) or on the error's mean over the last
    SCHED_WINDOW steps (``mean_tol``): (controller, step ms, launch
    counts)."""
    t0 = time.perf_counter()
    errs = []
    ctrl, err, ms, counts = closed_loop("auto", normalize, tau=tau,
                                        errs=errs, dmd=dmd, **extra)
    window = np.asarray(errs[-SCHED_WINDOW:])
    emit(phase, normalize=normalize, kernel_path=ctrl.kernel_path, K=K,
         H=tau, steps=LOOP_STEPS, goal_err=err, tol=tol,
         window_mean_err=float(window.mean()),
         window_max_err=float(window.max()), window=SCHED_WINDOW,
         mean_tol=mean_tol, err_every_25=errs[24::25], launches=counts,
         step_ms_median=float(np.median(ms)),
         step_ms_p90=float(np.percentile(ms, 90)),
         seconds=time.perf_counter() - t0)
    want = {n: 0 for n in counts}
    want.update({"pm_fused_costs": LOOP_STEPS, "mppi_weights": LOOP_STEPS,
                 "pm_merge": 2 * LOOP_STEPS} if normalize else
                {"pm_fused_solve": LOOP_STEPS, "pm_merge": LOOP_STEPS})
    gate = (err < tol) if mean_tol is None else window.mean() < mean_tol
    if not (ctrl.kernel_path == "cuda" and counts == want and gate):
        raise AssertionError(f"{phase} (normalize={normalize}): "
                             f"{ctrl.kernel_path}, {counts}, err {err}, "
                             f"window mean {window.mean()}")
    return ctrl, ms, counts


def pm_sched_phase(pm, model, cost, smi: str) -> dict:
    """point_mass_h100 on the kernels: the scheduled pm_fused_solve and
    pm_fused_costs against their plain versions (injected z and Philox),
    a LOOP_STEPS loop in each mode, one sync a step, and c_t = 1 set at
    run time against an unscheduled controller."""
    fz = pm.FusedPointMassMPPI(model, cost, k=K, tau=H100, lam=LAM,
                               upsilon=UPSILON, sigma=SIGMA, schedule=SCHED)
    z = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (H100, 3, K), np.float32), device="cuda")
    chk = check_pm_variant(pm, fz, z, "sched_K100000_H100")
    del z
    loops = {}
    for normalize in (False, True):
        ctrl, ms, counts = pm_loop_phase(
            "pm_sched_closed_loop", normalize, H100,
            mean_tol=None if normalize else SCHED_MEAN_TOL,
            **{"noise-schedule": SCHED})
        loops[normalize] = (ms, counts)
        if not normalize:
            prof = profile_steps(ctrl)
            emit("profile", kernel_path=ctrl.kernel_path, model="point_mass",
                 H=H100, scheduled=True, card=smi, **prof)
            check_syncs(prof)
        del ctrl
    # c_t = 1 set at run time against no schedule: same seed, solve 0; the
    # u_half packing sums in another order, hence a tolerance
    ones = pm_controller("auto", False, H100, **{"noise-schedule": SCHED})
    ones.set_noise_schedule({"type": "constant", "value": 1})
    flat = pm_controller("auto", False, H100)
    x = np.full(6, 0.2)
    a_1, a_0 = ones.next(x), flat.next(x)
    ok, err, _ = close(torch.as_tensor(a_1), torch.as_tensor(a_0), 1e-4,
                       1e-6)
    emit("pm_sched_constant_one", action=a_1.tolist(),
         unscheduled_action=a_0.tolist(), max_abs_err=err, rtol=1e-4,
         atol=1e-6, kernel_paths=[ones.kernel_path, flat.kernel_path])
    if not (ok and ones.kernel_path == flat.kernel_path == "cuda"):
        raise AssertionError(f"c_t = 1 differs from no schedule: {err}")
    return {"fused": fz, "check": chk, "loops": loops}


def antithetic_phase(pm, model, cost, z) -> dict:
    """The antithetic variants at K, H=50: the dump's pairs, the solve
    and costs against their plain versions, mppi_weights at adim 3 and 6,
    and a LOOP_STEPS point-mass loop in each mode."""
    noise = antithetic_noise(pm, seed=4321, solve=6)
    fz = pm.FusedPointMassMPPI(model, cost, k=K, tau=H, lam=LAM,
                               upsilon=UPSILON, sigma=SIGMA, antithetic=True)
    chk = check_pm_variant(pm, fz, z, "antithetic_K100000_H50")
    w3 = check_weights(pm, fz, "antithetic_adim3_K100000_H50")
    w6 = check_weights(pm, auv_fused(AUV_K, AUV_H, antithetic=True),
                       "antithetic_adim6_K262144_H25")
    loops = {}
    for normalize in (False, True):
        ctrl, ms, counts = pm_loop_phase(
            "antithetic_closed_loop", normalize, H, antithetic=True)
        loops[normalize] = (ms, counts)
        del ctrl
    return {"fused": fz, "noise": noise, "check": chk, "w3": w3, "w6": w6,
            "loops": loops}


def dmd_kernels_phase(pm, z_big) -> dict:
    """The dynamic_ab pm_fused_solve and pm_fused_costs against their
    plain versions (``check_pm_variant``: injected z and Philox) at K, H
    through a DMDMPPI's solve object: the bench's point-mass-seeded
    DMDModel(6, 3), then a dense random (A, B) and a refit, each written
    through ``model_params`` into the same solve object; at K=700, H=7 the
    (4, 2) quadratic and ellipse kinds, each before and after a refit; and
    the seeded model's costs and weights against pm_fused_solve /
    pm_fused_costs of the point mass at mass 1, the same map."""
    from mppi_tf_tpu_torch.cfg import default_config
    from mppi_tf_tpu_torch.controller.dmd import DMDMPPI
    from mppi_tf_tpu_torch.costs import get_cost
    from mppi_tf_tpu_torch.models.dmd import DMDModel

    model, cost = workload("cuda", dmd=True)
    seeded = {name: t.detach().cpu().clone()
              for name, t in (("A", model.A), ("B", model.B))}
    ctrl = DMDMPPI(model, cost, k=K, tau=H, lam=LAM, upsilon=UPSILON,
                   sigma=SIGMA, kernel="cuda")
    fz = ctrl._fused
    rng = np.random.RandomState(5)
    chk = {"seeded": check_pm_variant(pm, fz, z_big, "dmd_seeded_K100000_H50")}
    for name, A, B in (
            ("dense", np.eye(6) + 0.05 * rng.randn(6, 6), 0.1 * rng.randn(6, 3)),
            ("refit", np.eye(6) + 0.02 * rng.randn(6, 6),
             0.15 * rng.randn(6, 3))):
        ctrl.model_params = {"A": A, "B": B}
        chk[name] = check_pm_variant(pm, fz, z_big,
                                     f"dmd_{name}_K100000_H50")
    sig2 = np.diag([0.25, 0.25])
    for kind, task, x0 in (
            ("quadratic", {"type": "static", "diag": True,
                           "goal": [0.5, 0.0, -0.5, 0.0],
                           "Q": [5.0, 1.0, 5.0, 1.0]}, None),
            ("elipse", default_config("tasks/elipse_task"), EL_X0)):
        m2 = DMDModel(4, 2, dt=DT, init_A=np.eye(4) + 0.05 * rng.randn(4, 4),
                      init_B=0.1 * rng.randn(4, 2), device="cuda")
        c2 = get_cost(task, lam=LAM, gamma=GAMMA, upsilon=UPSILON, sigma=sig2,
                      device="cuda")
        small = DMDMPPI(m2, c2, k=700, tau=7, lam=LAM, upsilon=UPSILON,
                        sigma=sig2, kernel="cuda")
        z_s = torch.as_tensor(rng.randn(7, 2, 700).astype(np.float32),
                              device="cuda")
        chk[kind] = check_pm_variant(pm, small._fused, z_s,
                                     f"dmd_{kind}_K700_H7", x0=x0)
        small.model_params = {"A": np.eye(4) + 0.02 * rng.randn(4, 4),
                              "B": 0.15 * rng.randn(4, 2)}
        chk[f"{kind}_refit"] = check_pm_variant(
            pm, small._fused, z_s, f"dmd_{kind}_refit_K700_H7", x0=x0)
    # the seeded DMD against the point mass at mass 1: the same map, read
    # from shared memory instead of the constants
    ctrl.model_params = seeded
    pm_fz = pm.FusedPointMassMPPI(*workload("cuda"), k=K, tau=H, lam=LAM,
                                  upsilon=UPSILON, sigma=SIGMA)
    useq = torch.as_tensor(0.1 * np.random.default_rng(7).standard_normal(
        (H, 3)), dtype=torch.float32, device="cuda")
    x0 = torch.zeros(6, device="cuda")
    dyn_l, dyn_c = fz.pack_dyn(x0, useq), pm_fz.pack_dyn(x0, useq)
    c_l, _ = pm.pm_fused_costs(fz.consts, dyn_l, K, H, z=z_big)
    c_c, _ = pm.pm_fused_costs(pm_fz.consts, dyn_c, K, H, z=z_big)
    zs_l, st_l = pm.pm_merge(pm.pm_fused_solve(fz.consts, dyn_l, K, H,
                                               z=z_big))
    zs_c, st_c = pm.pm_merge(pm.pm_fused_solve(pm_fz.consts, dyn_c, K, H,
                                               z=z_big))
    torch.cuda.synchronize()
    ok_c, err_c, _ = close(c_l, c_c, PM_COST_RTOL, PM_COST_ATOL)
    ok_w, err_w, _ = close(zs_l / st_l[1], zs_c / st_c[1], 1e-3, 1e-5)
    same = {"costs_max_abs_diff": err_c, "weighted_z_max_abs_diff": err_w,
            "costs_bit_identical": bool(torch.equal(c_l, c_c)),
            "dyn_sizes": [dyn_l.numel(), dyn_c.numel()]}
    emit("dmd_vs_point_mass_K100000_H50", ok=ok_c and ok_w,
         cost_rtol=PM_COST_RTOL, cost_atol=PM_COST_ATOL, **same)
    if not (ok_c and ok_w):
        raise AssertionError(f"seeded DMD kernel differs from the point "
                             f"mass's: {same}")
    return {"ctrl": ctrl, "fused": fz, "pm_fused": pm_fz, "check": chk,
            "dyn": dyn_l, "pm_dyn": dyn_c, "same_map": same}


def dmd_loop_phase(pm, smi: str) -> dict:
    """The bench's dmd row on the kernels: LOOP_STEPS of MPPI.next from
    state 0 in each mode, against the point-mass plant at mass 1 (no save,
    no refit), gated at GOAL_TOL; 20 steps profiled, one sync a step."""
    from mppi_tf_tpu_torch.controller.dmd import DMDMPPI
    from mppi_tf_tpu_torch.kernels.pm_mppi import FusedLTIMPPI

    loops = {}
    for normalize in (False, True):
        ctrl, ms, counts = pm_loop_phase("dmd_closed_loop", normalize, H,
                                         dmd=True)
        if not (type(ctrl) is DMDMPPI and type(ctrl._fused) is FusedLTIMPPI
                and ctrl.n_fits == 0):
            raise AssertionError(f"dmd loop ran {type(ctrl).__name__} on "
                                 f"{type(ctrl._fused).__name__}")
        loops[normalize] = (ms, counts)
        if not normalize:
            prof = profile_steps(ctrl)
            emit("profile", kernel_path=ctrl.kernel_path, model="dmd",
                 card=smi, **prof)
            check_syncs(prof)
        del ctrl
    return loops


def dmd_adaptive_phase(pm, smi: str) -> dict:
    """The host-driven counterpart of the bench's adaptive DMD loop at K,
    H: a mass-1 prior against a mass-3 plant through ClosedLoopRunner,
    refits from the runner's save(). Gated on the refits due, the goal
    error and the identified B (DMD_GOAL_TOL, DMD_B_TOL), one sync a step
    over a 20-step profile spanning two refits, and no kernel build after
    the first step."""
    from mppi_tf_tpu_torch.controller.dmd import DMDMPPI
    from mppi_tf_tpu_torch.envs import PointMassEnv
    from mppi_tf_tpu_torch.envs.runner import ClosedLoopRunner
    from mppi_tf_tpu_torch.kernels import _build
    from mppi_tf_tpu_torch.models.dmd import DMDModel

    prior, cost = workload("cuda")
    A1, B1 = prior.A.cpu().numpy(), prior.B.cpu().numpy()
    model = DMDModel(6, 3, dt=DT, init_A=A1, init_B=B1, reg=DMD_REG,
                     device="cuda")
    ctrl = DMDMPPI(model, cost, k=K, tau=H, lam=LAM, upsilon=UPSILON,
                   sigma=SIGMA, kernel="auto", refit_every=DMD_REFIT)
    env = PointMassEnv(n_dof=3, mass=DMD_PLANT_MASS, dt=0.01)
    runner = ClosedLoopRunner(env, ctrl, control_dt=DT)
    pm.reset_launch_counts()
    t0 = time.perf_counter()
    runner.run(1)
    lib, built = _build.load_library(), sorted(os.listdir(_build.BUILD_DIR))
    runner.run(DMD_PROFILE_FROM - 1)
    fits_before = ctrl.n_fits
    prof = profile_run(lambda: runner.run(DMD_PROFILE_STEPS),
                       DMD_PROFILE_STEPS)
    prof["refits"] = ctrl.n_fits - fits_before
    runner.run(DMD_ADAPT_STEPS - DMD_PROFILE_FROM - DMD_PROFILE_STEPS)
    counts = dict(pm.launch_counts)
    seconds = time.perf_counter() - t0
    x = env.getState().ravel()
    B = ctrl.model_params["B"].cpu().numpy()
    goal_err = float(np.linalg.norm(x - np.asarray(GOAL)))
    pos_err = float(np.linalg.norm(x[0::2] - np.asarray(GOAL)[0::2]))
    b_err = float(np.abs(B - B1 / DMD_PLANT_MASS).max())
    fits_due = (DMD_ADAPT_STEPS - ctrl._min_samples) // DMD_REFIT + 1
    rebuilt = (_build.load_library() is not lib
               or sorted(os.listdir(_build.BUILD_DIR)) != built)
    emit("profile", kernel_path=ctrl.kernel_path, model="dmd_adaptive",
         card=smi, **prof)
    out = {"kernel_path": ctrl.kernel_path, "K": K, "H": H,
           "steps": DMD_ADAPT_STEPS, "plant_mass": DMD_PLANT_MASS,
           "n_fits": ctrl.n_fits, "fits_due": fits_due, "goal_err": goal_err,
           "position_err": pos_err, "goal_tol": DMD_GOAL_TOL,
           "B_max_abs_err": b_err, "B_tol": DMD_B_TOL, "launches": counts,
           "rebuilt": rebuilt, "seconds": seconds,
           "ms_per_step_with_plant_and_refits": 1e3 * seconds
           / DMD_ADAPT_STEPS}
    emit("dmd_adaptive", **out)
    want = {n: 0 for n in counts}
    want.update(pm_fused_solve=DMD_ADAPT_STEPS, pm_merge=DMD_ADAPT_STEPS)
    check_syncs(prof)
    if not (ctrl.kernel_path == "cuda" and counts == want
            and ctrl.n_fits == fits_due and prof["refits"] == 2
            and goal_err < DMD_GOAL_TOL and b_err < DMD_B_TOL
            and not rebuilt):
        raise AssertionError(f"adaptive DMD loop: {out}, profile refits "
                             f"{prof['refits']}")
    return out


def quat_sched_anti_phase(pm, kern, fused, z, label: str, loop, modes,
                          gate) -> dict:
    """An AUV or NN solve object with both options: its kernels against
    the plain versions on injected z (``check_auv``) and on the mirrored
    Philox stream (``check_quat_prng``), then ``loop`` (auv_loop, nn_loop)
    with both options in each of ``modes``, each ``gate``d on its
    states."""
    chk = check_auv(kern, pm, fused, z, f"sched_anti_{label}",
                    useq_scale=200.0)
    prng = check_quat_prng(kern, pm, fused, f"sched_anti_{label}")
    costs_name, solve_name = f"{kern.phase}_fused_costs", \
        f"{kern.phase}_fused_solve"
    loops = {}
    for normalize, n_steps in modes:
        t0 = time.perf_counter()
        ctrl, states, ms, counts = loop(normalize, n_steps)
        ok_gate, reading = gate(normalize, states)
        emit(f"{kern.phase}_sched_anti_closed_loop", normalize=normalize,
             kernel_path=ctrl.kernel_path, K=fused.k, H=fused.tau,
             steps=n_steps, launches=counts, **reading,
             step_ms_median=float(np.median(ms)),
             step_ms_p90=float(np.percentile(ms, 90)),
             seconds=time.perf_counter() - t0)
        want = {n: 0 for n in counts}
        want.update({costs_name: n_steps, "mppi_weights": n_steps,
                     "pm_merge": 2 * n_steps} if normalize else
                    {solve_name: n_steps, "pm_merge": n_steps})
        if not (ctrl.kernel_path == "cuda" and counts == want and ok_gate):
            raise AssertionError(f"{kern.phase} loop with both options "
                                 f"(normalize={normalize}): {counts}, "
                                 f"{reading}")
        loops[normalize] = (ms, counts)
        del ctrl
    return {"check": chk, "prng": prng, "loops": loops}


def dive_gate(normalize: bool, states) -> tuple:
    """The dive's gate (|z + 1| < DIVE_TOL, |q| drift < 1e-3) when
    normalized; the unnormalized flagship task: finite, sinking."""
    z_end = float(states[-1, 2])
    drift = float(np.abs(np.linalg.norm(states[:, 3:7], axis=1) - 1).max())
    reading = {"z_final": z_end, "q_drift": drift,
               "z_every_20": states[::20, 2].tolist()}
    if normalize:
        return abs(z_end + 1.0) < DIVE_TOL and drift < 1e-3, reading
    return bool(np.all(np.isfinite(states))
                and states[-1, 2] < states[0, 2] and drift < 1e-3), reading


def nn_dive_gate(normalize: bool, states) -> tuple:
    z_end = float(states[-1, 2])
    drift = float(np.abs(np.linalg.norm(states[:, 3:7], axis=1) - 1).max())
    return (abs(z_end + 1.0) < NN_LOOP_TOL and drift < 1e-3
            and bool(np.all(np.isfinite(states)))), {
        "z_final": z_end, "z_err": abs(z_end + 1.0), "q_drift": drift}


def kernel_time(fn, plain_fn, reps: int = 200) -> dict:
    """ms of a kernel launch (CUDA events over ``reps``, and the kernels'
    own device time) and of its plain version (3 calls after a warm-up)."""
    return {"ms": cuda_ms(fn, reps), "device_ms": device_ms(fn),
            "plain_ms": cuda_ms(plain_fn, 3, 1)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mppi_tf_tpu_torch.kernels import _build
    from mppi_tf_tpu_torch.kernels import auv_mppi as auv
    from mppi_tf_tpu_torch.kernels import nn_mppi as nnk
    from mppi_tf_tpu_torch.kernels import pm_mppi as pm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", torch=torch.__version__, cuda=torch.version.cuda,
         name=kind, count=torch.cuda.device_count(), nvidia_smi=smi)

    # ---- 2. build (one nvcc per source, in parallel) -------------------------
    t0 = time.perf_counter()
    _build.load_library()
    ptxas = _build.ptxas_report()
    emit("build", seconds=time.perf_counter() - t0,
         library=str(_build.library_path().name),
         sources=[p.name for p in _build.sources()], ptxas=ptxas)
    emit("registers_vs_base", rows=registers_vs_base(ptxas))
    spills = [r["kernel"] for r in ptxas
              if r.get("spill_stores") or r.get("spill_loads")]
    if spills:
        raise AssertionError(f"kernels spill registers: {spills}")

    # ---- 3. kernels against plain versions on injected z --------------------
    model, cost = workload("cuda")
    fused = pm.FusedPointMassMPPI(model, cost, k=K, tau=H, lam=LAM,
                                  upsilon=UPSILON, sigma=SIGMA)
    rng = np.random.default_rng(0)
    z_big = torch.as_tensor(rng.standard_normal((H, 3, K), np.float32),
                            device="cuda")
    main_chk = check_solve(pm, fused, z_big, "K100000_H50")
    small = pm.FusedPointMassMPPI(model, cost, k=700, tau=7, lam=LAM,
                                  upsilon=UPSILON, sigma=SIGMA)
    z_small = torch.as_tensor(rng.standard_normal((7, 3, 700), np.float32),
                              device="cuda")
    check_solve(pm, small, z_small, "K700_H7_ragged")

    # ---- 4. noise -----------------------------------------------------------
    noise = noise_phase(pm, seed=1234, solve=5)

    # ---- 5. the Philox solve consumes exactly the dumped stream -------------
    x0 = torch.zeros(6, device="cuda")
    useq = torch.zeros(H, 3, device="cuda")
    dyn = fused.pack_dyn(x0, useq)
    zs_a, st_a = pm.pm_merge(pm.pm_fused_solve(fused.consts, dyn, K, H,
                                               seed=77, solve=3))
    zd = pm.pm_noise_dump(77, 3, K, H, 3, "cuda")
    zs_b, st_b = pm.pm_merge(pm.pm_fused_solve(fused.consts, dyn, K, H,
                                               z=zd))
    wn_a, wn_b = zs_a / st_a[1], zs_b / st_b[1]
    rel = max(((wn_a - wn_b).abs().max() / wn_b.abs().max()).item(),
              ((st_a[:5] - st_b[:5]).abs() / st_b[:5].abs()).max().item())
    emit("prng_vs_injected_dump", max_rel_err=rel, tol=1e-6)
    if not rel <= 1e-6:
        raise AssertionError(f"Philox solve != injected dump solve: {rel}")

    # ---- 6. closed loop on the point-mass path -------------------------------
    ctrl, err, step_ms, counts = closed_loop("auto")
    emit("closed_loop", kernel="auto", kernel_path=ctrl.kernel_path, K=K,
         H=H, steps=LOOP_STEPS, goal_err=err, launches=counts,
         step_ms_median=float(np.median(step_ms)),
         step_ms_p90=float(np.percentile(step_ms, 90)))
    if ctrl.kernel_path != "cuda":
        raise AssertionError(f"kernel='auto' resolved to {ctrl.kernel_path}")
    if not (counts["pm_fused_solve"] == LOOP_STEPS
            and counts["pm_merge"] == LOOP_STEPS):
        raise AssertionError(f"launch counts {counts} != {LOOP_STEPS} each")
    if not err < GOAL_TOL:
        raise AssertionError(f"goal error {err} >= {GOAL_TOL} (cuda path)")
    main_counts = counts
    emit("profile", kernel_path=ctrl.kernel_path, card=smi,
         **profile_steps(ctrl))
    ctrl_t, err_t, step_ms_t, _ = closed_loop("torch")
    emit("closed_loop", kernel="torch", kernel_path=ctrl_t.kernel_path, K=K,
         H=H, steps=LOOP_STEPS, goal_err=err_t,
         step_ms_median=float(np.median(step_ms_t)),
         step_ms_p90=float(np.percentile(step_ms_t, 90)),
         note="plain PyTorch path on the card: no yardstick of speed")
    if not err_t < GOAL_TOL:
        raise AssertionError(f"goal error {err_t} >= {GOAL_TOL} (torch path)")
    emit("profile", kernel_path=ctrl_t.kernel_path, card=smi,
         **profile_steps(ctrl_t, 5))
    del ctrl_t

    # ---- 7. the point mass's normalized path (pm_fused_costs, mppi_weights) --
    ctrl_n, err_n, step_ms_n, pm_norm_counts = closed_loop(
        "auto", normalize=True)
    emit("closed_loop", kernel="auto", normalize=True,
         kernel_path=ctrl_n.kernel_path, K=K, H=H, steps=LOOP_STEPS,
         goal_err=err_n, launches=pm_norm_counts,
         step_ms_median=float(np.median(step_ms_n)),
         step_ms_p90=float(np.percentile(step_ms_n, 90)))
    if not (ctrl_n.kernel_path == "cuda"
            and pm_norm_counts["pm_fused_costs"] == LOOP_STEPS
            and pm_norm_counts["mppi_weights"] == LOOP_STEPS
            and pm_norm_counts["pm_merge"] == 2 * LOOP_STEPS
            and pm_norm_counts["pm_fused_solve"] == 0):
        raise AssertionError(f"normalized point-mass path: "
                             f"{ctrl_n.kernel_path}, {pm_norm_counts}")
    if not err_n < GOAL_TOL:
        raise AssertionError(f"goal error {err_n} >= {GOAL_TOL} "
                             f"(normalized cuda path)")
    del ctrl_n

    # ---- 8. phase B against its plain version, adim 3 and 6 ------------------
    pm_costs_k, _ = pm.pm_fused_costs(fused.consts, fused.pack_dyn(
        x0, torch.zeros(H, 3, device="cuda")), K, H, z=z_big)
    pm_costs_p, _ = pm.fused_costs_plain(fused.consts, fused.pack_dyn(
        x0, torch.zeros(H, 3, device="cuda")), K, H, z=z_big)
    ok_pc, err_pc, ratio_pc = close(pm_costs_k, pm_costs_p, PM_COST_RTOL,
                                    PM_COST_ATOL)
    emit("pm_costs_vs_plain", k=K, tau=H, ok=ok_pc, max_abs_err=err_pc,
         ratio=ratio_pc, rtol=PM_COST_RTOL, atol=PM_COST_ATOL)
    if not ok_pc:
        raise AssertionError(f"pm_fused_costs disagrees: {err_pc}")
    w3 = check_weights(pm, fused, "adim3_K100000_H50")
    flag = auv_fused(AUV_K, AUV_H)
    w6 = check_weights(pm, flag, "adim6_K262144_H25")

    # ---- 9. AUV kernels against plain versions on injected z ----------------
    rng = np.random.default_rng(1)
    z_auv = torch.as_tensor(rng.standard_normal((AUV_H, 6, AUV_K),
                                                np.float32), device="cuda")
    auv_k = quat_kernels(auv, "auv")
    auv_chk = check_auv(auv_k, pm, flag, z_auv, "K262144_H25_rk2",
                        useq_scale=200.0)
    del z_auv
    x_dive = rest_state()
    x_dive[2] = -1.0
    rng_b = np.random.default_rng(2)   # a second draw of z for each rk
    for rk in (1, 2, 4):
        sm = auv_fused(700, 7, rk=rk,
                       sigma=np.diag([40.0] * 3 + [5.0] * 3))
        for draw, r in (("a", rng), ("b", rng_b)):
            z_s = torch.as_tensor(r.standard_normal((7, 6, 700), np.float32),
                                  device="cuda")
            check_auv(auv_k, pm, sm, z_s, f"K700_H7_rk{rk}_ragged_{draw}",
                      useq_scale=5.0, x0=x_dive, end_to_end=True)

    # ---- 10. the AUV Philox solve consumes pm_noise_dump(adim=6) ------------
    dyn_f = auv_dyn(flag, 200.0, seed=5)
    zd6 = pm.pm_noise_dump(78, 6, AUV_K, AUV_H, 6, "cuda")
    n_cmp = 4096
    dump6_err = (zd6[..., :n_cmp] - pm.noise_plain(
        78, 6, n_cmp, AUV_H, 6, device="cuda")).abs().max().item()

    fc = flag.consts
    rels = {
        "fused": rel_err(
            merged(pm, auv.auv_fused_solve(fc, dyn_f, AUV_K, AUV_H, seed=78,
                                           solve=6)),
            merged(pm, auv.auv_fused_solve(fc, dyn_f, AUV_K, AUV_H, z=zd6))),
        "costs": rel_err(
            auv.auv_fused_costs(fc, dyn_f, AUV_K, AUV_H, seed=78,
                                solve=6)[0],
            auv.auv_fused_costs(fc, dyn_f, AUV_K, AUV_H, z=zd6)[0])}
    del zd6
    emit("auv_prng_vs_dump", max_rel_err=rels, tol=1e-6,
         dump_adim6_vs_plain_max_abs_err=dump6_err, dump_tol=1e-5)
    if not (max(rels.values()) <= 1e-6 and dump6_err <= 1e-5):
        raise AssertionError(f"AUV Philox solve != injected dump: {rels}, "
                             f"dump vs plain {dump6_err}")

    # ---- 11. the AUV flagship closed loop, normalized (this slice's gate) ----
    ctrl_a, states, step_ms_a, dive_counts = auv_loop("auto", True,
                                                      DIVE_STEPS)
    z_final = float(states[-1, 2])
    q_drift = float(np.abs(np.linalg.norm(states[:, 3:7], axis=1)
                           - 1.0).max())
    emit("auv_closed_loop", kernel="auto", normalize=True,
         kernel_path=ctrl_a.kernel_path, K=AUV_K, H=AUV_H, steps=DIVE_STEPS,
         z_final=z_final, z_err=abs(z_final + 1.0), q_drift=q_drift,
         launches=dive_counts, step_ms_median=float(np.median(step_ms_a)),
         step_ms_p90=float(np.percentile(step_ms_a, 90)),
         z_every_20=states[::20, 2].tolist())
    if ctrl_a.kernel_path != "cuda":
        raise AssertionError(f"AUV kernel='auto' resolved to "
                             f"{ctrl_a.kernel_path}")
    if not (dive_counts["auv_fused_costs"] == DIVE_STEPS
            and dive_counts["mppi_weights"] == DIVE_STEPS
            and dive_counts["pm_merge"] == 2 * DIVE_STEPS
            and dive_counts["auv_fused_solve"] == 0):
        raise AssertionError(f"AUV dive launch counts {dive_counts}")
    if not (abs(z_final + 1.0) < DIVE_TOL and q_drift < 1e-3):
        raise AssertionError(f"AUV dive missed: z {z_final}, |q| drift "
                             f"{q_drift} (cuda path)")
    prof = profile_steps(ctrl_a, x=rest_state())
    emit("profile", kernel_path="cuda", model="auv", normalize=True,
         card=smi, **prof)
    # the profiler itself makes one cudaDeviceSynchronize per window
    syncs = prof["syncs_per_step"]
    if not (syncs.get("cudaStreamSynchronize", 0.0) <= 1.0
            and syncs.get("cudaDeviceSynchronize", 0.0) * prof["steps"]
            <= 1.0):
        raise AssertionError(f"more than the action copy syncs a step: "
                             f"{syncs}")
    del ctrl_a
    t0 = time.perf_counter()
    ctrl_p, states_p, step_ms_p, _ = auv_loop("torch", True, DIVE_STEPS)
    z_final_p = float(states_p[-1, 2])
    q_drift_p = float(np.abs(np.linalg.norm(states_p[:, 3:7], axis=1)
                             - 1.0).max())
    emit("auv_closed_loop", kernel="torch", normalize=True,
         kernel_path=ctrl_p.kernel_path, K=AUV_K, H=AUV_H,
         steps=DIVE_STEPS, z_final=z_final_p, z_err=abs(z_final_p + 1.0),
         q_drift=q_drift_p, seconds=time.perf_counter() - t0,
         step_ms_median=float(np.median(step_ms_p)),
         step_ms_p90=float(np.percentile(step_ms_p, 90)),
         note="plain PyTorch path on the card: no yardstick of speed")
    if not (abs(z_final_p + 1.0) < DIVE_TOL and q_drift_p < 1e-3):
        raise AssertionError(f"AUV dive missed: z {z_final_p}, |q| drift "
                             f"{q_drift_p} (torch path)")
    del ctrl_p

    # ---- 12. the unnormalized flagship (the bench's auv_rexrov2 row) --------
    ctrl_u, states_u, step_ms_u, unnorm_counts = auv_loop(
        "auto", False, AUV_PLAIN_STEPS)
    emit("auv_closed_loop", kernel="auto", normalize=False,
         kernel_path=ctrl_u.kernel_path, K=AUV_K, H=AUV_H,
         steps=AUV_PLAIN_STEPS, z_final=float(states_u[-1, 2]),
         goal_z=-5.0, launches=unnorm_counts,
         step_ms_median=float(np.median(step_ms_u)),
         step_ms_p90=float(np.percentile(step_ms_u, 90)),
         z_every_10=states_u[::10, 2].tolist())
    if not (ctrl_u.kernel_path == "cuda"
            and unnorm_counts["auv_fused_solve"] == AUV_PLAIN_STEPS
            and unnorm_counts["pm_merge"] == AUV_PLAIN_STEPS
            and np.all(np.isfinite(states_u))
            and states_u[-1, 2] < states_u[0, 2]):
        raise AssertionError(f"unnormalized AUV path: {ctrl_u.kernel_path}, "
                             f"{unnorm_counts}, z {states_u[:, 2]}")
    emit("profile", kernel_path="cuda", model="auv", normalize=False,
         card=smi, **profile_steps(ctrl_u, x=rest_state()))
    del ctrl_u

    # ---- 13. the NN kernels against plain versions (the learned slice) -------
    nn_flag = nn_fused(NN_K, NN_H)
    nn_k = quat_kernels(nnk, "nn")
    rng_n = np.random.default_rng(3)
    z_nn = torch.as_tensor(rng_n.standard_normal((NN_H, 6, NN_K),
                                                 np.float32), device="cuda")
    nn_chk = check_auv(nn_k, pm, nn_flag, z_nn, "K65536_H25_3x32",
                       useq_scale=200.0)
    del z_nn
    for hidden in ((8, 8), (32, 32, 32)):
        sm = nn_fused(700, 7, hidden, sigma=np.diag([40.0] * 3 + [5.0] * 3))
        z_s = torch.as_tensor(rng_n.standard_normal((7, 6, 700), np.float32),
                              device="cuda")
        check_auv(nn_k, pm, sm, z_s, f"K700_H7_{len(hidden)}x"
                  f"{hidden[0]}_ragged", useq_scale=5.0, x0=x_dive,
                  end_to_end=True)
    dyn_n = auv_dyn(nn_flag, 200.0, seed=6)
    zd_n = pm.pm_noise_dump(79, 7, NN_K, NN_H, 6, "cuda")
    nn_rels = {
        "fused": rel_err(
            merged(pm, nnk.nn_fused_solve(nn_flag.consts, dyn_n, NN_K, NN_H,
                                          seed=79, solve=7)),
            merged(pm, nnk.nn_fused_solve(nn_flag.consts, dyn_n, NN_K, NN_H,
                                          z=zd_n))),
        "costs": rel_err(
            nnk.nn_fused_costs(nn_flag.consts, dyn_n, NN_K, NN_H, seed=79,
                               solve=7)[0],
            nnk.nn_fused_costs(nn_flag.consts, dyn_n, NN_K, NN_H,
                               z=zd_n)[0])}
    del zd_n
    emit("nn_prng_vs_dump", max_rel_err=nn_rels, tol=1e-6)
    if not max(nn_rels.values()) <= 1e-6:
        raise AssertionError(f"NN Philox solve != injected dump: {nn_rels}")

    # ---- 14. the known-plant NN closed loop: kernels, then the torch route --
    nn_loops = {}
    for kernel in ("cuda", "torch"):
        for normalize in (False, True):
            t0 = time.perf_counter()
            ctrl_l, states_l, ms_l, counts_l = nn_loop(kernel, normalize)
            z_end = float(states_l[-1, 2])
            drift = float(np.abs(np.linalg.norm(states_l[:, 3:7], axis=1)
                                 - 1.0).max())
            nn_loops[kernel, normalize] = (ctrl_l, ms_l, counts_l)
            emit("nn_closed_loop", kernel=kernel, normalize=normalize,
                 kernel_path=ctrl_l.kernel_path, K=NN_K, H=NN_H,
                 steps=NN_LOOP_STEPS, z_final=z_end, z_err=abs(z_end + 1.0),
                 q_drift=drift, launches=counts_l,
                 step_ms_median=float(np.median(ms_l)),
                 step_ms_p90=float(np.percentile(ms_l, 90)),
                 seconds=time.perf_counter() - t0,
                 z_every_10=states_l[::10, 2].tolist())
            if not (abs(z_end + 1.0) < NN_LOOP_TOL and drift < 1e-3
                    and np.all(np.isfinite(states_l))):
                raise AssertionError(f"NN dive missed ({kernel}, normalize="
                                     f"{normalize}): z {z_end}, drift "
                                     f"{drift}")
            if kernel == "torch":
                if ctrl_l.kernel_path != "torch" or any(counts_l.values()):
                    raise AssertionError(f"torch route launched kernels: "
                                         f"{counts_l}")
                continue
            want = ({"nn_fused_costs": NN_LOOP_STEPS,
                     "mppi_weights": NN_LOOP_STEPS,
                     "pm_merge": 2 * NN_LOOP_STEPS} if normalize else
                    {"nn_fused_solve": NN_LOOP_STEPS,
                     "pm_merge": NN_LOOP_STEPS})
            want = {n: want.get(n, 0) for n in counts_l}
            if ctrl_l.kernel_path != "cuda" or counts_l != want:
                raise AssertionError(f"NN kernel path: {ctrl_l.kernel_path}, "
                                     f"{counts_l} != {want}")
    nn_unnorm_counts = nn_loops["cuda", False][2]
    nn_norm_counts = nn_loops["cuda", True][2]
    prof = profile_steps(nn_loops["cuda", False][0], x=rest_state())
    emit("profile", kernel_path="cuda", model="nn", normalize=False,
         card=smi, **prof)
    syncs = prof["syncs_per_step"]
    if not (syncs.get("cudaStreamSynchronize", 0.0) <= 1.0
            and syncs.get("cudaDeviceSynchronize", 0.0) * prof["steps"]
            <= 1.0):
        raise AssertionError(f"more than the action copy syncs a step: "
                             f"{syncs}")
    emit("profile", kernel_path="torch", model="nn", normalize=False,
         card=smi, **profile_steps(nn_loops["torch", False][0], 5,
                                   x=rest_state()))

    # ---- 15. the tracking kernels against their plain versions --------------
    from mppi_tf_tpu_torch.cfg import default_config
    from mppi_tf_tpu_torch.controller.missions import mission_params
    from mppi_tf_tpu_torch.envs import run_experiment

    rng_t = np.random.default_rng(4)
    z_pm = torch.as_tensor(rng_t.standard_normal((H, 3, K), np.float32),
                           device="cuda")
    wp_chk = {}
    for n in (1, 3):
        task = dict(default_config("tasks/waypoints_task"))
        task["waypoints"] = task["waypoints"][:n]
        _, wp_cost, wp_fused = tracking_fused(
            pm_env(), task, "models/point_mass_model", K, H)
        wp_chk[n] = check_pm_tracking(pm, wp_fused, z_pm, np.zeros(6),
                                      f"waypoints{n}_K100000_H50")
    wp_cost.pop()
    wp_chk["popped"] = check_pm_tracking(pm, wp_fused, z_pm, np.zeros(6),
                                         "waypoints3_popped_K100000_H50")
    del z_pm
    z_el = torch.as_tensor(rng_t.standard_normal((H, 2, K), np.float32),
                           device="cuda")
    _, _, el_fused = tracking_fused(pm_env(4), "tasks/elipse_task",
                                    "models/point_mass_model", K, H)
    el_chk = check_pm_tracking(pm, el_fused, z_el, EL_X0,
                               "elipse_K100000_H50")
    del z_el
    # the JAX bench's AUV mission (mppi_tf_tpu/bench.py:141-163), then
    # after a pop
    wq_legs = [rest_state(), rest_state()]
    wq_legs[0][2] = -5.0
    wq_legs[1][[0, 2, 3, 6]] = [4.0, -8.0, np.sin(0.4), np.cos(0.4)]
    wq_model, wq_cost = auv_modules(
        "cuda", {"type": "waypoints_quat", "diag": True, "alpha": 0.2,
                 "waypoints": [w.tolist() for w in wq_legs],
                 "Q": [100.0, 100.0, 100.0, 10.0] + [1.0] * 6}, AUV_SIGMA)
    wq_fused = auv.FusedAUVMPPI(wq_model, wq_cost, k=AUV_K, tau=AUV_H,
                                lam=AUV_LAM, upsilon=AUV_UPSILON,
                                sigma=AUV_SIGMA)
    z_auv = torch.as_tensor(rng_t.standard_normal((AUV_H, 6, AUV_K),
                                                  np.float32), device="cuda")
    wq_chk = check_auv(auv_k, pm, wq_fused, z_auv,
                       "waypoints_quat_K262144_H25_rk2", useq_scale=200.0)
    wq_cost.pop()
    check_auv(auv_k, pm, wq_fused, z_auv,
              "waypoints_quat_popped_K262144_H25_rk2", useq_scale=200.0)
    mission_params(wq_cost, wq_legs)
    # the 3D ellipse: envs/bluerov, tasks/elipse3d_task, models/rexrov2,
    # from a point of the ellipse (4, 0, -3), heading +x
    e3_env = dict(default_config("envs/bluerov"), samples=AUV_K,
                  horizon=AUV_H)
    _, _, e3_fused = tracking_fused(e3_env, "tasks/elipse3d_task",
                                    "models/rexrov2", AUV_K, AUV_H)
    x_e3 = rest_state()
    x_e3[[0, 2]] = [4.0, -3.0]
    e3_chk = check_auv(auv_k, pm, e3_fused, z_auv,
                       f"elipse3d_K262144_H25_rk{e3_fused.consts.rk}",
                       useq_scale=20.0, x0=x_e3)
    del z_auv

    # ---- 16. the point-mass mission through run_experiment -------------------
    wp_task = default_config("tasks/waypoints_task")
    legs = np.asarray(wp_task["waypoints"])
    pm.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_experiment(pm_env(), wp_task,
                         default_config("models/point_mass_model"),
                         steps=PM_WP_STEPS, seed=0)
    wp_counts = dict(pm.launch_counts)
    ctrl_w, st_w = res["controller"], res["states"]
    wp_err = float(np.linalg.norm(st_w[-1] - legs[-1]))
    pops_w = len(legs) - ctrl_w.waypoints_remaining()
    emit("pm_mission", kernel_path=ctrl_w.kernel_path, K=K, H=H,
         steps=PM_WP_STEPS, pops=pops_w, final_err=wp_err, tol=PM_WP_TOL,
         closest_to_legs=[float(np.linalg.norm(st_w - w, axis=1).min())
                          for w in legs], launches=wp_counts,
         seconds=time.perf_counter() - t0,
         avg_solve_ms=1e3 * ctrl_w.timing["total"] / ctrl_w.timing["calls"])
    want = {n: 0 for n in wp_counts}
    want.update(pm_fused_solve=PM_WP_STEPS, pm_merge=PM_WP_STEPS)
    if not (ctrl_w.kernel_path == "cuda" and wp_counts == want
            and pops_w == 2 and wp_err < PM_WP_TOL):
        raise AssertionError(f"point-mass mission: {ctrl_w.kernel_path}, "
                             f"{wp_counts}, pops {pops_w}, err {wp_err}")
    mission_profile(ctrl_w, np.zeros(6), "point_mass_waypoints", smi)
    del ctrl_w, res

    # ---- 17. the ellipse loop: kernels, the plain path, normalized kernels ---
    el_loops = {}
    for kernel, normalize, steps in (("auto", False, EL_STEPS),
                                     ("torch", False, EL_STEPS),
                                     ("auto", True, EL_NORM_STEPS)):
        t0 = time.perf_counter()
        ctrl_e, st_e, ms_e, counts_e = elipse_loop(kernel, normalize, steps)
        errs = elipse_errors(st_e)
        el_loops[kernel, normalize] = (ms_e, counts_e)
        emit("elipse_closed_loop", kernel=kernel, normalize=normalize,
             kernel_path=ctrl_e.kernel_path, K=K, H=H, steps=steps, **errs,
             gate={"radial_err": EL_RAD_TOL, "speed_err": EL_SPEED_TOL,
                   "angle": np.pi} if not normalize else None,
             launches=counts_e, step_ms_median=float(np.median(ms_e)),
             step_ms_p90=float(np.percentile(ms_e, 90)),
             seconds=time.perf_counter() - t0)
        want = {n: 0 for n in counts_e}
        if kernel == "auto":
            want.update({"pm_fused_costs": steps, "mppi_weights": steps,
                         "pm_merge": 2 * steps} if normalize else
                        {"pm_fused_solve": steps, "pm_merge": steps})
        if not (np.all(np.isfinite(st_e)) and counts_e == want
                and ctrl_e.kernel_path == ("torch" if kernel == "torch"
                                           else "cuda")):
            raise AssertionError(f"ellipse loop ({kernel}, {normalize}): "
                                 f"{ctrl_e.kernel_path}, {counts_e}")
        if not normalize and not (errs["radial_err"] < EL_RAD_TOL
                                  and errs["speed_err"] < EL_SPEED_TOL
                                  and errs["angle"] > np.pi):
            raise AssertionError(f"ellipse loop missed its gate ({kernel}):"
                                 f" {errs}")
        del ctrl_e

    # ---- 18. the rexrov2 waypoint mission on the normalized kernels ----------
    t0 = time.perf_counter()
    ctrl_m, st_m, pops_m, ms_m, counts_m = auv_mission_loop()
    z_m = float(st_m[-1, 2])
    drift_m = float(np.abs(np.linalg.norm(st_m[:, 3:7], axis=1) - 1.0).max())
    emit("auv_mission", kernel_path=ctrl_m.kernel_path, K=AUV_K, H=AUV_H,
         steps=AUV_WP_STEPS, pops=pops_m, z_final=z_m, z_err=abs(z_m + 2.0),
         q_drift=drift_m, launches=counts_m,
         step_ms_median=float(np.median(ms_m)),
         step_ms_p90=float(np.percentile(ms_m, 90)),
         seconds=time.perf_counter() - t0,
         z_every_20=st_m[::20, 2].tolist())
    want = {n: 0 for n in counts_m}
    want.update(auv_fused_costs=AUV_WP_STEPS, mppi_weights=AUV_WP_STEPS,
                pm_merge=2 * AUV_WP_STEPS)
    if not (ctrl_m.kernel_path == "cuda" and counts_m == want
            and len(pops_m) == 1 and ctrl_m.waypoints_remaining() == 1
            and abs(z_m + 2.0) < AUV_WP_TOL and drift_m < 1e-3):
        raise AssertionError(f"AUV mission: {ctrl_m.kernel_path}, "
                             f"{counts_m}, pops {pops_m}, z {z_m}, drift "
                             f"{drift_m}")
    mission_profile(ctrl_m, rest_state(), "auv_waypoints_quat", smi)
    del ctrl_m

    # ---- 19. the 3D ellipse on envs/bluerov, both modes, on the kernels ------
    e3_counts = {}
    for normalize in (False, True):
        pm.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_experiment(dict(e3_env, normalize=normalize),
                             default_config("tasks/elipse3d_task"),
                             default_config("models/rexrov2"),
                             steps=E3_STEPS, seed=0)
        counts = e3_counts[normalize] = dict(pm.launch_counts)
        st = res["states"]
        drift = float(np.abs(np.linalg.norm(st[:, 3:7], axis=1) - 1).max())
        emit("elipse3d_closed_loop", normalize=normalize,
             kernel_path=res["controller"].kernel_path, K=AUV_K, H=AUV_H,
             steps=E3_STEPS, q_drift=drift, final_state=st[-1].tolist(),
             launches=counts, seconds=time.perf_counter() - t0)
        want = {n: 0 for n in counts}
        want.update({"auv_fused_costs": E3_STEPS, "mppi_weights": E3_STEPS,
                     "pm_merge": 2 * E3_STEPS} if normalize else
                    {"auv_fused_solve": E3_STEPS, "pm_merge": E3_STEPS})
        if not (res["controller"].kernel_path == "cuda" and counts == want
                and np.all(np.isfinite(st)) and drift < 1e-3):
            raise AssertionError(f"3D ellipse loop (normalize={normalize}):"
                                 f" {counts}, drift {drift}")
        del res

    # ---- 20. the config CLI on the card (no --cpu) --------------------------
    import tempfile

    with tempfile.TemporaryDirectory() as workdir:
        out_pm, c_pm = run_cli(workdir, "point_mass",
                               default_config("envs/point_mass"),
                               "tasks/static_cost", "models/point_mass_model",
                               100)
        goal_pm = np.asarray(default_config("tasks/static_cost")["goal"])
        err_pm = float(np.linalg.norm(np.asarray(out_pm["final_state"])
                                      - goal_pm))
        out_auv, c_auv = run_cli(workdir, "rexrov2",
                                 default_config("envs/uuv_sim"),
                                 "tasks/static_cost_auv", "models/rexrov2",
                                 NN_CLI_STEPS)
        nn_env = dict(default_config("envs/uuv_sim"), kernel="cuda",
                      plant=default_config("models/rexrov2"))
        out_nn, c_nn = run_cli(workdir, "nn", nn_env,
                               "tasks/static_cost_auv",
                               "models/auv_nn_model_quat", NN_CLI_STEPS)
        out_dmd, c_dmd = run_cli(workdir, "dmd",
                                 default_config("envs/point_mass"),
                                 "tasks/static_cost", "models/dmd_model",
                                 DMD_CLI_STEPS)
        err_dmd = float(np.linalg.norm(np.asarray(out_dmd["final_state"])
                                       - goal_pm))
        cli_tasks = {
            "waypoints": ("envs/point_mass", {}, "models/point_mass_model",
                          "pm_fused_solve"),
            "elipse": ("envs/point_mass", EL_PATCH, "models/point_mass_model",
                       "pm_fused_solve"),
            "waypoints_quat": ("envs/uuv_sim", {}, "models/rexrov2",
                               "auv_fused_solve"),
            "elipse3d": ("envs/bluerov", {}, "models/rexrov2",
                         "auv_fused_solve")}
        cli_out = {}
        for name, (env_name, patch, model_name, kern) in cli_tasks.items():
            cli_out[name] = run_cli(
                workdir, name, dict(default_config(env_name), **patch),
                f"tasks/{name}_task", model_name, NN_CLI_STEPS)
    emit("cli", point_mass=dict(out_pm, goal_err=err_pm, launches=c_pm),
         rexrov2=dict(out_auv, launches=c_auv),
         nn=dict(out_nn, launches=c_nn),
         dmd=dict(out_dmd, goal_err=err_dmd, tol=DMD_CLI_TOL,
                  launches=c_dmd),
         **{name: dict(out, launches=counts)
            for name, (out, counts) in cli_out.items()})
    for name, (out, counts) in cli_out.items():
        kern = cli_tasks[name][3]
        x = np.asarray(out["final_state"])
        want = {n: 0 for n in counts}
        want.update({kern: NN_CLI_STEPS, "pm_merge": NN_CLI_STEPS})
        if not (out["kernel_path"] == "cuda" and counts == want
                and np.all(np.isfinite(x))
                and (x.size != 13
                     or abs(np.linalg.norm(x[3:7]) - 1.0) < 1e-3)):
            raise AssertionError(f"cli {name}: {out}, {counts}")
    if not (out_pm["kernel_path"] == "cuda" and err_pm < 0.1
            and c_pm["pm_fused_solve"] == 100 and c_pm["pm_merge"] == 100):
        raise AssertionError(f"cli point mass: {out_pm}, {c_pm}")
    if not (out_auv["kernel_path"] == "cuda"
            and c_auv["auv_fused_solve"] == NN_CLI_STEPS
            and abs(np.linalg.norm(out_auv["final_state"][3:7]) - 1) < 1e-3):
        raise AssertionError(f"cli rexrov2: {out_auv}, {c_auv}")
    if not (out_nn["kernel_path"] == "cuda"
            and c_nn["nn_fused_solve"] == NN_CLI_STEPS
            and np.all(np.isfinite(out_nn["final_state"]))):
        raise AssertionError(f"cli nn: {out_nn}, {c_nn}")
    want = {n: 0 for n in c_dmd}
    want.update(pm_fused_solve=DMD_CLI_STEPS, pm_merge=DMD_CLI_STEPS)
    if not (out_dmd["kernel_path"] == "cuda" and out_dmd["n_fits"] >= 1
            and c_dmd == want and err_dmd < DMD_CLI_TOL):
        raise AssertionError(f"cli dmd: {out_dmd}, {c_dmd}, err {err_dmd}")

    # ---- 21. point_mass_h100: the scheduled solve at H=100 -------------------
    sched = pm_sched_phase(pm, model, cost, smi)

    # ---- 22. the antithetic variants at K, H=50 ------------------------------
    anti = antithetic_phase(pm, model, cost, z_big)
    del z_big

    # ---- 23. the AUV flagship with both options (rk2, K=262,144, H=25) -------
    flag_sa = auv_fused(AUV_K, AUV_H, **FUSED_BOTH)
    z_auv = torch.as_tensor(np.random.default_rng(6).standard_normal(
        (AUV_H, 6, AUV_K), np.float32), device="cuda")
    auv_sa = quat_sched_anti_phase(
        pm, auv_k, flag_sa, z_auv, "K262144_H25_rk2",
        lambda norm, n: auv_loop("auto", norm, n, **BOTH),
        ((True, DIVE_STEPS), (False, AUV_PLAIN_STEPS)), dive_gate)
    del z_auv

    # ---- 24. the NN (3x32, K=65,536, H=25) with both options -----------------
    nn_sa = nn_fused(NN_K, NN_H, **FUSED_BOTH)
    z_nn = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (NN_H, 6, NN_K), np.float32), device="cuda")
    nn_sa_out = quat_sched_anti_phase(
        pm, nn_k, nn_sa, z_nn, "K65536_H25_3x32",
        lambda norm, n: nn_loop("cuda", norm, n, **BOTH),
        ((False, NN_LOOP_STEPS), (True, NN_LOOP_STEPS)), nn_dive_gate)
    del z_nn

    # ---- 25. log mode: the CLI with -l, MPPI(observer=) at point_mass_h100 ---
    with tempfile.TemporaryDirectory() as workdir:
        log_phase(pm, workdir)

    # ---- 26. the DMD slice: the dynamic_ab kernels, the dmd row's loops, ----
    # ---- the adaptive loop with refits ----------------------------------------
    z_dmd = torch.as_tensor(np.random.default_rng(8).standard_normal(
        (H, 3, K), np.float32), device="cuda")
    dmd = dmd_kernels_phase(pm, z_dmd)
    del z_dmd
    dmd_loops = dmd_loop_phase(pm, smi)
    dmd_adaptive_phase(pm, smi)

    # ---- 27. times -------------------------------------------------------------
    consts, nb = fused.consts, -(-K // pm.BLOCK)
    n_z = H * 3
    part = pm.pm_fused_solve(consts, dyn, K, H, seed=1, solve=1)
    t_pair = cuda_ms(lambda: pm.pm_merge(pm.pm_fused_solve(
        consts, dyn, K, H, seed=1, solve=1)), 200)
    t_solve = cuda_ms(lambda: pm.pm_fused_solve(consts, dyn, K, H, seed=1,
                                                solve=1), 200)
    t_merge = cuda_ms(lambda: pm.pm_merge(part), 200)
    d_merge = device_ms(lambda: pm.pm_merge(part))
    d_dump = device_ms(lambda: pm.pm_noise_dump(1, 1, K, H, 3, "cuda"))
    t_dump = cuda_ms(lambda: pm.pm_noise_dump(1, 1, K, H, 3, "cuda"), 200)
    p_solve = cuda_ms(lambda: pm.fused_solve_plain(consts, dyn, K, H,
                                                   seed=1, solve=1), 5, 1)
    p_merge = cuda_ms(lambda: pm.merge_plain(part), 50)
    p_dump = cuda_ms(lambda: pm.noise_plain(1, 1, K, H, 3, device="cuda"),
                     5, 1)
    part_bytes = 4.0 * nb * (pm.STATS + n_z)
    b_solve = bound_ms(4.0 * dyn.numel() + part_bytes,
                       solve_ops(consts, K, H, prng=True))
    b_merge = bound_ms(part_bytes + 4.0 * (n_z + pm.STATS),
                       nb * (2.0 * n_z + 6))
    b_dump = bound_ms(4.0 * K * n_z, K * n_z * OPS_PER_NORMAL)
    # phase A / phase B of the point mass
    pm_c, _ = pm.pm_fused_costs(consts, dyn, K, H, seed=1, solve=1)
    pm_nrm = torch.stack([pm_c.min(), 1.0 / ((pm_c.max() - pm_c.min())
                                             * LAM)])
    t_pmc = cuda_ms(lambda: pm.pm_fused_costs(consts, dyn, K, H, seed=1,
                                              solve=1), 200)
    t_w3 = cuda_ms(lambda: pm.mppi_weights(pm_nrm, pm_c, H, 3, seed=1,
                                           solve=1), 200)
    p_pmc = cuda_ms(lambda: pm.fused_costs_plain(consts, dyn, K, H, seed=1,
                                                 solve=1), 5, 1)
    p_w3 = cuda_ms(lambda: pm.weights_plain(pm_nrm, pm_c, H, 3, seed=1,
                                            solve=1), 5, 1)
    rows_b = 4.0 * nb * pm.STATS
    b_pmc = bound_ms(4.0 * dyn.numel() + 4.0 * K + rows_b,
                     solve_ops(consts, K, H, prng=True, costs_only=True))
    b_w3 = bound_ms(4.0 * K + 8.0 + part_bytes, weights_ops(K, n_z, True))
    # the AUV flagship
    ac = flag.consts
    a_nb, a_nz = -(-AUV_K // pm.BLOCK), AUV_H * 6
    a_part = auv.auv_fused_solve(ac, dyn_f, AUV_K, AUV_H, seed=1, solve=1)
    a_c, _ = auv.auv_fused_costs(ac, dyn_f, AUV_K, AUV_H, seed=1, solve=1)
    a_nrm = torch.stack([a_c.min(), 1.0 / ((a_c.max() - a_c.min())
                                           * AUV_LAM)])
    a_wrows = pm.mppi_weights(a_nrm, a_c, AUV_H, 6, seed=1, solve=1)
    t_apair = cuda_ms(lambda: pm.pm_merge(auv.auv_fused_solve(
        ac, dyn_f, AUV_K, AUV_H, seed=1, solve=1)), 200)
    t_asolve = cuda_ms(lambda: auv.auv_fused_solve(ac, dyn_f, AUV_K, AUV_H,
                                                   seed=1, solve=1), 200)
    t_acosts = cuda_ms(lambda: auv.auv_fused_costs(ac, dyn_f, AUV_K, AUV_H,
                                                   seed=1, solve=1), 200)
    t_w6 = cuda_ms(lambda: pm.mppi_weights(a_nrm, a_c, AUV_H, 6, seed=1,
                                           solve=1), 200)
    t_amerge = cuda_ms(lambda: pm.pm_merge(a_wrows), 200)
    p_asolve = cuda_ms(lambda: auv.fused_solve_plain(
        ac, dyn_f, AUV_K, AUV_H, seed=1, solve=1), 3, 1)
    p_acosts = cuda_ms(lambda: auv.fused_costs_plain(
        ac, dyn_f, AUV_K, AUV_H, seed=1, solve=1), 3, 1)
    p_w6 = cuda_ms(lambda: pm.weights_plain(a_nrm, a_c, AUV_H, 6, seed=1,
                                            solve=1), 3, 1)
    a_part_bytes = 4.0 * a_nb * (pm.STATS + a_nz)
    b_asolve = bound_ms(4.0 * dyn_f.numel() + a_part_bytes,
                        auv_solve_ops(ac, dyn_f, AUV_K, AUV_H, prng=True))
    b_acosts = bound_ms(4.0 * dyn_f.numel() + 4.0 * AUV_K
                        + 4.0 * a_nb * pm.STATS,
                        auv_solve_ops(ac, dyn_f, AUV_K, AUV_H, prng=True,
                                      costs_only=True))
    b_w6 = bound_ms(4.0 * AUV_K + 8.0 + a_part_bytes,
                    weights_ops(AUV_K, a_nz, True))
    del a_part

    # the unnormalized solve without the fused mode: phase A, its stats
    # merge, phase B with nrm = (cmin, 1/lam) (the same softmax, weights in
    # (0, 1]) and its merge; timed fused, two-phase, two-phase, fused
    def two_phase(costs_fn, tau, adim, lam):
        inv_lam = torch.full((1,), 1.0 / lam, device="cuda")

        def run():
            c, rows = costs_fn()
            _, st = pm.pm_merge(rows)
            return pm.pm_merge(pm.mppi_weights(
                torch.cat([st[2:3], inv_lam]), c, tau, adim, seed=1,
                solve=1))
        return run

    def wn_err(a, b):   # weighted normals zsum / l, z units
        return ((a[0] / a[1][1]) - (b[0] / b[1][1])).abs().max().item()

    alt_a = two_phase(lambda: auv.auv_fused_costs(
        ac, dyn_f, AUV_K, AUV_H, seed=1, solve=1), AUV_H, 6, AUV_LAM)
    alt_p = two_phase(lambda: pm.pm_fused_costs(
        consts, dyn, K, H, seed=1, solve=1), H, 3, LAM)
    def fused_a():
        return pm.pm_merge(auv.auv_fused_solve(ac, dyn_f, AUV_K, AUV_H,
                                               seed=1, solve=1))

    def fused_p():
        return pm.pm_merge(pm.pm_fused_solve(consts, dyn, K, H, seed=1,
                                             solve=1))

    nc = nn_flag.consts
    alt_n = two_phase(lambda: nnk.nn_fused_costs(
        nc, dyn_n, NN_K, NN_H, seed=1, solve=1), NN_H, 6, AUV_LAM)

    def fused_n():
        return pm.pm_merge(nnk.nn_fused_solve(nc, dyn_n, NN_K, NN_H, seed=1,
                                              solve=1))

    alt = {}
    for name, f_fn, a_fn in (("auv", fused_a, alt_a),
                             ("point_mass", fused_p, alt_p),
                             ("nn", fused_n, alt_n)):
        t_f1, t_a1, t_a2, t_f2 = (cuda_ms(f_fn, 200), cuda_ms(a_fn, 200),
                                  cuda_ms(a_fn, 200), cuda_ms(f_fn, 200))
        alt[name] = {"fused_plus_merge_ms": [t_f1, t_f2],
                     "two_phase_ms": [t_a1, t_a2],
                     "wnoise_max_abs_err_z_units": wn_err(f_fn(), a_fn())}
    emit("unnormalized_two_phase", card=smi, **alt,
         note="reading for a later slice, not a gate: the fused mode "
              "against costs + merge + mppi_weights(cmin, 1/lam) + merge; "
              "the two round -c/lam differently, so the weights differ in "
              "f32 rounding")
    # the NN kernels at K=65,536, H=25, 3x32
    n_nb, n_nz = -(-NN_K // pm.BLOCK), NN_H * 6
    n_c, _ = nnk.nn_fused_costs(nc, dyn_n, NN_K, NN_H, seed=1, solve=1)
    n_nrm = torch.stack([n_c.min(), 1.0 / ((n_c.max() - n_c.min())
                                           * AUV_LAM)])
    t_nsolve = cuda_ms(lambda: nnk.nn_fused_solve(nc, dyn_n, NN_K, NN_H,
                                                  seed=1, solve=1), 200)
    t_ncosts = cuda_ms(lambda: nnk.nn_fused_costs(nc, dyn_n, NN_K, NN_H,
                                                  seed=1, solve=1), 200)
    t_nw6 = cuda_ms(lambda: pm.mppi_weights(n_nrm, n_c, NN_H, 6, seed=1,
                                            solve=1), 200)
    p_nsolve = cuda_ms(lambda: nnk.fused_solve_plain(
        nc, dyn_n, NN_K, NN_H, seed=1, solve=1), 3, 1)
    p_ncosts = cuda_ms(lambda: nnk.fused_costs_plain(
        nc, dyn_n, NN_K, NN_H, seed=1, solve=1), 3, 1)
    p_nw6 = cuda_ms(lambda: pm.weights_plain(n_nrm, n_c, NN_H, 6, seed=1,
                                             solve=1), 3, 1)
    n_part_bytes = 4.0 * n_nb * (pm.STATS + n_nz)
    b_nsolve = bound_ms(4.0 * dyn_n.numel() + n_part_bytes,
                        nn_solve_ops(nc, NN_K, NN_H, prng=True))
    b_ncosts = bound_ms(4.0 * dyn_n.numel() + 4.0 * NN_K
                        + 4.0 * n_nb * pm.STATS,
                        nn_solve_ops(nc, NN_K, NN_H, prng=True,
                                     costs_only=True))
    b_nw6 = bound_ms(4.0 * NN_K + 8.0 + n_part_bytes,
                     weights_ops(NN_K, n_nz, True))
    # a reading never called by the port: the MLP's four products over the
    # K*H rows of a horizon as torch.matmul (cuBLAS, f32, no TF32), the
    # work the torch route does a step beside its elementwise ops
    layers = nnk.fold_layers(nn_flag.model)
    feats = torch.randn(NN_K * NN_H, nnk.FEATURES, device="cuda")

    def mlp_matmuls():
        h = feats
        for w, b in layers[:-1]:
            h = torch.relu(h @ w + b)
        return h @ layers[-1][0] + layers[-1][1]

    t_mlp = cuda_ms(mlp_matmuls, 20)
    del feats
    # the tracking variants: the new instantiations, and the waypoint solve
    # through its solve object (effective goal and offset on the device)
    # beside the static one at the same shapes
    trk = {}
    el_dyn = el_fused.pack_dyn(torch.as_tensor(EL_X0, device="cuda"),
                               torch.zeros(H, 2, device="cuda"))
    ec = el_fused.consts
    el_part_bytes = 4.0 * nb * (pm.STATS + H * 2)
    trk["pm_elipse_solve"] = dict(
        kernel_time(lambda: pm.pm_fused_solve(ec, el_dyn, K, H, seed=1,
                                              solve=1),
                    lambda: pm.fused_solve_plain(ec, el_dyn, K, H, seed=1,
                                                 solve=1)),
        bound=bound_ms(4.0 * el_dyn.numel() + el_part_bytes,
                       solve_ops(ec, K, H, prng=True)))
    trk["pm_elipse_costs"] = dict(
        kernel_time(lambda: pm.pm_fused_costs(ec, el_dyn, K, H, seed=1,
                                              solve=1),
                    lambda: pm.fused_costs_plain(ec, el_dyn, K, H, seed=1,
                                                 solve=1)),
        bound=bound_ms(4.0 * el_dyn.numel() + 4.0 * K + rows_b,
                       solve_ops(ec, K, H, prng=True, costs_only=True)))
    x_pm, u_pm = torch.zeros(6, device="cuda"), torch.zeros(H, 3,
                                                            device="cuda")
    t_s1, t_w1, t_w2, t_s2 = (
        cuda_ms(lambda: fused.solve(x_pm, u_pm, seed=1, solve=1), 200),
        cuda_ms(lambda: wp_fused.solve(x_pm, u_pm, seed=1, solve=1), 200),
        cuda_ms(lambda: wp_fused.solve(x_pm, u_pm, seed=1, solve=1), 200),
        cuda_ms(lambda: fused.solve(x_pm, u_pm, seed=1, solve=1), 200))
    wp_dyn = wp_fused.pack_dyn(x_pm, u_pm)
    trk["pm_solve_object_ms"] = {
        "static": [t_s1, t_s2], "waypoints": [t_w1, t_w2],
        "waypoints_plain": cuda_ms(lambda: pm.merge_plain(
            pm.fused_solve_plain(wp_fused.consts, wp_dyn, K, H, seed=1,
                                 solve=1)), 3, 1)}
    for name, fz, x0_t, u_scale in (("waypoints_quat", wq_fused, None,
                                     200.0),
                                    ("elipse3d", e3_fused, x_e3, 20.0)):
        tc = fz.consts
        tdyn = auv_dyn(fz, u_scale, seed=5, x0=x0_t)
        trk[f"auv_{name}_solve"] = dict(
            kernel_time(lambda: auv.auv_fused_solve(tc, tdyn, AUV_K, AUV_H,
                                                    seed=1, solve=1),
                        lambda: auv.fused_solve_plain(tc, tdyn, AUV_K, AUV_H,
                                                      seed=1, solve=1)),
            bound=bound_ms(4.0 * tdyn.numel() + a_part_bytes,
                           auv_solve_ops(tc, tdyn, AUV_K, AUV_H, prng=True)))
        trk[f"auv_{name}_costs"] = dict(
            kernel_time(lambda: auv.auv_fused_costs(tc, tdyn, AUV_K, AUV_H,
                                                    seed=1, solve=1),
                        lambda: auv.fused_costs_plain(tc, tdyn, AUV_K, AUV_H,
                                                      seed=1, solve=1)),
            bound=bound_ms(4.0 * tdyn.numel() + 4.0 * AUV_K
                           + 4.0 * a_nb * pm.STATS,
                           auv_solve_ops(tc, tdyn, AUV_K, AUV_H, prng=True,
                                         costs_only=True)))
    nn_next = {f"{kern}_{'normalized' if norm else 'unnormalized'}": {
        "median_ms": float(np.median(ms)),
        "p90_ms": float(np.percentile(ms, 90))}
        for (kern, norm), (_, ms, _) in nn_loops.items()}
    emit("times", card=smi, K=K, H=H,
         solve_plus_merge_ms=t_pair, solve_ms=t_solve, merge_ms=t_merge,
         noise_dump_ms=t_dump, merge_device_ms=d_merge,
         noise_dump_device_ms=d_dump,
         mppi_next_ms_median=float(np.median(step_ms)),
         plain_solve_ms=p_solve, plain_merge_ms=p_merge,
         plain_noise_ms=p_dump,
         pm_costs_ms=t_pmc, weights_adim3_ms=t_w3, plain_pm_costs_ms=p_pmc,
         plain_weights_adim3_ms=p_w3,
         auv={"K": AUV_K, "H": AUV_H, "rk": ac.rk,
              "solve_plus_merge_ms": t_apair, "solve_ms": t_asolve,
              "costs_ms": t_acosts, "weights_adim6_ms": t_w6,
              "merge_weights_rows_ms": t_amerge,
              "plain_solve_ms": p_asolve, "plain_costs_ms": p_acosts,
              "plain_weights_adim6_ms": p_w6,
              "bound_solve": b_asolve, "bound_costs": b_acosts,
              "bound_weights": b_w6,
              "dive_mppi_next_ms_median": float(np.median(step_ms_a)),
              "unnormalized_mppi_next_ms_median": float(
                  np.median(step_ms_u))},
         nn={"K": NN_K, "H": NN_H, "sizes": list(nc.sizes),
             "solve_ms": t_nsolve, "costs_ms": t_ncosts,
             "weights_adim6_ms": t_nw6, "plain_solve_ms": p_nsolve,
             "plain_costs_ms": p_ncosts, "plain_weights_adim6_ms": p_nw6,
             "bound_solve": b_nsolve, "bound_costs": b_ncosts,
             "bound_weights": b_nw6, "mlp_matmuls_ms": t_mlp,
             "mppi_next_ms": nn_next,
             "mlp_matmuls_note": "four torch.matmul of the folded MLP over "
                                 "K*H rows: a reading, not a yardstick of "
                                 "the fused rollout, never called by the "
                                 "port"},
         tracking={**trk, "elipse_mppi_next_ms_median": {
             f"{k}_{'normalized' if n else 'unnormalized'}": float(
                 np.median(v[0])) for (k, n), v in el_loops.items()},
             "auv_mission_mppi_next_ms_median": float(np.median(ms_m))},
         plain_note="plain PyTorch versions repeat the kernels' arithmetic; "
                    "no yardstick of speed",
         library_note="no single PyTorch call computes a fused MPPI rollout "
                      "or its weights: library_ms is null",
         timing="CUDA events over back-to-back launches after warm-up; "
                "MPPI.next on the host clock ending in a sync")

    # the noise variants beside their unvaried counterparts at the same
    # shapes, timed in turns; bounds add one FMUL a driven dimension and a
    # step (and one for the z-quadratic) for the schedule, and drop the
    # mirrored half's normals for antithetic
    vt = {}
    fs, fa = sched["fused"], anti["fused"]
    flat100 = pm.FusedPointMassMPPI(model, cost, k=K, tau=H100, lam=LAM,
                                    upsilon=UPSILON, sigma=SIGMA)
    u100 = torch.zeros(H100, 3, device="cuda")
    dyn_s, dyn_100 = fs.pack_dyn(x0, u100), flat100.pack_dyn(x0, u100)
    dyn_a = fa.pack_dyn(x0, useq)
    nz100 = H100 * 3
    pb100 = 4.0 * nb * (pm.STATS + nz100)
    vt["pm_fused_solve[sched]"] = dict(variant_times(
        lambda: pm.pm_fused_solve(flat100.consts, dyn_100, K, H100, seed=1,
                                  solve=1),
        lambda: pm.pm_fused_solve(fs.consts, dyn_s, K, H100, seed=1,
                                  solve=1),
        lambda: pm.fused_solve_plain(fs.consts, dyn_s, K, H100, seed=1,
                                     solve=1)),
        bound=bound_ms(4.0 * dyn_s.numel() + pb100,
                       solve_ops(fs.consts, K, H100, prng=True)
                       + sched_ops(K, H100, 6)))
    vt["pm_fused_costs[sched]"] = dict(variant_times(
        lambda: pm.pm_fused_costs(flat100.consts, dyn_100, K, H100, seed=1,
                                  solve=1),
        lambda: pm.pm_fused_costs(fs.consts, dyn_s, K, H100, seed=1,
                                  solve=1),
        lambda: pm.fused_costs_plain(fs.consts, dyn_s, K, H100, seed=1,
                                     solve=1)),
        bound=bound_ms(4.0 * dyn_s.numel() + 4.0 * K + rows_b,
                       solve_ops(fs.consts, K, H100, prng=True,
                                 costs_only=True) + sched_ops(K, H100, 6)))
    del flat100, dyn_100
    vt["pm_fused_solve[antithetic]"] = dict(variant_times(
        lambda: pm.pm_fused_solve(consts, dyn_a, K, H, seed=1, solve=1),
        lambda: pm.pm_fused_solve(fa.consts, dyn_a, K, H, seed=1, solve=1),
        lambda: pm.fused_solve_plain(fa.consts, dyn_a, K, H, seed=1,
                                     solve=1)),
        bound=bound_ms(4.0 * dyn_a.numel() + part_bytes,
                       solve_ops(fa.consts, K, H, prng=True)
                       - mirror_saving(K, n_z)))
    vt["pm_fused_costs[antithetic]"] = dict(variant_times(
        lambda: pm.pm_fused_costs(consts, dyn_a, K, H, seed=1, solve=1),
        lambda: pm.pm_fused_costs(fa.consts, dyn_a, K, H, seed=1, solve=1),
        lambda: pm.fused_costs_plain(fa.consts, dyn_a, K, H, seed=1,
                                     solve=1)),
        bound=bound_ms(4.0 * dyn_a.numel() + 4.0 * K + rows_b,
                       solve_ops(fa.consts, K, H, prng=True, costs_only=True)
                       - mirror_saving(K, n_z)))
    vt["pm_noise_dump[antithetic]"] = dict(variant_times(
        lambda: pm.pm_noise_dump(1, 1, K, H, 3, "cuda"),
        lambda: pm.pm_noise_dump(1, 1, K, H, 3, "cuda",
                                 half=pm.antithetic_half(K)),
        lambda: pm.noise_plain(1, 1, K, H, 3, device="cuda",
                               half=pm.antithetic_half(K))),
        bound=bound_ms(4.0 * K * n_z, K * n_z * OPS_PER_NORMAL
                       - mirror_saving(K, n_z)))
    vt["mppi_weights[antithetic]"] = dict(variant_times(
        lambda: pm.mppi_weights(pm_nrm, pm_c, H, 3, seed=1, solve=1),
        lambda: pm.mppi_weights(pm_nrm, pm_c, H, 3, seed=1, solve=1,
                                antithetic=True),
        lambda: pm.weights_plain(pm_nrm, pm_c, H, 3, seed=1, solve=1,
                                 antithetic=True)),
        bound=bound_ms(4.0 * K + 8.0 + part_bytes,
                       weights_ops(K, n_z, True) - mirror_saving(K, n_z)))
    vt["mppi_weights[antithetic, adim 6]"] = dict(variant_times(
        lambda: pm.mppi_weights(a_nrm, a_c, AUV_H, 6, seed=1, solve=1),
        lambda: pm.mppi_weights(a_nrm, a_c, AUV_H, 6, seed=1, solve=1,
                                antithetic=True),
        lambda: pm.weights_plain(a_nrm, a_c, AUV_H, 6, seed=1, solve=1,
                                 antithetic=True)),
        bound=bound_ms(4.0 * AUV_K + 8.0 + a_part_bytes,
                       weights_ops(AUV_K, a_nz, True)
                       - mirror_saving(AUV_K, a_nz)))
    for key, fz, base, kmod, ops_fn, k_, h_, dyn_b in (
            ("auv", flag_sa, flag, auv, auv_solve_ops, AUV_K, AUV_H, dyn_f),
            ("nn", nn_sa, nn_flag, nnk, nn_solve_ops, NN_K, NN_H, dyn_n)):
        vc, dyn_v = fz.consts, auv_dyn(fz, 200.0, seed=5 if key == "auv"
                                       else 6)
        nz_, nb_ = h_ * 6, -(-k_ // pm.BLOCK)
        extra = sched_ops(k_, h_, 6) - mirror_saving(k_, nz_)
        if key == "auv":
            ops_s = auv_solve_ops(vc, dyn_v, k_, h_, prng=True)
            ops_c = auv_solve_ops(vc, dyn_v, k_, h_, prng=True,
                                  costs_only=True)
        else:
            ops_s = nn_solve_ops(vc, k_, h_, prng=True)
            ops_c = nn_solve_ops(vc, k_, h_, prng=True, costs_only=True)
        solve_k = getattr(kmod, f"{key}_fused_solve")
        costs_k = getattr(kmod, f"{key}_fused_costs")
        bc = base.consts
        vt[f"{key}_fused_solve[sched, antithetic]"] = dict(variant_times(
            lambda: solve_k(bc, dyn_b, k_, h_, seed=1, solve=1),
            lambda: solve_k(vc, dyn_v, k_, h_, seed=1, solve=1),
            lambda: kmod.fused_solve_plain(vc, dyn_v, k_, h_, seed=1,
                                           solve=1)),
            bound=bound_ms(4.0 * dyn_v.numel() + 4.0 * nb_ * (pm.STATS + nz_),
                           ops_s + extra))
        vt[f"{key}_fused_costs[sched, antithetic]"] = dict(variant_times(
            lambda: costs_k(bc, dyn_b, k_, h_, seed=1, solve=1),
            lambda: costs_k(vc, dyn_v, k_, h_, seed=1, solve=1),
            lambda: kmod.fused_costs_plain(vc, dyn_v, k_, h_, seed=1,
                                           solve=1)),
            bound=bound_ms(4.0 * dyn_v.numel() + 4.0 * k_
                           + 4.0 * nb_ * pm.STATS, ops_c + extra))
    # dynamic_ab beside the constant-(A, B) kernel on the same map (the
    # seeded DMD and the point mass at mass 1): the cost of runtime
    # dynamics on this card; the bounds count dense A and B scale
    dc, pc, dyn_l, dyn_c = (dmd["fused"].consts, dmd["pm_fused"].consts,
                            dmd["dyn"], dmd["pm_dyn"])
    vt["pm_fused_solve[dynamic_ab]"] = dict(variant_times(
        lambda: pm.pm_fused_solve(pc, dyn_c, K, H, seed=1, solve=1),
        lambda: pm.pm_fused_solve(dc, dyn_l, K, H, seed=1, solve=1),
        lambda: pm.fused_solve_plain(dc, dyn_l, K, H, seed=1, solve=1)),
        bound=bound_ms(4.0 * dyn_l.numel() + part_bytes,
                       solve_ops(dc, K, H, prng=True)))
    vt["pm_fused_costs[dynamic_ab]"] = dict(variant_times(
        lambda: pm.pm_fused_costs(pc, dyn_c, K, H, seed=1, solve=1),
        lambda: pm.pm_fused_costs(dc, dyn_l, K, H, seed=1, solve=1),
        lambda: pm.fused_costs_plain(dc, dyn_l, K, H, seed=1, solve=1)),
        bound=bound_ms(4.0 * dyn_l.numel() + 4.0 * K + rows_b,
                       solve_ops(dc, K, H, prng=True, costs_only=True)))
    vt["dmd_mppi_next_ms_median"] = {
        "unnormalized": float(np.median(dmd_loops[False][0])),
        "normalized": float(np.median(dmd_loops[True][0]))}
    emit("variant_times", card=smi, **vt,
         note="ms: the variant; unvaried_ms: the same kernel without the "
              "schedule or antithetic at the same shapes and inputs, or "
              "for dynamic_ab with the constant (A, B) of the same map, "
              "timed in turns (unvaried, variant, variant, unvaried); point "
              "mass sched at K=100000, H=100, antithetic and dynamic_ab at "
              "H=50; AUV rk2 K=262144, H=25; NN 3x32 K=65536, H=25")

    src = "mppi_tf_tpu_torch/csrc/pm_mppi.cu"
    asrc = "mppi_tf_tpu_torch/csrc/auv_mppi.cu"
    kernels = [
        {"name": "pm_fused_solve", "route": "cuda", "source": src,
         "replaces": "mppi_tf_tpu/kernels/pm_mppi.py:1000",
         "launches": main_counts["pm_fused_solve"],
         "max_abs_err": main_chk["solve_only_max_abs_err"],
         "ms": t_solve, "plain_ms": p_solve, "bound_ms": b_solve[0],
         "bound_by": b_solve[1], "library_ms": None},
        {"name": "pm_merge", "route": "cuda", "source": src,
         "replaces": "mppi_tf_tpu/kernels/pm_mppi.py:1000",
         "launches": main_counts["pm_merge"],
         "max_abs_err": main_chk["merge_only_max_abs_err"],
         "ms": t_merge, "plain_ms": p_merge, "bound_ms": b_merge[0],
         "bound_by": b_merge[1], "library_ms": None},
        {"name": "pm_noise_dump", "route": "cuda", "source": src,
         "replaces": "mppi_tf_tpu/kernels/pm_mppi.py:274",
         "launches": noise["launches"], "path": "noise statistics check",
         "max_abs_err": noise["max_abs_err"],
         "ms": t_dump, "plain_ms": p_dump, "bound_ms": b_dump[0],
         "bound_by": b_dump[1], "library_ms": None},
        {"name": "pm_fused_costs", "route": "cuda", "source": src,
         "replaces": "mppi_tf_tpu/kernels/pm_mppi.py:1073",
         "launches": pm_norm_counts["pm_fused_costs"],
         "path": "point-mass normalized closed loop",
         "max_abs_err": err_pc,
         "ms": t_pmc, "plain_ms": p_pmc, "bound_ms": b_pmc[0],
         "bound_by": b_pmc[1], "library_ms": None},
        {"name": "mppi_weights", "route": "cuda", "source": src,
         "replaces": "mppi_tf_tpu/kernels/pm_mppi.py:191",
         "launches": dive_counts["mppi_weights"],
         "path": "AUV normalized closed loop (adim 6); adim 3 on the "
                 "point-mass normalized loop",
         "launches_adim3": pm_norm_counts["mppi_weights"],
         "max_abs_err": w6["wnoise_max_abs_err"],
         "max_abs_err_adim3": w3["wnoise_max_abs_err"],
         "ms": t_w6, "plain_ms": p_w6, "bound_ms": b_w6[0],
         "bound_by": b_w6[1], "ms_adim3": t_w3, "plain_ms_adim3": p_w3,
         "bound_ms_adim3": b_w3[0], "library_ms": None},
        {"name": "auv_fused_solve", "route": "cuda", "source": asrc,
         "replaces": "mppi_tf_tpu/kernels/auv_mppi.py:804",
         "launches": unnorm_counts["auv_fused_solve"],
         "path": "AUV unnormalized closed loop",
         "max_abs_err": auv_chk["fused_cost_stats_max_abs_err"],
         "max_abs_err_of": "merged cost min, max, mean of the fused rows "
                           "against the plain costs, K=262144, H=25",
         "softmax_vs_own_costs_max_abs_err": auv_chk["fused_max_abs_err"],
         "ms": t_asolve, "plain_ms": p_asolve, "bound_ms": b_asolve[0],
         "bound_by": b_asolve[1], "library_ms": None},
        {"name": "auv_fused_costs", "route": "cuda", "source": asrc,
         "replaces": "mppi_tf_tpu/kernels/auv_mppi.py:872",
         "launches": dive_counts["auv_fused_costs"],
         "path": "AUV normalized closed loop",
         "max_abs_err": auv_chk["costs_max_abs_err"],
         "ms": t_acosts, "plain_ms": p_acosts, "bound_ms": b_acosts[0],
         "bound_by": b_acosts[1], "library_ms": None},
    ]
    nsrc = "mppi_tf_tpu_torch/csrc/nn_mppi.cu"
    kernels += [
        {"name": "nn_fused_solve", "route": "cuda", "source": nsrc,
         "replaces": "mppi_tf_tpu/kernels/nn_mppi.py:631",
         "launches": nn_unnorm_counts["nn_fused_solve"],
         "path": "NN known-plant closed loop, unnormalized",
         "max_abs_err": nn_chk["fused_cost_stats_max_abs_err"],
         "max_abs_err_of": "merged cost min, max, mean of the fused rows "
                           "against the plain costs, K=65536, H=25, 3x32",
         "softmax_vs_own_costs_max_abs_err": nn_chk["fused_max_abs_err"],
         "ms": t_nsolve, "plain_ms": p_nsolve, "bound_ms": b_nsolve[0],
         "bound_by": b_nsolve[1], "library_ms": None},
        {"name": "nn_fused_costs", "route": "cuda", "source": nsrc,
         "replaces": "mppi_tf_tpu/kernels/nn_mppi.py:647",
         "launches": nn_norm_counts["nn_fused_costs"],
         "path": "NN known-plant closed loop, normalized",
         "max_abs_err": nn_chk["costs_max_abs_err"],
         "ms": t_ncosts, "plain_ms": p_ncosts, "bound_ms": b_ncosts[0],
         "bound_by": b_ncosts[1], "library_ms": None},
    ]
    tracking_rows = (
        ("pm_fused_solve[elipse]", src, "mppi_tf_tpu/kernels/pm_mppi.py:1000",
         "pm_elipse_solve", el_loops["auto", False][1]["pm_fused_solve"],
         "ellipse closed loop, unnormalized", el_chk["wnoise_max_abs_err"],
         "end-to-end weighted noise (action units) against the plain solve, "
         "K=100000, H=50"),
        ("pm_fused_costs[elipse]", src, "mppi_tf_tpu/kernels/pm_mppi.py:1073",
         "pm_elipse_costs", el_loops["auto", True][1]["pm_fused_costs"],
         "ellipse closed loop, normalized", el_chk["costs_max_abs_err"],
         "per-sample costs against the plain version, K=100000, H=50"),
        ("auv_fused_solve[waypoints_quat]", asrc,
         "mppi_tf_tpu/kernels/auv_mppi.py:804", "auv_waypoints_quat_solve",
         cli_out["waypoints_quat"][1]["auv_fused_solve"],
         "CLI tasks/waypoints_quat_task on envs/uuv_sim",
         wq_chk["fused_cost_stats_max_abs_err"],
         "merged cost min, max, mean of the fused rows against the plain "
         "costs, K=262144, H=25"),
        ("auv_fused_costs[waypoints_quat]", asrc,
         "mppi_tf_tpu/kernels/auv_mppi.py:872", "auv_waypoints_quat_costs",
         counts_m["auv_fused_costs"], "rexrov2 waypoint mission, normalized",
         wq_chk["costs_max_abs_err"],
         "per-sample costs against the plain version, K=262144, H=25"),
        ("auv_fused_solve[elipse3d]", asrc,
         "mppi_tf_tpu/kernels/auv_mppi.py:804", "auv_elipse3d_solve",
         e3_counts[False]["auv_fused_solve"],
         "3D ellipse loop on envs/bluerov, unnormalized",
         e3_chk["fused_cost_stats_max_abs_err"],
         "merged cost min, max, mean of the fused rows against the plain "
         "costs, K=262144, H=25"),
        ("auv_fused_costs[elipse3d]", asrc,
         "mppi_tf_tpu/kernels/auv_mppi.py:872", "auv_elipse3d_costs",
         e3_counts[True]["auv_fused_costs"],
         "3D ellipse loop on envs/bluerov, normalized",
         e3_chk["costs_max_abs_err"],
         "per-sample costs against the plain version, K=262144, H=25"))
    for name, source, replaces, key, launches, path, err, err_of in \
            tracking_rows:
        t = trk[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "path": path,
            "max_abs_err": err, "max_abs_err_of": err_of, "ms": t["ms"],
            "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": None})
    # the noise variants, with the launches of the loops run with them
    sl, al = sched["loops"], anti["loops"]
    asl, nsl = auv_sa["loops"], nn_sa_out["loops"]

    def worst(chk, key):   # over injected z and the Philox stream
        return max(chk[s][key] for s in ("injected", "philox"))

    pm_py, auv_py = "mppi_tf_tpu/kernels/pm_mppi.py", \
        "mppi_tf_tpu/kernels/auv_mppi.py"
    wn_of, c_of = ("weighted noise (action units) against the plain solve, "
                   "injected z and Philox, K=100000, H={}"), \
        "per-sample costs against the plain version, injected z and " \
        "Philox, K=100000, H={}"
    stats_of = ("merged cost min, max, mean of the fused rows against the "
                "plain costs, injected z, K={}, H=25")
    variant_rows = (
        ("pm_fused_solve[sched]", src, f"{pm_py}:1000",
         sl[False][1]["pm_fused_solve"],
         "point_mass_h100 closed loop, unnormalized",
         worst(sched["check"], "wnoise_max_abs_err"), wn_of.format(H100)),
        ("pm_fused_costs[sched]", src, f"{pm_py}:1073",
         sl[True][1]["pm_fused_costs"],
         "point_mass_h100 closed loop, normalized",
         worst(sched["check"], "costs_max_abs_err"), c_of.format(H100)),
        ("pm_fused_solve[antithetic]", src, f"{pm_py}:1000",
         al[False][1]["pm_fused_solve"],
         "antithetic point-mass loop, unnormalized",
         worst(anti["check"], "wnoise_max_abs_err"), wn_of.format(H)),
        ("pm_fused_costs[antithetic]", src, f"{pm_py}:1073",
         al[True][1]["pm_fused_costs"],
         "antithetic point-mass loop, normalized",
         worst(anti["check"], "costs_max_abs_err"), c_of.format(H)),
        ("pm_noise_dump[antithetic]", src, f"{pm_py}:274",
         anti["noise"]["launches"], "antithetic noise check",
         anti["noise"]["max_abs_err"],
         "the dump against the plain mirrored stream, K=100000, H=50"),
        ("mppi_weights[antithetic]", src, f"{pm_py}:191",
         al[True][1]["mppi_weights"],
         "antithetic point-mass loop, normalized (adim 3)",
         anti["w3"]["wnoise_max_abs_err"],
         "weighted noise (action units) against the plain version, "
         "K=100000, H=50"),
        ("mppi_weights[antithetic, adim 6]", src, f"{auv_py}:925",
         asl[True][1]["mppi_weights"],
         "AUV dive with the schedule and antithetic noise",
         anti["w6"]["wnoise_max_abs_err"],
         "weighted noise (action units) against the plain version, "
         "K=262144, H=25"),
        ("auv_fused_solve[sched, antithetic]", asrc, f"{auv_py}:804",
         asl[False][1]["auv_fused_solve"],
         "AUV unnormalized loop with both options",
         auv_sa["check"]["fused_cost_stats_max_abs_err"],
         stats_of.format(AUV_K)),
        ("auv_fused_costs[sched, antithetic]", asrc, f"{auv_py}:872",
         asl[True][1]["auv_fused_costs"],
         "AUV dive with both options", auv_sa["check"]["costs_max_abs_err"],
         "per-sample costs against the plain version, K=262144, H=25"),
        ("nn_fused_solve[sched, antithetic]", nsrc,
         "mppi_tf_tpu/kernels/nn_mppi.py:631",
         nsl[False][1]["nn_fused_solve"],
         "NN known-plant dive with both options, unnormalized",
         nn_sa_out["check"]["fused_cost_stats_max_abs_err"],
         stats_of.format(NN_K)),
        ("nn_fused_costs[sched, antithetic]", nsrc,
         "mppi_tf_tpu/kernels/nn_mppi.py:647",
         nsl[True][1]["nn_fused_costs"],
         "NN known-plant dive with both options, normalized",
         nn_sa_out["check"]["costs_max_abs_err"],
         "per-sample costs against the plain version, K=65536, H=25"),
        ("pm_fused_solve[dynamic_ab]", src, f"{pm_py}:1042",
         dmd_loops[False][1]["pm_fused_solve"],
         "the dmd row's closed loop, unnormalized (DMDMPPI)",
         max(worst(dmd["check"][n], "wnoise_max_abs_err")
             for n in ("seeded", "dense", "refit")),
         "weighted noise (action units) against the plain solve, injected "
         "z and Philox, seeded, dense random and refit (A, B), K=100000, "
         "H=50"),
        ("pm_fused_costs[dynamic_ab]", src, f"{pm_py}:1111",
         dmd_loops[True][1]["pm_fused_costs"],
         "the dmd row's closed loop, normalized (DMDMPPI)",
         max(worst(dmd["check"][n], "costs_max_abs_err")
             for n in ("seeded", "dense", "refit")),
         "per-sample costs against the plain version, injected z and "
         "Philox, seeded, dense random and refit (A, B), K=100000, H=50"))
    for name, source, replaces, launches, path, err, err_of in variant_rows:
        t = vt[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "path": path,
            "max_abs_err": err, "max_abs_err_of": err_of, "ms": t["ms"],
            "unvaried_ms": t["unvaried_ms"], "device_ms": t["device_ms"],
            "unvaried_device_ms": t["unvaried_device_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
