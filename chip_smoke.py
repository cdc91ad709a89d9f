#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root:  python3 chip_smoke.py

Builds the CUDA kernels of ``mppi_tf_tpu_torch`` from the sources in the
checkout (one nvcc per source, in parallel), holds each kernel against its
plain PyTorch version, checks the in-kernel noise stream, and drives the
port's paths through ``MPPI.next`` closed loop against the analytic plants:

- the point mass with the static cost at K=100,000 samples, H=50 (the
  fused solve; then the two-phase normalized solve), on the kernels'
  integrator instantiations; a dense-constant point mass (full sigma and
  Q) holds the dense ones against their plain versions and drives them in
  short loops;
- the rexrov2 AUV flagship with the static quaternion cost at K=262,144,
  H=25: the normalized dive (the two-phase solve: auv_fused_costs, then
  mppi_weights) and the unnormalized fused solve, both on the kernels'
  diagonal-constant instantiations (kDiag); a dense-constant vehicle (6x6
  damping, nonzero cog, full sigma and Q) holds the kDense ones against
  their plain versions and drives them in short loops;
- the learned NNAUVModel (3x32 MLP) with the static quaternion cost at
  K=65,536, H=25: its kernels (the MLP on the tensor cores: 3xTF32, and
  bf16 products for a bf16-compute model) against their plain versions,
  then a dive
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
  ``--model models/dmd_model``;
- the model-based RL loop (``mbrl``): 264 random-action transitions of
  the known-plant network (12 episodes from random attitudes) into the
  learner's native replay buffer, a 3x32 NNAUVModel learned from them on
  the card (held below a tenth of the stay-put error), the NN kernels at
  K=65,536, H=25 against their plain versions on the learned weights
  written through ``MPPI.model_params`` and again after a rewrite, the
  80-step dive with a refit every 20 steps in each solve mode (solve steps
  held to one sync a step, refits profiled apart), ``run_experiment(
  train_every=10)`` on the point mass at K=100,000, H=50 with the live mass
  and the solve's 1/mass held to the learner's at every refit, and the
  CLI with ``-t``; and the NN kernels against their plain versions on
  weights learned from one episode (a constant feature, x_std 1e-8: the
  case the kernels' former fold of the normalisers cancelled);
- the on-device loop (``envs/mjx_env.py``): the JAX bench's three
  on-device rows at full width, each control period one captured CUDA
  graph replayed (the point mass at K=100,000, H=50, 500 periods of 10
  plant steps; the adaptive DMD with its refit captured too, 200 periods;
  the rexrov2 two-leg mission at K=65,536, H=15, 200 periods, the pops on
  the device), each held to its gates, to the eager periods bit for bit,
  to one host sync a run, to a host ``next`` drawing the next solve index,
  and its kernels' device solve index to the int's bits (below and past
  2^32), and timed beside the host-driven loop of the same cell;
- the fleet (``controller/fleet.py``): the JAX bench's two fleet rows at
  full width, 32 point masses and 16 rexrov2s at K=8,192, H=25, each in
  the bench's solve mode and normalized: every kernel with a vehicle axis
  (the solve and costs, phase B, the merge) in one launch over all
  vehicles against n one-vehicle launches with solve s n + v and at n = 1
  against the one-vehicle entry, bit for bit, and against its plain
  version; 300 host-driven steps (one sync a step, the solve launched
  once a step for the whole fleet, timed in turns against n one-vehicle
  launches) and the on-device fleet loop (one captured graph a period,
  replayed == eager, a re-task between runs without a recapture), each
  held to its vehicles' goals;
- multi-GPU and sharding (``parallel/``, the ``sharded`` phase; n shards
  or ranks on ONE card, the sharding's overhead, not multi-GPU scaling):
  a mesh of one shard against the single-device kernels bit for bit; 4
  shards (K_local 25,000) on injected z against the single-device solve
  and against an f64 merge of their rows; the headline loop in both
  modes on 4 shards beside one device, in turns; the rexrov2 dive and
  the adaptive DMD row on 4 shards; 2 x 1 and 2 x 2 ranks in processes
  of their own on the card over gloo, bit for bit equal to local meshes;
  the dp x tp train step on 2 x 2 ranks against one device's Adam steps;
  a one-rank NCCL group's solve bits and its on-device loop captured with
  the all-reduce in the graph; the ``on_device_loop`` row on 4 shards
  (replay == eager, one sync a run); the 32-point-mass fleet split over 4
  shards on the torch route;
- serving and tooling (ROADMAP item 15): the headline controller behind
  the port's ``ControlServer`` driven 300 closed-loop steps by a
  ``ControlClient`` (held to the goal, to one launch of the solve and the
  merge a request, and bit for bit to a twin controller driven directly),
  100 m-step requests and an over-long one refused (``serve``); the
  32-point-mass fleet behind the coalescer, one client thread a vehicle,
  100 lockstep rounds, each reply its dispatch's row bit for bit and one
  launch a dispatch (``serve_fleet``); the headline kernel solve and the
  plain f32 path against the native f64 core (``native_golden``); the
  card's ceilings from the microbenchmarks of ``csrc/roofline.cu`` beside
  the datasheet peaks and the headline's share of its roofline
  (``roofline``); ``sweep.main`` over two lambdas on the card (``sweep``);
- the bf16 block compute (``kernel_dtype="bfloat16"``): every bf16 kernel
  against its plain bf16 version on injected z and the Philox stream
  (point mass K=100,000, H=50 with constant and dynamic (A, B), the (4, 2)
  ellipse at K=700, H=7, the AUV rk2 at K=262,144, H=25 and rk4 at K=700,
  H=7, the NN 3x32 at K=65,536, H=25, and the NN's bf16-products build for
  a bf16-compute model), held to a hundredth of its f32 build's gap from
  that plain version, and every other bf16 instantiation at K=700, H=7;
  phase B at bf16; the bf16 noise dump against the rounded
  f32 dump, bit for bit; point_mass_bf16, DMDMPPI, the AUV dive and
  unnormalized steps and the NN dives at bf16 (and with a bf16-compute
  model) on the kernels, each at its f32 twin's gate, one sync a step.

The build phase reports each instantiation's registers beside the count
the f32 ones had before the bf16 builds were added (PERF.md), the static
SASS counts of the point-mass, AUV and NN kernels (``sass``: tensor-core
HMMA, conversions, bf16x2 ops, f32 ops, loads) and every solve
instantiation's blocks an SM and waves at the flagship shapes
(``occupancy``), and fails on a spill, on an f32 point-mass
instantiation that needs more than one wave at K=100,000, or on an f32
or bf16-products NN instantiation without HMMA in its SASS.
With ``--parent DIR`` (a checkout of the parent commit) it also builds
that tree's library and holds this tree's kernels against it
(``parent_bits``: the noise dump, f32 and bf16, plain and antithetic, at
PARENT_DUMP_SHAPES and with the solve index on the device, bit for bit;
phase B and every solve and costs kernel bit for bit; pm_merge against
an f64 merge of the same rows, m and the cost min / max exact and the
sums within MERGE_L1_TOL of each column's l1 mass, the parent's merge
beside, two merges equal), times the two in turns (``parent_times``,
beside an empty kernel's launch floor; it fails unless the dump beats
the parent's at the headline shape and stays within DUMP_LOG_SLACK_MS of
it at the log shape) and the wall time of MPPI.next in the headline
point mass, ``point_mass_h100`` and the AUV dive on either library in
turns (``parent_loops``). It
times every kernel, each noise variant beside the same kernel without
it, the dynamic_ab variant beside the constant-(A, B) kernel and each
bf16 build beside its f32 build, and ``torch.randn`` at the noise dump's
shape as the dump's ``library_ms``. Each phase prints one JSON line; any
failed check raises and the script exits non-zero. Without a CUDA device
it exits non-zero before printing any result.

The last lines are the ``kernels`` JSON line, the card's name and power
limit as ``nvidia-smi`` prints them, and
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

# the counts of the kernels' work and their datasheet bounds (H100 SXM:
# PEAK_OPS f32, PEAK_BYTES HBM, the tensor-core peaks; OPS_PER_NORMAL a
# generated normal): one count, in the port's roofline module
from mppi_tf_tpu_torch.roofline import (OPS_PER_NORMAL, PEAK_BYTES,
                                        PEAK_OPS, auv_solve_ops, bf16_bound,
                                        bf16_rollout_ops, bound_ms,
                                        mirror_saving, nn_solve_ops,
                                        nn_tc_bound, sched_ops, solve_ops,
                                        weights_ops)

# the workload of the main path (mppi_tf_tpu/bench.py::_build_workload,
# "point_mass"): 3-DoF point mass, state 6, action 3
K, H = 100_000, 50
SIGMA = np.diag([0.25, 0.25, 0.25])
LAM, GAMMA, UPSILON, MASS, DT = 0.8, 0.2, 1.0, 1.0, 0.1
GOAL = [1.0, 0.0, 0.5, 0.0, -0.5, 0.0]
Q = [5.0, 1.0, 5.0, 1.0, 5.0, 1.0]
LOOP_STEPS = 300
GOAL_TOL = 0.05

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
# the dense-constant vehicle's loops (a path for the kDense kernels, each
# mode; gated on finite states and the quaternion's norm)
DENSE_STEPS = 20
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
# the model-based RL loop (mbrl): the JAX Learner's buffer of 264
# transitions from the known plant, uniform random actions in
# [-MBRL_ACT_MAX, MBRL_ACT_MAX]^6, in MBRL_EPISODES episodes from rest at
# random attitudes (quaternion vector part N(0, MBRL_ATTITUDE^2) before
# normalising): from one attitude the quaternion features are constant
# and stats() leaves their std at 1e-8, which a fold of the normalisers
# into the first layer cancels (ROADMAP §3; the kernels normalise in f32,
# held on one episode's weights too, MBRL_ONE_EPISODE_SEED);
# a 3x32 NNAUVModel (seed
# MBRL_SEED) learned with MBRL_EPOCHS of Adam at MBRL_LR; the refits at the
# Learner's defaults (100 epochs at 1e-3), as MBRL_REWRITE_EPOCHS more
# before the rewrite check; the dive with refits every MBRL_TRAIN_EVERY
# steps, unnormalized, then normalized with the same learner. Gates:
# one-step MSE on the buffer below MBRL_MSE_SHARE of the stay-put baseline
# (tests/test_mbrl_e2e.py:47-54); |z + 1| below MBRL_LOOP_TOL after each
# dive, the known-plant dive's gate: the same loops at K=1,024 on the CPU
# end 0.093 / 0.123 (port) and 0.066 / 0.134 (JAX) from z = -1
# (tests/test_torch_mbrl.py::test_mbrl_dives_in_both_packages)
MBRL_BUFFER, MBRL_EPISODES, MBRL_ACT_MAX, MBRL_ATTITUDE = 264, 12, 10.0, 0.2
MBRL_SEED, MBRL_EPOCHS, MBRL_LR, MBRL_REWRITE_EPOCHS = 5, 300, 1e-2, 100
MBRL_TRAIN_EVERY, MBRL_MSE_SHARE, MBRL_LOOP_TOL = 20, 0.1, NN_LOOP_TOL
# the constant-feature case: MBRL_BUFFER transitions of one episode from
# rest (one attitude), actions in +-MBRL_ACT_MAX, collection seed 1
MBRL_ONE_EPISODE_SEED = 1
# the analytic learner at the headline width: run_experiment on the
# bundled point mass (model mass 5, plant mass 1) at K, H, a refit every
# MBRL_PM_TRAIN_EVERY steps; the CLI with -t MBRL_CLI_TRAIN at K=3,000
MBRL_PM_STEPS, MBRL_PM_TRAIN_EVERY = 50, 10
MBRL_CLI_STEPS, MBRL_CLI_TRAIN = 20, 5
# the on-device loop (ROADMAP item 13): the JAX bench's three on-device rows
# at full width (mppi_tf_tpu/bench.py:418-560, 722-790), one captured CUDA
# graph a control period. on_device_loop: the point mass at K, H, OD_STEPS
# periods of OD_SUBSTEPS plant steps at dt 0.01 (gate: GOAL_TOL);
# on_device_adaptive_dmd: K, H, DMD_ADAPT_STEPS periods, a refit every
# DMD_REFIT, a mass-1 prior against the mass-DMD_PLANT_MASS plant, reg
# DMD_REG (gates: DMD_B_TOL, DMD_GOAL_TOL); on_device_auv_mission: rexrov2
# at OD_AUV_K, OD_AUV_H, OD_AUV_STEPS periods of DIVE_SUBSTEPS at dt 0.02,
# the two legs at z = -1, -2, radius AUV_WP_RADIUS, normalized (gates: one
# pop; after it the dive comes within AUV_WP_TOL of z = -2, and again
# within the last OD_AUV_SETTLE periods: the vehicle overshoots the last
# leg near period 200, in the JAX package too, so the final state alone is
# not the gate). Each row beside OD_TWIN_STEPS profiled steps of its
# host-driven loop (MPPI.next and the host plant); the kernels' device
# solve index held to the int at 5 and OD_HIGH_SOLVE (past 2^32); the
# row's kernels against their plain versions at its own K and H. A row's
# launches are read from the profiler by kernel name (OD_KERNEL_RX: the
# solve kernels by their MODE template argument, 0 fused, 1 costs). At
# these rates (~0.5-0.7 M kernels/s) the profiler lost up to 5 of a run's
# 500 solve kernels in about one run of four on the H100, so a row is
# profiled again while its count falls short, up to OD_PROFILE_TRIES
# (``profiled_counts``), and passes when one try falls short of each
# launch count by at most PROFILE_LOSS of it (one record at least) and no
# try is above (``profile_ok``). The profiler's misses on the H100, while
# the wrappers counted every launch and the replayed periods equalled the
# eager ones bit for bit: up to 5 of 500 solves (on_device_loop), 3 whole
# periods of 300 (the normalized point-mass fleet: 297 costs, 594 merges),
# one auv_fused_costs record in every profile of a run (19 of 20, 319 of
# 320), and 1 to 4 of 2,000 solves and merges in every profile of a run
# (the sharded on-device loop; PERF.md). The wrappers' counts stay exact
# gates; the profiler's count is the device's side of them
OD_STEPS, OD_SUBSTEPS = 500, 10
OD_AUV_K, OD_AUV_H, OD_AUV_STEPS, OD_AUV_SETTLE = 65_536, 15, 200, 50
OD_TWIN_STEPS, OD_STEP0, OD_HIGH_SOLVE = 20, 1000, 2 ** 32 + 12_345
OD_PROFILE_TRIES, PROFILE_LOSS = 3, 0.01
OD_KERNEL_RX = {"pm_fused_solve": r"\bpm_fused_solve_kernel<\d+, \d+, 0,",
                "auv_fused_costs": r"\bauv_fused_solve_kernel<\d+, 1,",
                "mppi_weights": r"\bmppi_weights_kernel\b",
                "pm_merge": r"\bpm_merge(_stats)?_kernel\b"}

# the fleet (controller/fleet.py): the JAX bench's two fleet rows
# (mppi_tf_tpu/bench.py:786-830, 1300-1312) at full width, 32 point masses
# (the point-mass workload, goals[:, 0::2] = uniform(-1, 1)) and 16
# rexrov2s (the flagship task at AUV_SIGMA, lam 0.5, depths uniform(-2,
# 0)), both from default_rng(0), K=8,192, H=25, FLEET_STEPS chained steps
# with the model itself as the plant (one step of dt a period), as the
# bench chains them; each row in the bench's solve mode (unnormalized)
# and normalized (the costs and phase-B kernels), host-driven and as the
# on-device fleet loop. Gates (PERF.md, stated before the first run): each
# point mass within FLEET_PM_TOL of its goal (the headline's GOAL_TOL;
# <= 0.004 after 50 steps at K=8,192 on the CPU), each normalized rexrov2
# within FLEET_AUV_TOL of its depth (the dive's DIVE_TOL) with |q| = 1
# within 1e-3; the unnormalized rexrov2 swings +-1 m about its depth at
# this K on the CPU, so its gate is |q| and finite states. Vehicle 0 of
# each point-mass row is re-tasked to FLEET_RETASK between two on-device
# runs and must reach it with no recapture. A step's solve kernel runs
# once for the whole fleet (the profiler's count by kernel name,
# FLEET_KERNEL_RX); FLEET_TWIN_STEPS host steps are timed in turns as the
# fleet launch and as n one-vehicle launches
FLEET_K, FLEET_H, FLEET_STEPS, FLEET_TWIN_STEPS = 8192, 25, 300, 20
FLEET_PM_N, FLEET_AUV_N = 32, 16
FLEET_PM_TOL, FLEET_AUV_TOL = GOAL_TOL, DIVE_TOL
FLEET_RETASK = [-0.6, 0.0, 0.3, 0.0, 0.8, 0.0]
FLEET_KERNEL_RX = {**OD_KERNEL_RX,
                   "pm_fused_costs": r"\bpm_fused_solve_kernel<\d+, \d+, 1,",
                   "auv_fused_solve": r"\bauv_fused_solve_kernel<\d+, 0,"}

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
# registers a thread of every f32 instantiation before the bf16 builds
# were added (that tree's _build.ptxas_report() on the H100, PERF.md),
# reported beside this build's (f32_moved). Not a gate: ptxas's count for
# an instantiation moves with the rest of its translation unit (the
# earlier auv_mppi.cu itself, compiled from another directory, reads
# another count for the instantiation that moves here; PERF.md), so a
# spill is the gate and the f32 kernels' checks against their plain
# versions hold their arithmetic. The AUV's are its kDense instantiations
# (the fourth template argument 0, added with kDiag), the point mass's its
# dense ones (the sixth, STRUCT 0, added with kIntegrator); the noise
# dump's are those of its redesign (<CH>: one and two chains a pass)
BASE_REGISTERS = {
    **{("auv_fused_solve_kernel", (*a, 0)): r for a, r in (
        ((1, 0, 0), 170), ((1, 0, 1), 163), ((1, 0, 2), 164),
        ((1, 1, 0), 171), ((1, 1, 1), 163), ((1, 1, 2), 162),
        ((2, 0, 0), 195), ((2, 0, 1), 205), ((2, 0, 2), 203),
        ((2, 1, 0), 217), ((2, 1, 1), 206), ((2, 1, 2), 201),
        ((4, 0, 0), 210), ((4, 0, 1), 199), ((4, 0, 2), 199),
        ((4, 1, 0), 223), ((4, 1, 1), 209), ((4, 1, 2), 211))},
    ("mppi_weights_kernel", ()): 32,
    **{("nn_fused_solve_kernel", a): r for a, r in (
        ((8, 8, 0, 0), 78), ((8, 8, 0, 1), 80), ((32, 32, 32, 0), 174),
        ((32, 32, 32, 1), 180))},
    **{("pm_fused_solve_kernel", (*a, 0)): r for a, r in (
        ((2, 1, 0, 0, 0), 32), ((2, 1, 0, 0, 1), 40), ((2, 1, 1, 0, 0), 32),
        ((2, 1, 1, 0, 1), 40), ((4, 2, 0, 0, 0), 40), ((4, 2, 0, 0, 1), 63),
        ((4, 2, 0, 1, 0), 40), ((4, 2, 0, 1, 1), 60), ((4, 2, 1, 0, 0), 40),
        ((4, 2, 1, 0, 1), 64), ((4, 2, 1, 1, 0), 40), ((4, 2, 1, 1, 1), 63),
        ((6, 3, 0, 0, 0), 48), ((6, 3, 0, 0, 1), 99), ((6, 3, 1, 0, 0), 48),
        ((6, 3, 1, 0, 1), 98))},
    ("pm_merge_kernel", ()): 35,
    ("pm_noise_dump_kernel", (1,)): 40,
    ("pm_noise_dump_kernel", (2,)): 40,
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


class KnownPlant:
    """The known-plant network (``known_plant_params``) at f64 on the CPU
    as an env: ``getState`` / ``getTime`` / ``getGoal`` / ``step`` /
    ``reset``, one step of ``dt`` a control step."""

    def __init__(self, dt: float = 0.1):
        from mppi_tf_tpu_torch.interop import from_jax_params
        from mppi_tf_tpu_torch.models.nn import NNAUVModel

        self.dt = float(dt)
        self.model = NNAUVModel(dt=dt, dtype=torch.float64)
        from_jax_params(known_plant_params(dt), None, self.model)
        self.reset()

    def reset(self, x0=None) -> np.ndarray:
        self._x = (rest_state() if x0 is None
                   else np.asarray(x0, np.float64).reshape(-1).copy())
        self._t = 0.0
        return self.getState()

    def getState(self) -> np.ndarray:
        return self._x.reshape(-1, 1).copy()

    def getTime(self) -> float:
        return self._t

    def getGoal(self):
        return None

    def step(self, u, goal=None) -> np.ndarray:
        with torch.no_grad():
            self._x = self.model.predict(
                torch.from_numpy(self._x),
                torch.as_tensor(np.ravel(u), dtype=torch.float64)).numpy()
        self._t += self.dt
        return self.getState()


def mbrl_collect(collect, plant, buffer, seed: int = 0):
    """MBRL_BUFFER transitions of ``plant`` into ``buffer`` through
    ``collect`` (either package's ``collect_transitions``): MBRL_EPISODES
    episodes from rest at a random attitude, the actions of episode e from
    ``np.random.default_rng(seed + 1 + e)``."""
    rng = np.random.default_rng(seed)
    lim = MBRL_ACT_MAX * np.ones(6)
    for ep in range(MBRL_EPISODES):
        x0 = rest_state()
        q = np.append(MBRL_ATTITUDE * rng.standard_normal(3), 1.0)
        x0[3:7] = q / np.linalg.norm(q)
        plant.reset(x0)
        collect(plant, buffer, MBRL_BUFFER // MBRL_EPISODES, 6, -lim, lim,
                seed=seed + 1 + ep, control_dt=plant.dt)
    return buffer


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def kernel_key(mangled: str):
    """(kernel name, template arguments) of a mangled kernel name, e.g.
    ``26pm_fused_solve_bf16_kernelILi6E...`` -> ("pm_fused_solve_bf16_kernel",
    (6, ...))."""
    import re

    m = re.search(r"\d((?:pm|auv|nn|mppi)_[a-z0-9_]*?_kernel)(?=I|E)"
                  r"(?:I((?:Li-?\d+E)+)E)?", mangled)
    if m is None:
        return None
    return m.group(1), tuple(int(a) for a in re.findall(
        r"Li(-?\d+)E", m.group(2) or ""))


def registers_vs_base(ptxas: list) -> list:
    """Each instantiation's registers beside ``BASE_REGISTERS`` (null for
    the bf16 builds, new here), by kernel name and template arguments
    (``kernel_key``)."""
    rows = []
    for r in ptxas:
        name, args = kernel_key(r["kernel"])
        rows.append({"kernel": name, "template": list(args),
                     "registers": r.get("registers"),
                     "base": BASE_REGISTERS.get((name, args))})
    return rows


def dense_pm_constants(sigma, q):
    """(sigma, Q) of the dense-constant point mass, whose solves run the
    dense kernels: ``sigma`` with correlations of 0.01 and the diagonal
    ``q`` with off-diagonal terms of 0.1, so that B scale, Mz and Q are
    full (tests/test_torch_cuda.py holds the same kind of point mass)."""
    adim, sdim = np.shape(sigma)[0], len(q)
    return (np.asarray(sigma) + 0.01 * (1.0 - np.eye(adim)),
            np.diag(q) + 0.1 * (1.0 - np.eye(sdim)))


#: the dense-constant point mass's sigma and Q at the workload's widths
PM_DENSE_SIGMA, PM_DENSE_Q = dense_pm_constants(SIGMA, Q)


def workload(device, dmd: bool = False, dense: bool = False):
    """The point-mass workload's model and cost; with ``dmd``, the JAX
    bench's dmd row: a DMDModel seeded with the point mass's (A, B); with
    ``dense``, the cost of the dense-constant point mass (PM_DENSE_Q, at
    PM_DENSE_SIGMA)."""
    from mppi_tf_tpu_torch.costs import get_cost
    from mppi_tf_tpu_torch.models import get_model
    from mppi_tf_tpu_torch.models.dmd import DMDModel

    model = get_model({"type": "point_mass", "mass": MASS}, dt=DT,
                      state_dim=6, action_dim=3, device=device)
    if dmd:
        model = DMDModel(6, 3, dt=DT, init_A=model.A.cpu().numpy(),
                         init_B=model.B.cpu().numpy() / MASS, device=device)
    task = ({"type": "static", "diag": False, "goal": GOAL,
             "Q": PM_DENSE_Q.tolist()} if dense else
            {"type": "static", "diag": True, "goal": GOAL, "Q": Q})
    cost = get_cost(task, lam=LAM, gamma=GAMMA, upsilon=UPSILON,
                    sigma=PM_DENSE_SIGMA if dense else SIGMA, device=device)
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


def device_ms(fn, reps: int = 50, rx=None) -> float:
    """The device time of one launch of ``fn``'s kernel (``fn`` launches
    one; with ``rx``, of the kernel whose name matches it among those
    ``fn`` launches), from ``torch.profiler`` over ``reps`` calls: without
    the host's launch cost, which back-to-back CUDA-event timing includes
    where a kernel is shorter than its launch. The mean is over the
    launches the profiler recorded, which may be fewer than ``reps``; a
    window in which it recorded none of them is profiled again, up to
    OD_PROFILE_TRIES windows (the profiler loses records, PROFILE_LOSS),
    and after that reads 0."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(OD_PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and (rx is None or re.search(rx, e.key))]
        count = sum(e.count for e in kern)
        if count:
            return sum(e.self_device_time_total for e in kern) / count / 1e3
    return 0.0


def close(a: torch.Tensor, b: torch.Tensor, rtol: float, atol: float):
    """(ok, max abs err, max err / (atol + rtol |b|)) of a against b."""
    err = (a.double() - b.double()).abs()
    ratio = (err / (atol + rtol * b.double().abs())).max().item()
    return ratio <= 1.0, err.max().item(), ratio


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
                  tau: int = H, dmd: bool = False, dense: bool = False,
                  **extra):
    """The point-mass workload's controller (``dmd``: the DMD row's, a
    DMDMPPI; ``dense``: the dense-constant point mass's) through
    get_controller at K and horizon ``tau``, with env-config keys
    ``extra``."""
    from mppi_tf_tpu_torch.controller import get_controller

    model, cost = workload("cuda", dmd, dense)
    cfg = {"samples": K, "horizon": tau, "lambda": LAM, "upsilon": UPSILON,
           "noise": (PM_DENSE_SIGMA if dense else SIGMA).tolist(),
           "kernel": kernel, "normalize": normalize, **extra}
    return get_controller(model, cost, cfg)


def check_pm_structure(ctrl, want: str, label: str) -> None:
    """A point-mass controller on the kernels runs the ``want`` structure
    (integrator: the point mass's own constants at f32; dense: a full
    sigma or Q, dynamic (A, B), bf16)."""
    got = ctrl._fused.consts.structure if ctrl.kernel_path == "cuda" else None
    if got != want:
        raise AssertionError(f"{label}: structure {got}, want {want}")


def closed_loop(kernel: str, normalize: bool = False,
                steps: int = LOOP_STEPS, tau: int = H, errs=None,
                dmd: bool = False, dense: bool = False, **extra):
    """K=100k closed loop (H=50, or ``tau``) through the factories against
    the analytic plant, with env-config keys ``extra`` ("noise-schedule",
    "antithetic"); returns (controller, final goal error, per-step host
    ms, launch counts), and appends each step's goal error to ``errs``
    when given. On the kernels, the solve's structure is held to the
    integrator for the point mass at f32 and to dense for ``dmd``,
    ``dense`` or bf16 (check_pm_structure)."""
    from mppi_tf_tpu_torch.envs import PointMassEnv
    from mppi_tf_tpu_torch.kernels import pm_mppi as pm

    ctrl = pm_controller(kernel, normalize, tau, dmd, dense, **extra)
    if ctrl.kernel_path == "cuda":
        check_pm_structure(
            ctrl, "dense" if dmd or dense
            or ctrl._fused.compute_dtype == "bfloat16" else "integrator",
            f"point-mass loop (dmd={dmd}, dense={dense}, {extra})")
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


def profile_run(run, steps: int, count=None) -> dict:
    """``torch.profiler`` over ``run()``, ``steps`` control steps: device
    busy share = summed kernel time / wall time (one stream, so kernels do
    not overlap); synchronising CUDA runtime calls per step (the action's
    copy to the host is one); the host µs of a ``cudaGraphLaunch`` where
    ``run`` replays graphs (profiled, so an upper bound). ``count``
    ({label: regex}): also the number of kernels the device ran whose
    names match each regex, in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    # a range a host function annotates (Adam's "Optimizer.step#Adam.step")
    # is listed on the device too, spanning its kernels: not a kernel
    host = {e.key for e in events if e.device_type == DeviceType.CPU}
    kern = [e for e in events
            if e.device_type == DeviceType.CUDA and e.key not in host]
    dev_us = sum(e.self_device_time_total for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    syncs = {e.key: e.count / steps for e in events
             if e.device_type == DeviceType.CPU and "Synchronize" in e.key}
    graph = [e for e in events if e.device_type == DeviceType.CPU
             and e.key == "cudaGraphLaunch"]
    return {
        "steps": steps, "wall_us_per_step": wall_us / steps,
        "device_us_per_step": dev_us / steps,
        "device_busy_share": dev_us / wall_us,
        "kernel_launches_per_step": sum(e.count for e in kern) / steps,
        "syncs_per_step": syncs,
        "top_kernels_us_per_step": {
            e.key[:60]: e.self_device_time_total / steps for e in top},
        **({"graph_launch_host_us": graph[0].cpu_time_total
            / graph[0].count} if graph else {}),
        **({"kernel_counts": {
            label: sum(e.count for e in kern if re.search(rx, e.key))
            for label, rx in count.items()}} if count else {}),
    }


def profiled_counts(run, steps: int, expected: dict, rx: dict) -> tuple:
    """``profile_run`` over ``run()`` with the kernels of ``expected``
    ({label: launches}) counted by name (``rx``), profiled again while a
    count falls short, up to OD_PROFILE_TRIES, and not after a count above
    it. Returns the last profile and every try's counts."""
    tries = []
    while len(tries) < OD_PROFILE_TRIES:
        prof = profile_run(run, steps, count={n: rx[n] for n in expected})
        tries.append(prof["kernel_counts"])
        if tries[-1] == expected or any(tries[-1][n] > c
                                        for n, c in expected.items()):
            break
    return prof, tries


def profile_ok(tries: list, expected: dict) -> bool:
    """No try counts a kernel more often than it was launched, and one try
    falls short of every launch count by at most PROFILE_LOSS of it (one
    record at least)."""
    above = any(t[n] > c for t in tries for n, c in expected.items())
    near = any(all(t[n] >= c - max(1, int(c * PROFILE_LOSS))
                   for n, c in expected.items()) for t in tries)
    return near and not above


def rest_state() -> np.ndarray:
    """The AUV at rest at the surface, unit quaternion qw = 1."""
    x = np.zeros(13)
    x[6] = 1.0
    return x


def dense_constants(params: dict, sigma, task: dict):
    """(params, sigma, task) of the dense-constant vehicle, whose solves run
    the kDense kernels: the rexrov2 ``params`` with 6x6 linear damping (its
    diagonal plus off-diagonal terms), 6x6 forward-speed damping and a
    nonzero cog; ``sigma`` with correlations of 0.02; a quaternion
    ``task``'s Q with off-diagonal terms of 0.2 (tests/test_torch_cuda.py
    holds the same vehicle)."""
    rng = np.random.RandomState(7)
    params = {**params, "cog": [0.01, -0.02, 0.05],
              "linear_damping": (np.diag(params["linear_damping"])
                                 + 5.0 * rng.randn(6, 6)).tolist(),
              "linear_damping_forward_speed": (20.0 * rng.randn(6, 6)
                                               ).tolist()}
    sd = np.sqrt(np.diag(sigma))
    sigma = np.diag(np.diag(sigma)) + 0.02 * np.outer(sd, sd) * (
        1.0 - np.eye(6))
    if task["type"] != "elipse3d":
        task = {**task, "diag": False, "Q": (np.diag(task["Q"]) + 0.2 * (
            np.ones((10, 10)) - np.eye(10))).tolist()}
    return params, sigma, task


#: the dense-constant vehicle's upsilon: the z-quadratic runs
DENSE_UPSILON = 1.2
#: its end-to-end cases at K=700, H=7 (the kDense solve's wnoise against
#: the plain solve): a sigma a hundredth of the small cases' and lambda 50
#: and 5, so that the softmax is not degenerate. This case's costs give an
#: ESS of ~634 of 700 at lambda 50 and ~204 at lambda 5, at rk 1, 2 and 4
#: (the small cases': ~2-3, where a cost's last ulp moves the wnoise past
#: 1e-3); gated at DENSE_E2E_MIN_ESS. check_auv holds the fused rows to
#: block_partials of the costs kernel's costs at an atol of 1e-5 (z
#: units): the two modes give every sample the same cost and exponent bits
#: (mode_bits), and block_partials divides by lambda as the kernels do (on
#: the card a Python-scalar divisor is a product with its rounded
#: reciprocal, an ulp off for ~1 exponent in 5: 1e-5 to 2.5e-5 at lambda 5)
DENSE_E2E_SIGMA = np.diag([0.4] * 3 + [0.05] * 3)
DENSE_E2E_LAMS, DENSE_E2E_MIN_ESS = (50.0, 5.0), 50.0


def auv_modules(device, task, sigma, lam=AUV_LAM, rk=2, dense=False,
                upsilon=None):
    """The rexrov2 model at ``rk`` and the cost of ``task`` at ``sigma``,
    ``lam`` and AUV_UPSILON, or with ``dense`` those of the dense-constant
    vehicle (dense_constants) at DENSE_UPSILON; ``upsilon`` overrides
    either: (model, cost, sigma, upsilon)."""
    from mppi_tf_tpu_torch import flagship
    from mppi_tf_tpu_torch.costs import get_cost
    from mppi_tf_tpu_torch.models import get_model

    params, ups = flagship.auv_params(), AUV_UPSILON
    if dense:
        params, sigma, task = dense_constants(params, sigma, task)
        ups = DENSE_UPSILON
    ups = ups if upsilon is None else upsilon
    model = get_model({**params, "rk": rk}, dt=0.1, device=device)
    cost = get_cost(task, lam=lam, gamma=AUV_GAMMA, upsilon=ups,
                    sigma=sigma, device=device)
    return model, cost, sigma, ups


def auv_fused(k, tau, rk=2, sigma=AUV_SIGMA, kind="static_quat",
              dense=False, upsilon=None, lam=None, **opts):
    """FusedAUVMPPI over rexrov2 at ``rk``: the flagship task at ``sigma``
    ("static_quat"), or the bundled tasks/waypoints_quat_task on
    envs/uuv_sim and tasks/elipse3d_task on envs/bluerov at their sigma
    and lambda; ``dense``: the dense-constant vehicle; ``upsilon`` as in
    auv_modules; ``lam`` overrides the lambda."""
    from mppi_tf_tpu_torch import flagship
    from mppi_tf_tpu_torch.cfg import default_config
    from mppi_tf_tpu_torch.kernels import auv_mppi as auv

    task, lam_kind = flagship.auv_task(), AUV_LAM
    if kind != "static_quat":
        env = default_config("envs/uuv_sim" if kind == "waypoints_quat"
                             else "envs/bluerov")
        task = dict(default_config(f"tasks/{kind}_task"))
        sigma, lam_kind = np.asarray(env["noise"], np.float64), env["lambda"]
    lam = lam_kind if lam is None else lam
    model, cost, sigma, ups = auv_modules("cuda", task, sigma, lam=lam,
                                          rk=rk, dense=dense, upsilon=upsilon)
    return auv.FusedAUVMPPI(model, cost, k=k, tau=tau, lam=lam, upsilon=ups,
                            sigma=sigma, **opts)


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


def mode_bits(auv, fused, dyn, z, label: str) -> dict:
    """The AUV fused kernel's per-sample costs and exponents against the
    costs kernel's, bit for bit, on injected z: each sample's z repeated
    over a block of 256 (a fused solve of k * 256 samples), so that block
    b's cost min and max are sample b's cost in the fused mode and its m_b
    is that sample's -cost / lam; fails on any difference."""
    k, tau, c = fused.k, fused.tau, fused.consts
    costs, _ = auv.auv_fused_costs(c, dyn, k, tau, z=z)
    rows = auv.auv_fused_solve(c, dyn, k * 256, tau,
                               z=z.repeat_interleave(256, dim=2).contiguous())
    zarg = -costs / torch.as_tensor(c.lam, dtype=costs.dtype,
                                    device=costs.device)
    out = {"k": k, "structure": c.structure, "lam": c.lam,
           "cost_min_differ": int((rows[:, 2] != costs).sum().item()),
           "cost_max_differ": int((rows[:, 3] != costs).sum().item()),
           "exponent_differ": int((rows[:, 0] != zarg).sum().item()),
           # not gated: PyTorch's CUDA division by a Python scalar (a
           # product with its rounded reciprocal) against the kernel's
           "scalar_division_differ": int((rows[:, 0] != -costs / c.lam
                                          ).sum().item())}
    out["ok"] = not (out["cost_min_differ"] or out["cost_max_differ"]
                     or out["exponent_differ"])
    emit(f"auv_mode_bits_{label}", **out)
    if not out["ok"]:
        raise AssertionError(f"AUV fused and costs modes differ ({label}): "
                             f"{out}")
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


def check_two_phase(kern, pm, fused, z, label: str, x0, useq) -> dict:
    """The normalized two-phase solve of a 13-state solve object as the
    controller runs it (``fused.costs_phase``: ``kern.costs`` and the
    stats-only pm_merge; ``fused.weights_phase``: mppi_weights and
    pm_merge) on injected z, from state ``x0`` and nominal ``useq``,
    against its plain version: the costs at COST_RTOL / COST_ATOL and
    their merged min, max and mean at 1e-4; phase B alone (the plain
    weights over the kernel's own costs, rtol 1e-4, as check_weights);
    the merge alone (pm_merge against merge_plain on the plain rows: zsum
    / l at check_solve's 1e-5 / 1e-6, its stats at 1e-5); the merged weighted noise (z units, zsum / l) end to
    end at check_auv's 1e-2 / 1e-3, beside its first-order reading."""
    k, tau, adim, c = fused.k, fused.tau, fused.adim, fused.consts
    with torch.no_grad():
        dyn = fused.pack_dyn(x0, useq)
        costs_k, cst = fused.costs_phase(x0, useq, z=z)
        zs_k, l_k = fused.weights_phase(costs_k, cst["cost_min"],
                                        cst["cost_max"], z=z)
    costs_p = kern.sample_costs_plain(c, dyn, z)

    def rows_plain(costs):
        beta, cmax = costs.min(), costs.max()
        denom = torch.where(cmax > beta, cmax - beta, torch.ones_like(beta))
        nrm = torch.stack([beta, 1.0 / (denom * fused.lam)])
        return pm.weights_plain(nrm, costs, tau, adim, z=z,
                                antithetic=fused.antithetic)

    rows_p = rows_plain(costs_p)
    zs_p, st_p = pm.merge_plain(rows_p)
    zs_b, st_b = pm.merge_plain(rows_plain(costs_k))
    zs_m, st_m = pm.pm_merge(rows_p)
    torch.cuda.synchronize()
    wn_k = zs_k.reshape(-1) / l_k
    out = {"k": k, "tau": tau, "adim": adim, "cost_rtol": COST_RTOL,
           "cost_atol": COST_ATOL}
    ok_c, err_c, ratio_c = close(costs_k, costs_p, COST_RTOL, COST_ATOL)
    got = torch.stack([cst["cost_min"], cst["cost_max"],
                       cst["cost_sum"] / k]).double()
    ref = torch.stack([costs_p.min(), costs_p.max(),
                       costs_p.sum() / k]).double()
    stats_rel = ((got - ref).abs() / ref.abs()).max().item()
    ok_b, err_b, _ = close(wn_k, zs_b / st_b[1], 1e-4, 1e-6)
    ok_m, err_m, _ = close(zs_m / st_m[1], zs_p / st_p[1], 1e-5, 1e-6)
    m_rel = ((st_m[:5].double() - st_p[:5].double()).abs()
             / st_p[:5].double().abs().clamp_min(1e-30)).max().item()
    ok_e, err_e, ratio_e = close(wn_k, zs_p / st_p[1], 1e-2, 1e-3)
    # the exponent errors d = (c_kernel - c_plain) / ((max - min) lam)
    # move the normalized weights p by p (mean_p(d) - d)
    span = (costs_p.max() - costs_p.min()).double() * fused.lam
    e = -(costs_p.double() - costs_p.min().double()) / span
    p = torch.softmax(e, 0)
    d = (costs_k.double() - costs_p.double()) / span
    pred = ((p * ((p * d).sum() - d))
            @ z.reshape(tau * adim, k).double().T).abs().max().item()
    out.update(costs_ok=ok_c, costs_max_abs_err=err_c, costs_ratio=ratio_c,
               cost_stats_max_rel_err=stats_rel, cost_stats_rtol=1e-4,
               cost_stats_max_abs_err=(got - ref).abs().max().item(),
               weights_ok=ok_b, weights_max_abs_err=err_b,
               weights_rtol=1e-4, weights_atol=1e-6, merge_ok=ok_m,
               merge_max_abs_err=err_m, merge_rtol=1e-5, merge_atol=1e-6,
               merge_stats_max_rel_err=m_rel,
               wnoise_ok=ok_e, wnoise_max_abs_err=err_e,
               wnoise_ratio=ratio_e, wnoise_rtol=1e-2, wnoise_atol=1e-3,
               wnoise_first_order=pred,
               exponent_err_max=d.abs().max().item(),
               ess=(1.0 / (p * p).sum()).item())
    emit(f"{kern.phase}_two_phase_vs_plain_{label}", **out)
    if not (ok_c and stats_rel <= 1e-4 and ok_b and ok_m and m_rel <= 1e-5
            and ok_e):
        raise AssertionError(f"{kern.phase} two-phase solve disagrees with "
                             f"its plain version ({label}): {out}")
    return out


def auv_loop(kernel: str, normalize: bool, steps: int, k: int = AUV_K,
             dense: bool = False, **opts):
    """AUV closed loop through MPPI.next against the analytic plant (rest
    start), with MPPI keywords ``opts``. Normalized: the dive to z = -1;
    unnormalized: the flagship task (z = -5, sigma = 1500 I); ``dense``:
    the dense-constant vehicle as the controller's model. Returns
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
    model, cost, sigma, ups = auv_modules("cuda", task, sigma, dense=dense)
    ctrl = MPPI(model, cost, k=k, tau=AUV_H, lam=AUV_LAM,
                upsilon=ups, sigma=sigma, seed=3,
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


def nn_fused(k, tau, hidden=(32, 32, 32), sigma=AUV_SIGMA,
             model_compute_dtype=None, **opts):
    """FusedNNMPPI over an NNAUVModel with He weights from a seed and
    trained normalisers (products at ``model_compute_dtype``), and the
    flagship StaticQuatCost task."""
    from mppi_tf_tpu_torch import flagship
    from mppi_tf_tpu_torch.costs import get_cost
    from mppi_tf_tpu_torch.kernels.nn_mppi import FusedNNMPPI
    from mppi_tf_tpu_torch.models.nn import NNAUVModel

    model = NNAUVModel(hidden=hidden, seed=17, device="cuda",
                       compute_dtype=model_compute_dtype)
    trained_normalisers(model, sigma)
    cost = get_cost(flagship.auv_task(), lam=AUV_LAM, gamma=AUV_GAMMA,
                    upsilon=AUV_UPSILON, sigma=sigma, device="cuda")
    return FusedNNMPPI(model, cost, k=k, tau=tau, lam=AUV_LAM,
                       upsilon=AUV_UPSILON, sigma=sigma, **opts)


def nn_loop(kernel: str, normalize: bool, steps: int = NN_LOOP_STEPS,
            k: int = NN_K, model_compute_dtype=None, **opts):
    """The known-plant dive through MPPI.next, with MPPI keywords
    ``opts``: the controller's NNAUVModel (products at
    ``model_compute_dtype``) and the f64 CPU plant are the same network
    (``known_plant_params``). Returns (controller, states, host ms per
    step, launch counts)."""
    from mppi_tf_tpu_torch.controller import MPPI
    from mppi_tf_tpu_torch.costs import get_cost
    from mppi_tf_tpu_torch.interop import from_jax_params
    from mppi_tf_tpu_torch.kernels import pm_mppi as pm
    from mppi_tf_tpu_torch.models.nn import NNAUVModel

    model = NNAUVModel(device="cuda", compute_dtype=model_compute_dtype)
    from_jax_params(known_plant_params(), None, model)
    plant = KnownPlant()
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
        x = plant.step(u).ravel()
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
        check_pm_structure(ctrl, "integrator", "ellipse loop")
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
    model, cost, _, _ = auv_modules("cuda", task, DIVE_SIGMA)
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


def pm_loop_phase(phase: str, normalize: bool, tau: int, tol=GOAL_TOL,
                  mean_tol=None, dmd: bool = False, suffix: str = "",
                  **extra) -> tuple:
    """A LOOP_STEPS point-mass loop (``dmd``: the DMD row's) on the
    kernels with env-config keys ``extra``, held to its launches (of the
    solves' build ``suffix``, "_bf16" at bf16) and gated on its final
    goal error (``tol``) or on the error's mean over the last
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
    want.update({f"pm_fused_costs{suffix}": LOOP_STEPS,
                 f"mppi_weights{suffix}": LOOP_STEPS,
                 "pm_merge": 2 * LOOP_STEPS} if normalize else
                {f"pm_fused_solve{suffix}": LOOP_STEPS,
                 "pm_merge": LOOP_STEPS})
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


# ---- the bf16 block compute (compute_dtype="bfloat16") --------------------

#: a bf16 kernel against its plain bf16 version: mean |kernel - plain| over
#: the per-sample costs at most this share of the same kernel's f32 build
#: against that plain version (the kernel computes the bf16 arithmetic,
#: not f32 relabelled); the same share bounds the weighted noise against
#: the effect of rounding its normals (bf16_wnoise) and phase B's block
#: rows (bf16_weights_check). The H100's readings are in PERF.md
BF16_GAP_SHARE = 1e-2
#: the weighted noise (z units) of a bf16 kernel against the softmax of
#: its own costs: the tolerance of the f32 kernels' (check_solve)
BF16_WNOISE_RTOL, BF16_WNOISE_ATOL = 1e-3, 1e-5


#: the instantiations the sass phase reads, f32 and bf16 builds, both
#: modes: <S, A, MODE, COST, AB, STRUCT> of the point mass ((6, 3)
#: quadratic; f32 kIntegrator, kDense and kDense with dynamic (A, B),
#: bf16 kDense with constant and dynamic (A, B); <S, A, MODE, COST, AB> in
#: a library from before STRUCT), <RK, MODE, COST, STRUCT> of the AUV
#: (rk2, static_quat; f32 kDense and kDiag, bf16 kDense; <RK, MODE, COST>
#: in a library from before STRUCT) and <N1, N2, N3, MODE> of the NN (the
#: f32 and bf16-products builds at 3x32 and (8, 8), the bf16 pair build at
#: 3x32)
SASS_KERNELS = (
    *[(f"pm_fused_solve{b}_kernel", (6, 3, m, 0, ab, *st))
      for b in ("", "_bf16") for m in (0, 1) for ab in (0, 1)
      for st in ((), (0,), (1,)) if not ((b or ab) and st == (1,))],
    *[(f"auv_fused_solve{b}_kernel", (2, m, 0, *st)) for b in ("", "_bf16")
      for m in (0, 1) for st in ((), (0,), (1,))
      if not (b and st == (1,))],
    *[(f"nn_fused_solve{b}_kernel", (*hid, m))
      for b in ("", "_bfp", "_bf16") for m in (0, 1)
      for hid in ((32, 32, 32), (8, 8, 0)) if b != "_bf16" or hid[2]],
    ("mppi_weights_kernel", ()), ("mppi_weights_bf16_kernel", ()),
    ("pm_merge_kernel", ()))
#: the NN instantiations whose MLP runs on the tensor cores: the f32 and
#: bf16-products builds (the sass phase fails unless each holds HMMA and
#: no LDL / STL)
NN_MMA_KERNELS = tuple(key for key in SASS_KERNELS
                       if key[0] in ("nn_fused_solve_kernel",
                                     "nn_fused_solve_bfp_kernel"))
#: the opcode families the sass phase counts (SHFL: phase B's
#: butterflies: about one a normal, where a warp_sum a normal took five)
SASS_FAMILIES = ("HMMA", "F2FP", "F2F", "HADD2", "HMUL2", "HFMA2", "FFMA",
                 "FMUL", "FADD", "LDS", "LDC", "LDL", "STL", "SHFL")


def sass_table(counts) -> dict:
    """The SASS_FAMILIES counts (static instructions in the binary) of the
    SASS_KERNELS in ``_build.sass_counts`` output; ``bf16x2`` counts every
    opcode with a BF16_V2 modifier (HADD2, HMUL2, HFMA2); HMMA the
    tensor-core products (HMMA.1688.F32.TF32, HMMA.16816.F32.BF16)."""
    out = {}
    for mangled, ops in counts.items():
        key = kernel_key(mangled)
        if key not in SASS_KERNELS:
            continue
        fam = {f: sum(n for op, n in ops.items() if op.split(".")[0] == f)
               for f in SASS_FAMILIES}
        fam["bf16x2"] = sum(n for op, n in ops.items() if "BF16_V2" in op)
        fam["total"] = sum(ops.values())
        out[f"{key[0]}<{', '.join(map(str, key[1]))}>"] = fam
    return out


def sass_phase(_build, parent_lib=None) -> None:
    """Static SASS counts of the SASS_KERNELS (``cuobjdump -sass``), and of
    the parent's library where one is given; fails unless every
    NN_MMA_KERNELS instantiation holds HMMA (the tensor cores carry its
    MLP) and no LDL / STL, or where cuobjdump is missing and that cannot
    be shown."""
    counts = _build.sass_counts()
    if counts is None:
        emit("sass", cuobjdump=None, note="cuobjdump is missing: no counts")
        raise AssertionError("cuobjdump is missing: the NN kernels' HMMA "
                             "cannot be read")
    out = {"this": sass_table(counts)}
    if parent_lib is not None:
        out["parent"] = sass_table(_build.sass_counts(parent_lib))
    mma = {f"{n}<{', '.join(map(str, a))}>": out["this"].get(
        f"{n}<{', '.join(map(str, a))}>") for n, a in NN_MMA_KERNELS}
    mma_ok = all(v is not None and v["HMMA"] > 0 and v["LDL"] == 0
                 and v["STL"] == 0 for v in mma.values())
    shfl = {side: {key: v["SHFL"] for key, v in table.items()
                   if "weights" in key or "merge" in key}
            for side, table in out.items()}
    emit("sass", **out, nn_mma={k: v and v["HMMA"] for k, v in mma.items()},
         nn_mma_ok=mma_ok, shfl=shfl,
         note="static instructions in the library; HMMA the tensor-core "
              "products, F2FP / F2F conversions, bf16x2 the BF16_V2 ops")
    if not mma_ok:
        raise AssertionError(f"an NN instantiation lacks HMMA or holds "
                             f"LDL / STL: {mma}")


def occupancy_phase(lib, reg_rows, n_sm: int) -> None:
    """Registers, blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor
    at the flagship horizon, unscheduled), warps an SM and waves at the
    flagship shapes (point mass K=100,000, H=50; AUV K=262,144, H=25; NN
    K=65,536, H=25) of every solve instantiation, f32 and bf16 (the f32
    builds in both structures; the NN's bf16-products build too).
    ``nn_mma_max_waves``: the most waves of an f32 or bf16-products NN
    instantiation (a reading). ``auv_f32_diag_rk12_min_warps``: the
    fewest warps an SM of the kDiag instantiations at rk 1 and 2;
    ``pm_f32_max_waves``: the most waves of an f32 point-mass
    instantiation, which must be one (a gate: kDynAB held two blocks an SM
    and ran 1.48 waves before)."""
    import ctypes

    regs = {(r["kernel"], tuple(r["template"])): r["registers"]
            for r in reg_rows}
    rows = []
    for sfx in ("", "_bf16", "_bfp"):
        # (STRUCT, AB): kIntegrator with constant (A, B), f32 alone
        combos = ((1, 0), (0, 0), (0, 1)) if sfx == "" else ((0, 0), (0, 1))
        cases = [("nn", (*hid, mode), NN_K)
                 for hid in ((32, 32, 32), (8, 8, 0)) for mode in (0, 1)]
        if sfx != "_bfp":     # the bf16-products build is the NN's alone
            cases += [("pm", (s_, a_, mode, cost, ab, st), K)
                      for s_, a_, cost in ((6, 3, 0), (2, 1, 0), (4, 2, 0),
                                           (4, 2, 1))
                      for mode in (0, 1) for st, ab in combos]
            cases += [("auv", (rk, mode, cost, st), AUV_K)
                      for rk in (1, 2, 4) for mode in (0, 1)
                      for cost in (0, 1, 2)
                      for st in ((0, 1) if sfx == "" else (0,))]
        for model, args, k in cases:
            out = (ctypes.c_int * 2)()
            if model == "pm":
                s_, a_, mode, cost, ab, st = args
                rc = getattr(lib, f"pm_occupancy{sfx}")(s_, a_, cost, st,
                                                         mode, ab, H, out)
            elif model == "auv":
                rk, mode, cost, st = args
                rc = getattr(lib, f"auv_occupancy{sfx}")(rk, cost, st, mode,
                                                          AUV_H, out)
            else:
                rc = getattr(lib, f"nn_occupancy{sfx}")(*args, AUV_H, out)
            if rc != 0:
                raise AssertionError(f"occupancy {model}{sfx}{args}: {rc}")
            blocks = -(-k // 256)   # one partial row of 256 samples a block
            rows.append({
                "kernel": f"{model}_fused_solve{sfx}_kernel", "template":
                list(args), "registers": regs.get(
                    (f"{model}_fused_solve{sfx}_kernel", args)),
                "samples_a_thread": out[1], "threads_a_block": 256 // out[1],
                "blocks_an_sm": out[0],
                "warps_an_sm": out[0] * 256 // out[1] // 32, "k": k,
                "grid": blocks,
                "waves": blocks / (out[0] * n_sm) if out[0] else None})
    # phase B at its flagship shapes: one partial row's samples a block
    # column, the host's groups over blockIdx.y
    for sfx in ("", "_bf16"):
        for name, k, tau, adim in WEIGHT_FLAGSHIPS:
            out = (ctypes.c_int * 2)()
            if getattr(lib, f"mppi_weights_occupancy{sfx}")(
                    tau * adim, out) != 0:
                raise AssertionError(f"mppi_weights_occupancy{sfx}")
            grid = -(-k // 256) * out[1]
            rows.append({
                "kernel": f"mppi_weights{sfx}_kernel", "shape": name,
                "template": [], "registers": regs.get(
                    (f"mppi_weights{sfx}_kernel", ())),
                "samples_a_thread": 1, "threads_a_block": 256,
                "blocks_an_sm": out[0], "warps_an_sm": out[0] * 8, "k": k,
                "n_z": tau * adim, "groups": out[1], "grid": grid,
                "waves": grid / (out[0] * n_sm)})
    pm_waves = max(r["waves"] or float("inf") for r in rows
                   if r["kernel"] == "pm_fused_solve_kernel")
    emit("occupancy", sms=n_sm, rows=rows, auv_f32_diag_rk12_min_warps=min(
        r["warps_an_sm"] for r in rows
        if r["kernel"] == "auv_fused_solve_kernel"
        and r["template"][0] in (1, 2) and r["template"][3] == 1),
        pm_f32_max_waves=pm_waves, nn_mma_max_waves=max(
            r["waves"] or float("inf") for r in rows
            if r["kernel"] in ("nn_fused_solve_kernel",
                               "nn_fused_solve_bfp_kernel")))
    if not pm_waves <= 1.0:
        raise AssertionError(f"an f32 point-mass instantiation runs "
                             f"{pm_waves} waves at K={K}")


def build_parent(parent: str) -> subprocess.Popen:
    """Start building the kernels' library of the checkout at ``parent``
    (its own kernels/_build.py, in a process of its own); it prints the
    library's path and its entry points' signatures."""
    return subprocess.Popen(
        [sys.executable, "-c", "import json; from mppi_tf_tpu_torch.kernels "
         "import _build; print(_build.build()); print(json.dumps({n: [t."
         "__name__ for t in a] for n, a in _build._SIGNATURES.items()}))"],
        cwd=parent, env={**os.environ, "PYTHONPATH": os.path.abspath(parent)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


class ParentLibrary:
    """The parent's library behind this tree's entry-point signatures: an
    entry point that lacks one of this tree's arguments is called without
    it, so it runs the parent's kernels on the same inputs: the vehicles
    of a fleet launch (last before the stream, from before the fleet; the
    parent is called at n = 1 alone), the AUV's structure (third, from
    before kDiag) and the point mass's (fourth, from before kIntegrator)."""

    #: the place of the structure argument a parent may lack, by prefix
    STRUCTURE_ARG = {"auv_": 2, "pm_": 3}
    #: the entry points that take the vehicles of a fleet launch
    VEHICLE_ENTRIES = ("pm_fused_solve", "pm_fused_costs", "mppi_weights",
                       "pm_merge", "auv_fused_solve", "auv_fused_costs")

    def __init__(self, lib, arity: dict, signatures: dict):
        self._lib = lib
        self._drop = {}
        for n, a in arity.items():
            ours = len(signatures.get(n, ()))
            drop = []
            if ours > a and n.removesuffix("_bf16") in self.VEHICLE_ENTRIES:
                drop.append(ours - 2)
            if ours - len(drop) == a + 1:
                drop += [i for pre, i in self.STRUCTURE_ARG.items()
                         if n.startswith(pre)]
            if drop:
                self._drop[n] = drop

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name in self._drop:
            drop = self._drop[name]
            return lambda *a: fn(*(x for i, x in enumerate(a)
                                   if i not in drop))
        return fn


def load_parent(proc: subprocess.Popen, _build):
    """The library ``build_parent`` built, bound with its own signatures,
    behind this tree's (``ParentLibrary``), and its path."""
    import ctypes

    out, err = proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"parent build failed: {err[-4000:]}")
    path, sigs = out.strip().splitlines()[-2:]
    lib = ctypes.CDLL(path)
    sigs = json.loads(sigs)
    for name, argtypes in sigs.items():
        getattr(lib, name).argtypes = [getattr(ctypes, t) for t in argtypes]
        getattr(lib, name).restype = ctypes.c_int
    lib.pm_error_string.argtypes = [ctypes.c_int]
    lib.pm_error_string.restype = ctypes.c_char_p
    return ParentLibrary(lib, {n: len(a) for n, a in sigs.items()},
                         _build._SIGNATURES), path


def with_library(_build, lib, fn):
    """fn() with the wrappers launching from ``lib``."""
    saved = _build._lib
    _build._lib = lib
    try:
        return fn()
    finally:
        _build._lib = saved


#: the 2-DoF ellipse of the point-mass cases (tests/test_torch_cuda.py)
PM_ELIPSE = {"type": "elipse", "a": 4.0, "b": 2.0, "center_x": 0.0,
             "center_y": 0.0, "speed": 5.0, "m_state": 1.0, "m_vel": 0.1}


def pm_object(pm, sdim: int, adim: int, elipse: bool, dyn_ab: bool, k: int,
              tau: int, compute_dtype: str = "bfloat16", seed: int = 0,
              dense: bool = False, upsilon: float = 1.2, **opts):
    """A point-mass solve object on the card, (sdim, adim) at mass 1.3 and
    ``upsilon`` (1.2: the z-quadratic counts) under the static cost (goal
    0.5, Q 1) or the 2-DoF ellipse; with ``dense`` sigma and Q get
    off-diagonal terms (dense_pm_constants: the dense kernels); with
    ``dyn_ab`` FusedLTIMPPI over a DMDModel with a dense random (A, B)
    from ``seed`` (the kDynAB instantiations)."""
    from mppi_tf_tpu_torch.costs import get_cost
    from mppi_tf_tpu_torch.models import get_model
    from mppi_tf_tpu_torch.models.dmd import DMDModel

    sigma, q = SIGMA[:adim, :adim], np.diag([1.0] * sdim)
    if dense:
        sigma, q = dense_pm_constants(sigma, [1.0] * sdim)
    model = get_model({"type": "point_mass", "mass": 1.3}, dt=DT,
                      state_dim=sdim, action_dim=adim, device="cuda")
    task = PM_ELIPSE if elipse else {"type": "static", "diag": False,
                                     "goal": [0.5] * sdim, "Q": q.tolist()}
    cost = get_cost(task, lam=LAM, gamma=GAMMA, upsilon=upsilon, sigma=sigma,
                    device="cuda")
    cls = pm.FusedPointMassMPPI
    if dyn_ab:
        rng = np.random.RandomState(seed)
        model = DMDModel(sdim, adim, dt=DT,
                         init_A=np.eye(sdim) + 0.05 * rng.randn(sdim, sdim),
                         init_B=0.1 * rng.randn(sdim, adim), device="cuda")
        cls = pm.FusedLTIMPPI
    return cls(model, cost, k=k, tau=tau, lam=LAM, upsilon=upsilon,
               sigma=sigma, compute_dtype=compute_dtype, **opts)


def pm_dyn(f, rng) -> torch.Tensor:
    """A point-mass solve object's dyn from a random state (near the
    ellipse for its cost) and nominal sequence."""
    x0 = 0.3 * rng.standard_normal(f.sdim)
    if f.consts.cost_kind == "elipse":
        x0 += [4.0, 0.0, 0.0, 5.0]
    return f.pack_dyn(
        torch.as_tensor(x0, dtype=torch.float32, device="cuda"),
        torch.as_tensor(0.1 * rng.standard_normal((f.tau, f.adim)),
                        dtype=torch.float32, device="cuda"))


#: parent_phase's subject: the noise dump, redesigned for Hopper
PARENT_SUBJECT = ("pm_noise_dump",)
#: the dump's shapes in parent_phase (k, tau, adim, half): K=4,097 (rows
#: off the 16-byte grid) at adim 3 and at adim 6 with an odd half, the
#: headline point mass plain and antithetic, the AUV flagship, and log
#: mode's [H, 3, min(512, K)] (MPPI.next's noise_sample on a logged step)
PARENT_DUMP_SHAPES = ((4097, 7, 3, 0), (4097, 7, 6, 2049), (K, H, 3, 0),
                      (K, H, 3, K // 2), (AUV_K, AUV_H, 6, 0),
                      (512, H, 3, 0))
#: the dump against the parent in turns: faster at the headline shape,
#: and at most this many ms slower at the log shape
DUMP_LOG_SLACK_MS = 1e-3
#: pm_merge against merge_plain in f64 on the same rows: l, the cost sum
#: and each zsum[n] within this share of the column's l1 mass
#: sum_b f_b |x_b| (zsum entries cancel towards 0, so a bound relative to
#: the entry itself would be meaningless); m, cost min and max exactly
MERGE_L1_TOL = 1e-5
#: phase B's flagship shapes (label, k, tau, adim): the NN dive, the point
#: mass at H=50 and H=100, the AUV dive
#: the controls of parent_phase whose solve and costs are timed in turns
PARENT_TIMED = ("pm_f32_K100000", "pm_f32_sched_H100",
                "auv_f32_static_quat_flagship", "nn_f32_flagship")
WEIGHT_FLAGSHIPS = (("nn", NN_K, NN_H, 6), ("pm", K, H, 3),
                    ("pm_h100", K, H100, 3), ("auv", AUV_K, AUV_H, 6))
#: the merge's synthetic rows: blocks (1 at K <= 256, 12 for the CLI's
#: K=3,000, the flagships' 391 and 1,024, 5,000) and normals (stats-only,
#: H=50 x 3 or 25 x 6, H=100 x 3, H=100 x 6)
MERGE_NB, MERGE_NZ = (1, 12, 391, 1024, 5000), (0, 150, 300, 600)


def synthetic_rows(nb: int, n_z: int, rng) -> torch.Tensor:
    """Partial rows on the card: spread maxima m_b <= 0, positive l_b,
    cost stats, zsum_b of both signs."""
    r = np.zeros((nb, 8 + n_z), np.float32)
    r[:, 0] = -np.abs(rng.normal(0.0, 3.0, nb))
    r[:, 1] = rng.uniform(1.0, 256.0, nb)
    c = rng.uniform(1e3, 5e4, (nb, 2))
    r[:, 2], r[:, 3] = c.min(axis=1), c.max(axis=1)
    r[:, 4] = rng.uniform(1e5, 1e7, nb)
    r[:, 8:] = rng.normal(0.0, 30.0, (nb, n_z))
    return torch.as_tensor(r, device="cuda")


def merge_gate(pm, rows: torch.Tensor, zsum, stats) -> dict:
    """A merge of ``rows`` against merge_plain in f64: m, cost min and max
    equal (``exact``), and the largest error of l, the cost sum and each
    zsum[n] over its column's l1 mass (``rel_l1``)."""
    r = rows.double()
    ref_z, ref_st = pm.merge_plain(r)
    f = torch.exp(r[:, 0] - ref_st[0])
    l1 = torch.cat([torch.stack([(f * r[:, 1].abs()).sum(),
                                 r[:, 4].abs().sum()]),
                    f @ r[:, 8:].abs()])
    err = (torch.cat([stats[[1, 4]], zsum]).double()
           - torch.cat([ref_st[[1, 4]], ref_z])).abs()
    exact = all(stats[i].double().item() == ref_st[i].item()
                for i in (0, 2, 3))
    rel = (err / torch.where(l1 > 0, l1, 1.0)).max().item()
    return {"exact": exact, "rel_l1": rel,
            "ok": exact and rel <= MERGE_L1_TOL}


def parent_cases(pm, auv, nnk) -> list:
    """(label, solve object, kernels) of parent_phase's controls: the f32
    NN body and its bf16-products build, every f32 point-mass
    instantiation, the f32 AUV, the bf16 builds; their rows also feed the
    merge."""
    ka, kn = quat_kernels(auv, "auv"), quat_kernels(nnk, "nn")
    kp = SimpleNamespace(costs=pm.pm_fused_costs, solve=pm.pm_fused_solve)
    cases = []
    bfp = {"model_compute_dtype": torch.bfloat16}
    for k in (700, 4097):
        for hid in ((8, 8), (32, 32, 32)):
            name = "x".join(map(str, hid))
            cases += [(f"nn_f32_{name}_K{k}", nn_fused(k, 7, hid), kn),
                      (f"nn_f32_sched_anti_{name}_K{k}",
                       nn_fused(k, 7, hid, **FUSED_BOTH), kn),
                      (f"nn_bfp_{name}_K{k}", nn_fused(k, 7, hid, **bfp),
                       kn)]
    cases += [("nn_f32_flagship", nn_fused(NN_K, NN_H), kn),
              ("nn_f32_sched_anti_flagship",
               nn_fused(NN_K, NN_H, **FUSED_BOTH), kn),
              ("nn_bfp_flagship", nn_fused(NN_K, NN_H, **bfp), kn)]
    # the controls: the f32 point-mass body in both structures, the f32
    # AUV body in both structures, the bf16 builds
    dims = ((6, 3, False), (2, 1, False), (4, 2, False), (4, 2, True))
    for k in (700, 4097):
        for sdim, adim, el in dims:
            kind = f"{sdim}x{adim}_{'elipse' if el else 'quad'}"
            for st in ("integrator", "dense"):
                for ups in (1.0, 1.2):
                    f = pm_object(pm, sdim, adim, el, False, k, 7,
                                  compute_dtype="float32",
                                  dense=st == "dense", upsilon=ups)
                    if f.consts.structure != st:
                        raise AssertionError(f"parent case pm {kind} {st}")
                    cases.append((f"pm_f32_{kind}_{st}_ups{ups}_K{k}", f,
                                  kp))
            cases.append((f"pm_f32_{kind}_dynab_K{k}",
                          pm_object(pm, sdim, adim, el, True, k, 7,
                                    compute_dtype="float32", seed=k), kp))
        for st in ("integrator", "dense"):
            cases.append((f"pm_f32_sched_anti_{st}_K{k}",
                          pm_object(pm, 6, 3, False, False, k, 7,
                                    compute_dtype="float32",
                                    dense=st == "dense", **FUSED_BOTH), kp))
        cases.append((f"pm_f32_sched_anti_dynab_K{k}",
                      pm_object(pm, 6, 3, False, True, k, 7,
                                compute_dtype="float32", seed=k,
                                **FUSED_BOTH), kp))
    model, cost = workload("cuda")
    dmd_model, _ = workload("cuda", dmd=True)
    dense_model, dense_cost = workload("cuda", dense=True)
    flag = {"lam": LAM, "upsilon": UPSILON}
    cases += [
        ("pm_f32_K100000", pm.FusedPointMassMPPI(
            model, cost, k=K, tau=H, sigma=SIGMA, **flag), kp),
        ("pm_f32_sched_H100", pm.FusedPointMassMPPI(
            model, cost, k=K, tau=H100, sigma=SIGMA, schedule=SCHED,
            **flag), kp),
        ("pm_f32_antithetic_K100000", pm.FusedPointMassMPPI(
            model, cost, k=K, tau=H, sigma=SIGMA, antithetic=True, **flag),
         kp),
        ("pm_f32_dynab_K100000", pm.FusedLTIMPPI(
            dmd_model, cost, k=K, tau=H, sigma=SIGMA, **flag), kp),
        ("pm_f32_elipse_K100000", tracking_fused(
            pm_env(4), "tasks/elipse_task", "models/point_mass_model", K,
            H)[2], kp),
        ("pm_f32_dense_K100000", pm.FusedPointMassMPPI(
            dense_model, dense_cost, k=K, tau=H, sigma=PM_DENSE_SIGMA,
            **flag), kp)]
    for label, want in (("pm_f32_K100000", "integrator"),
                        ("pm_f32_sched_H100", "integrator"),
                        ("pm_f32_antithetic_K100000", "integrator"),
                        ("pm_f32_elipse_K100000", "integrator"),
                        ("pm_f32_dynab_K100000", "dense"),
                        ("pm_f32_dense_K100000", "dense")):
        got = next(c[1] for c in cases if c[0] == label).consts.structure
        if got != want:
            raise AssertionError(f"parent case {label}: {got}, want {want}")
    kinds = ("static_quat", "waypoints_quat", "elipse3d")
    for k in (700, 4097):
        for rk in (1, 2, 4):
            for kind in kinds:
                for dense in (False, True):
                    st = "dense" if dense else "diagonal"
                    cases.append((f"auv_f32_{kind}_rk{rk}_{st}_K{k}",
                                  auv_fused(k, 7, rk=rk, kind=kind,
                                            dense=dense), ka))
                cases.append((f"auv_bf16_{kind}_rk{rk}_K{k}",
                              auv_fused(k, 7, rk=rk, kind=kind,
                                        compute_dtype="bfloat16"), ka))
        for dense in (False, True):
            st = "dense" if dense else "diagonal"
            cases.append((f"auv_f32_sched_anti_{st}_K{k}",
                          auv_fused(k, 7, dense=dense, **FUSED_BOTH), ka))
        for sdim, adim, el in dims:
            for ab in (False, True):
                f = pm_object(pm, sdim, adim, el, ab, k, 7, seed=k)
                cases.append((f"pm_bf16_{sdim}x{adim}_"
                              f"{'elipse' if el else 'quad'}"
                              f"{'_dynab' if ab else ''}_K{k}", f, kp))
        for ab in (False, True):
            cases.append((f"pm_bf16_sched_anti{'_dynab' if ab else ''}_K{k}",
                          pm_object(pm, 6, 3, False, ab, k, 7, seed=k,
                                    **FUSED_BOTH), kp))
        for hid in ((32, 32, 32), (8, 8)):
            cases.append((f"nn_bf16_{'x'.join(map(str, hid))}_K{k}",
                          nn_fused(k, 7, hidden=hid,
                                   compute_dtype="bfloat16"), kn))
    cases += [
        ("auv_bf16_sched_anti_K700", auv_fused(700, 7, compute_dtype=
                                               "bfloat16", **FUSED_BOTH), ka),
        ("nn_bf16_sched_anti_K700", nn_fused(700, 7, compute_dtype=
                                             "bfloat16", **FUSED_BOTH), kn),
        ("auv_f32_static_quat_flagship", auv_fused(AUV_K, AUV_H), ka),
        ("auv_f32_dense_flagship", auv_fused(AUV_K, AUV_H, dense=True), ka),
        ("auv_bf16_flagship", auv_fused(AUV_K, AUV_H,
                                        compute_dtype="bfloat16"), ka),
        ("nn_bf16_flagship", nn_fused(NN_K, NN_H, compute_dtype="bfloat16"),
         kn),
        ("pm_bf16_K100000", pm.FusedPointMassMPPI(
            model, cost, k=K, tau=H, sigma=SIGMA, compute_dtype="bfloat16",
            **flag), kp),
        ("pm_bf16_dynab_K100000", pm.FusedLTIMPPI(
            dmd_model, cost, k=K, tau=H, sigma=SIGMA,
            compute_dtype="bfloat16", **flag), kp)]
    return cases


def parent_phase(_build, plib, pm, auv, nnk, smi: str) -> None:
    """``--parent``: this tree's kernels against the parent's library on the
    same inputs. The subject: the noise dump (f32 and bf16, plain and
    antithetic, at every shape of PARENT_DUMP_SHAPES, and the solve index
    read from the device), bit for bit. The controls: phase B
    (mppi_weights, f32 and bf16, adim 3 and 6, plain and antithetic,
    injected z and Philox, K=700 and 4,097 at H=7 and the four flagship
    shapes of WEIGHT_FLAGSHIPS), its rows bit for bit; pm_merge on the
    rows of every control's solve and costs kernel, the phase-B rows and
    synthetic rows (MERGE_NB x MERGE_NZ), each against merge_plain in f64
    (merge_gate: m, cost min and max exact, the sums within MERGE_L1_TOL
    of their columns' l1 mass), the parent's merge of the same rows (run
    on its own library) printed beside, and two merges of the same rows
    equal bit for bit; the solve and costs kernels of parent_cases (f32
    and bf16, point mass, AUV, NN), every output bit for bit. Then the
    dump timed in turns (parent, this, this, parent) at each of its
    shapes, beside phase B, the flagship controls and the merge, and an
    empty kernel's device time, the launch floor; it fails unless the
    dump is faster than the parent's at the headline shape and within
    DUMP_LOG_SLACK_MS of it at the log shape."""
    rng = np.random.default_rng(21)
    cases = parent_cases(pm, auv, nnk)
    res, rows_for_merge = {}, {}

    def compare(fn) -> dict:
        """{output: True, or how it differs} of fn() here and in the
        parent's library; fn returns a tuple of tensors."""
        got = fn()
        want = with_library(_build, plib, fn)
        out = {}
        for i, (a, b) in enumerate(zip(got, want)):
            out[i] = True if torch.equal(a, b) else {
                "differing": int((a != b).sum().item()), "of": a.numel(),
                "max_abs_diff": (a.double() - b.double()).abs().max().item()}
        return out, got

    # ---- controls: the solve and costs kernels, the noise dump ------------
    timed = {}
    for label, f, kern in cases:
        dyn = (pm_dyn(f, rng) if kern.costs is pm.pm_fused_costs else
               auv_dyn(f, 20.0 if "elipse3d" in label else 200.0,
                       seed=len(label),
                       x0=[4.0, 0, -3.0, 0, 0, 0, 1.0] + [0.0] * 6
                       if "elipse3d" in label else None))
        if label in PARENT_TIMED:
            timed[label] = (f, kern, dyn)
        z = torch.as_tensor(rng.standard_normal((f.tau, f.adim, f.k),
                                                np.float32), device="cuda")
        out = {}
        for src, kw in (("injected", {"z": z}), ("philox", {"seed": 9,
                                                           "solve": 2})):
            def run():
                c, srows = kern.costs(f.consts, dyn, f.k, f.tau, **kw)
                rows = kern.solve(f.consts, dyn, f.k, f.tau, **kw)
                torch.cuda.synchronize()
                return c, srows, rows
            cmp, got = compare(run)
            out.update({f"{src}_{name}": cmp[i] for i, name in enumerate(
                ("costs", "stats_rows", "rows"))})
            if src == "philox":
                rows_for_merge[f"{label}_rows"] = got[2]
                rows_for_merge[f"{label}_stats_rows"] = got[1]
        res[label] = out
        del z
    control_diffs = {label: {o: v for o, v in out.items() if v is not True}
                     for label, out in res.items()}
    control_diffs = {label: d for label, d in control_diffs.items() if d}

    # ---- the subject: the noise dump, bit for bit -------------------------
    dres = {}
    for cd in ("float32", "bfloat16"):
        for k, tau, adim, half in PARENT_DUMP_SHAPES:
            cmp, _ = compare(lambda: (pm.pm_noise_dump(
                9, 2, k, tau, adim, "cuda", half=half, compute_dtype=cd),))
            dres[f"pm_noise_dump_{cd}_K{k}_H{tau}_adim{adim}_half{half}"] = (
                cmp[0])
        # the solve index read from the device, past 2^32, and by value
        dev = torch.tensor([(1 << 32) + 5], dtype=torch.int64, device="cuda")
        cmp, got = compare(lambda: (pm.pm_noise_dump(
            9, dev, 4097, 7, 6, "cuda", compute_dtype=cd),))
        dres[f"pm_noise_dump_{cd}_device_solve"] = cmp[0]
        dres[f"pm_noise_dump_{cd}_device_solve_by_value"] = (
            True if torch.equal(got[0], pm.pm_noise_dump(
                9, (1 << 32) + 5, 4097, 7, 6, "cuda", compute_dtype=cd))
            else "differs")
    d_diffs = {label: v for label, v in dres.items() if v is not True}

    # ---- a control: phase B, bit for bit ----------------------------------
    wres, w_inputs = {}, {}
    shapes = [(f"K{k}_adim{adim}", k, 7, adim) for k in (700, 4097)
              for adim in (3, 6)] + list(WEIGHT_FLAGSHIPS)
    for name, k, tau, adim in shapes:
        costs = torch.as_tensor(rng.uniform(1e3, 6e4, k), dtype=torch.float32,
                                device="cuda")
        nrm = torch.stack([costs.min(),
                           1.0 / ((costs.max() - costs.min()) * 0.5)])
        w_inputs[name] = (nrm, costs, tau, adim)
        z = torch.as_tensor(rng.standard_normal((tau, adim, k), np.float32),
                            device="cuda")
        for cd in ("float32", "bfloat16"):
            for src, anti, kw in (("philox", False, {"seed": 9, "solve": 2}),
                                  ("philox", True, {"seed": 9, "solve": 2}),
                                  ("injected", False, {"z": z})):
                label = (f"weights_{cd}_{name}_{src}"
                         f"{'_antithetic' if anti else ''}")
                cmp, got = compare(lambda: (pm.mppi_weights(
                    nrm, costs, tau, adim, antithetic=anti,
                    compute_dtype=cd, **kw),))
                wres[label] = cmp[0]
                if not name.startswith("K700") and cd == "float32":
                    rows_for_merge[label] = got[0]
        del z
    w_diffs = {label: v for label, v in wres.items() if v is not True}

    # ---- the subject: the merge against f64, the parent's beside ----------
    for nb in MERGE_NB:
        for n_z in MERGE_NZ:
            rows_for_merge[f"synthetic_nb{nb}_nz{n_z}"] = synthetic_rows(
                nb, n_z, rng)
    mres = {}
    for label, rows in rows_for_merge.items():
        zs, st = pm.pm_merge(rows)
        zs2, st2 = pm.pm_merge(rows)
        zp, sp = with_library(_build, plib, lambda: pm.pm_merge(rows))
        mres[label] = {"nb": rows.shape[0], "n_z": rows.shape[1] - 8,
                       **merge_gate(pm, rows, zs, st),
                       "repeat_equal": bool(torch.equal(zs, zs2)
                                            and torch.equal(st, st2)),
                       "parent": merge_gate(pm, rows, zp, sp)}
    merge_bad = {label: r for label, r in mres.items()
                 if not (r["ok"] and r["repeat_equal"])}
    worst = max(mres.values(), key=lambda r: r["rel_l1"])
    worst_p = max(mres.values(), key=lambda r: r["parent"]["rel_l1"])
    emit("parent_bits", subject=list(PARENT_SUBJECT),
         dump_cases=sorted(dres), dump_all_equal=not d_diffs,
         dump_diffs=d_diffs,
         control_cases=sorted(res), weights_cases=sorted(wres),
         merge_cases=len(mres),
         outputs_compared=(sum(len(o) for o in res.values()) + len(wres)
                           + len(dres)),
         controls_all_equal=not control_diffs,
         weights_all_equal=not w_diffs,
         merge_all_ok=not merge_bad, merge_l1_tol=MERGE_L1_TOL,
         merge_max_rel_l1=worst["rel_l1"],
         merge_max_rel_l1_at=[worst["nb"], worst["n_z"]],
         parent_merge_max_rel_l1=worst_p["parent"]["rel_l1"],
         parent_merge_max_rel_l1_at=[worst_p["nb"], worst_p["n_z"]],
         parent_merge_all_exact=all(r["parent"]["exact"]
                                    for r in mres.values()),
         merge_rel_l1={label: [r["rel_l1"], r["parent"]["rel_l1"]]
                       for label, r in mres.items()
                       if label.startswith("synthetic")},
         control_diffs=control_diffs, weights_diffs=w_diffs,
         merge_bad=merge_bad,
         note="this tree's kernels against the parent commit's library on "
         "the same inputs: the subject (the noise dump), the controls "
         "(every solve and costs kernel) and phase B torch.equal; pm_merge "
         "against merge_plain "
         "in f64 (m, cost min / max exact, sums within merge_l1_tol of the "
         "column's l1 mass; merge_rel_l1: [this, parent] on the synthetic "
         "rows), two merges of the same rows equal bit for bit")
    if d_diffs or control_diffs or w_diffs or merge_bad:
        raise AssertionError(f"parent_bits: dump {d_diffs}, controls "
                             f"{control_diffs}, weights {w_diffs}, merge "
                             f"{merge_bad}")

    # ---- times in turns, the launch floor ----------------------------------
    stream = torch.cuda.current_stream().cuda_stream

    def turns(fn) -> dict:
        """fn's events and device ms in turns: parent, this, this, parent."""
        t = [with_library(_build, plib, lambda: cuda_ms(fn, 100)),
             cuda_ms(fn, 100), cuda_ms(fn, 100),
             with_library(_build, plib, lambda: cuda_ms(fn, 100))]
        d = [with_library(_build, plib, lambda: device_ms(fn)),
             device_ms(fn), device_ms(fn),
             with_library(_build, plib, lambda: device_ms(fn))]
        return {"parent_ms": [t[0], t[3]], "ms": [t[1], t[2]],
                "parent_device_ms": [d[0], d[3]], "device_ms": [d[1], d[2]],
                "events_vs_parent": (t[1] + t[2]) / (t[0] + t[3]),
                "device_vs_parent": (d[1] + d[2]) / (d[0] + d[3])}

    times = {}
    for k, tau, adim, half in PARENT_DUMP_SHAPES:
        for cd in ("float32", "bfloat16"):
            times[f"pm_noise_dump_{cd}_K{k}_H{tau}_adim{adim}_half{half}"] = (
                turns(lambda: pm.pm_noise_dump(1, 1, k, tau, adim, "cuda",
                                               half=half, compute_dtype=cd)))
    for name, k, tau, adim in WEIGHT_FLAGSHIPS:
        nrm, costs, _, _ = w_inputs[name]
        for cd, anti in (("float32", False), ("float32", True),
                         ("bfloat16", False)):
            times[f"mppi_weights_{name}_{cd}"
                  f"{'_antithetic' if anti else ''}"] = turns(
                lambda: pm.mppi_weights(nrm, costs, tau, adim, seed=1,
                                        solve=1, antithetic=anti,
                                        compute_dtype=cd))
    # the flagship controls' solve and costs kernels (Philox), in turns:
    # the one-vehicle launches of the kernels that took the fleet's axis
    for label, (f, kern, dyn) in timed.items():
        for mode in ("solve", "costs"):
            fn = getattr(kern, mode)
            times[f"{mode}_{label}"] = turns(
                lambda: fn(f.consts, dyn, f.k, f.tau, seed=1, solve=1))
    lib = _build.load_library()
    empty = [device_ms(lambda: lib.pm_empty(stream)) for _ in range(2)]
    for label, case in (("pm", "pm_f32_K100000"),
                        ("pm_h100", "pm_f32_sched_H100"),
                        ("auv", "auv_f32_static_quat_flagship"),
                        ("nn", "nn_f32_flagship")):
        for kind in ("rows", "stats_rows"):
            rows = rows_for_merge[f"{case}_{kind}"]
            key = f"pm_merge_{label}_{kind}"
            times[key] = turns(lambda: pm.pm_merge(rows))
            times[key]["nb_nz"] = [rows.shape[0], rows.shape[1] - 8]
    for nb, n_z in ((5000, 600), (1024, 600), (12, 150)):
        rows = rows_for_merge[f"synthetic_nb{nb}_nz{n_z}"]
        times[f"pm_merge_synthetic_nb{nb}_nz{n_z}"] = turns(
            lambda: pm.pm_merge(rows))
    slower = sorted(key for key, t in times.items()
                    if t["device_vs_parent"] > 1.0)
    head = times[f"pm_noise_dump_float32_K{K}_H{H}_adim3_half0"]
    log = times[f"pm_noise_dump_float32_K512_H{H}_adim3_half0"]
    log_excess = (sum(log["device_ms"]) - sum(log["parent_device_ms"])) / 2
    dump_gate = {"headline_device_vs_parent": head["device_vs_parent"],
                 "log_device_ms_over_parent": log_excess,
                 "log_slack_ms": DUMP_LOG_SLACK_MS,
                 "ok": (head["device_vs_parent"] < 1.0
                        and log_excess <= DUMP_LOG_SLACK_MS)}
    emit("parent_times", card=smi, **times, empty_kernel_device_ms=empty,
         slower_than_parent=slower, dump_gate=dump_gate,
         note="CUDA events over 100 launches and profiler device time, "
              "each in turns (parent, this, this, parent); *_vs_parent: "
              "this tree's ms over the parent's; empty_kernel_device_ms: "
              "pm_empty, the launch floor; dump_gate: the dump faster than "
              "the parent's at the headline shape, within log_slack_ms of "
              "it at the log shape")
    if not dump_gate["ok"]:
        raise AssertionError(f"parent_times: the noise dump {dump_gate}")


def parent_loops(_build, plib, smi: str) -> None:
    """``--parent``: MPPI.next on the parent's library and on this tree's,
    in turns (parent, this, this, parent), in the headline point mass
    (K=100,000, H=50), ``point_mass_h100`` (H=100, scheduled) and the
    normalized AUV dive: each turn's median and p90 host ms a step over
    the whole loop, and its wall and device ms a step under
    torch.profiler (profile_steps, 20 steps: PERF.md's section 5). Both
    turns run this tree's Python; only the kernels' library differs."""
    loops = {
        "point_mass": (lambda: closed_loop("auto"), np.zeros(6)),
        "point_mass_h100": (lambda: closed_loop(
            "auto", tau=H100, **{"noise-schedule": SCHED}), np.zeros(6)),
        "auv_dive": (lambda: auv_loop("auto", True, DIVE_STEPS),
                     rest_state())}
    out = {}
    for name, (loop, x) in loops.items():
        def turn():
            ctrl, _, ms, counts = loop()
            prof = profile_steps(ctrl, x=x)
            return {"median": float(np.median(ms)),
                    "p90": float(np.percentile(ms, 90)),
                    "wall": prof["wall_us_per_step"] / 1e3,
                    "device": prof["device_us_per_step"] / 1e3,
                    "launches": counts}
        runs = [with_library(_build, plib, turn), turn(), turn(),
                with_library(_build, plib, turn)]
        if len({json.dumps(r["launches"], sort_keys=True)
                for r in runs}) != 1:
            raise AssertionError(f"parent_loops {name}: the launches "
                                 f"differ: {[r['launches'] for r in runs]}")
        par, this = (runs[0], runs[3]), (runs[1], runs[2])
        out[name] = {
            f"{who}_{key}_ms": [r[key] for r in rs]
            for who, rs in (("parent", par), ("this", this))
            for key in ("median", "p90", "wall", "device")}
        for key in ("median", "wall", "device"):
            out[name][f"{key}_vs_parent"] = (
                sum(r[key] for r in this) / sum(r[key] for r in par))
    emit("parent_loops", card=smi, **out,
         note="MPPI.next in turns (parent, this, this, parent): median / "
              "p90 host ms a step over the loop, wall / device ms a step "
              "under torch.profiler over 20 steps; *_vs_parent: this "
              "tree's over the parent's")


def bf16_wnoise(pm, b16, rows_k, costs_k, z, plain_rows) -> dict:
    """The merged weighted noise (z units, zsum / l) of a bf16 solve
    kernel's rows ``rows_k``: against the softmax of its own per-sample
    costs ``costs_k`` over the normals ``z`` it read, rounded to bf16 as
    the kernel regenerates them (pm.block_partials), under the f32
    kernels' softmax tolerance and, where the kernel rounds its normals
    (not the bf16-products build), under BF16_GAP_SHARE of that softmax
    over the unrounded normals; and end to end against the plain bf16
    solve's rows under the f32 end-to-end tolerance of its model (the
    point mass 1e-3 / 1e-5, the AUV and NN 1e-2 / 1e-3, check_auv)."""
    k = costs_k.shape[0]
    lam = b16.consts.lam
    rounds = b16.consts.compute_dtype == "bfloat16"
    zf = z.reshape(-1, k)
    wk = merged(pm, rows_k)[:-5]
    ws = merged(pm, pm.block_partials(
        costs_k, pm.round_bf16(zf) if rounds else zf, lam))[:-5]
    ok_s, err_s, tol_s = close(wk, ws, BF16_WNOISE_RTOL, BF16_WNOISE_ATOL)
    out = {"wnoise_max_abs_err": err_s, "wnoise_tol_ratio": tol_s}
    if rounds:
        wu = merged(pm, pm.block_partials(costs_k, zf, lam))[:-5]
        gap = (wu.double() - ws.double()).abs().max().item()
        ok_s &= err_s <= BF16_GAP_SHARE * gap
        out.update(wnoise_unrounded_gap_max=gap,
                   wnoise_ratio=err_s / gap if gap else None)
    rtol, atol = (1e-3, 1e-5) if hasattr(b16.consts, "dims") else (1e-2, 1e-3)
    ok_e, err_e, tol_e = close(wk, merged(pm, plain_rows)[:-5], rtol, atol)
    out.update(wnoise_ok=ok_s and ok_e, wnoise_e2e_max_abs_err=err_e,
               wnoise_e2e_tol_ratio=tol_e, wnoise_e2e_rtol=rtol,
               wnoise_e2e_atol=atol)
    return out


def philox_pair(pm, seed: int, solve: int, k: int, tau: int, adim: int,
                half: int = 0):
    """The keywords of a kernel on the Philox stream of (seed, solve), and
    of its plain version fed that stream's f32 normals as the kernel
    draws them (pm_noise_dump, mirrored from ``half``). The plain
    Box-Muller differs from the kernel's in the last bit (atol 1e-5,
    noise_phase), and rounding to bf16 turns such a bit into a rare
    one-step flip of a normal; so the bf16 arithmetic is held on the
    kernel's own normals, which bf16_noise holds to the bf16 dump bit for
    bit."""
    return ({"seed": seed, "solve": solve},
            {"z": pm.pm_noise_dump(seed, solve, k, tau, adim, "cuda",
                                   half=half)})


def bf16_check(pm, label: str, f32, b16, dyn32, dyn16, kern, z) -> dict:
    """A bf16 solve object's kernels (``kern``: solve, costs and their
    plain versions) on injected ``z`` and on the Philox stream
    (``philox_pair``): the per-sample costs against the plain bf16
    version under BF16_GAP_SHARE of the f32 build's gap, and the merged
    weighted noise (``bf16_wnoise``)."""
    k, tau = b16.k, b16.tau
    out = {"k": k, "tau": tau, "gap_share": BF16_GAP_SHARE}
    ok = True
    for src, (kw, kw_p) in (
            ("injected", ({"z": z}, {"z": z})),
            ("philox", philox_pair(pm, 9, 2, k, tau, b16.adim,
                                   pm.antithetic_half(
                                       k, b16.consts.antithetic)))):
        ck, _ = kern.costs(b16.consts, dyn16, k, tau, **kw)
        cp, _ = kern.fused_costs_plain(b16.consts, dyn16, k, tau, **kw_p)
        cf, _ = kern.costs(f32.consts, dyn32, k, tau, **kw)
        wn = bf16_wnoise(
            pm, b16, kern.solve(b16.consts, dyn16, k, tau, **kw), ck,
            kw_p["z"], kern.fused_solve_plain(b16.consts, dyn16, k, tau,
                                              **kw_p))
        torch.cuda.synchronize()
        err = (ck.double() - cp.double()).abs()
        gap = (cf.double() - cp.double()).abs().mean().item()
        out[src] = {"costs_mean_abs_err": err.mean().item(),
                    "costs_max_abs_err": err.max().item(),
                    "f32_gap_mean": gap,
                    "ratio": err.mean().item() / gap if gap else None,
                    "cost_scale": cp.abs().mean().item(), **wn}
        ok &= (gap > 0 and err.mean().item() <= BF16_GAP_SHARE * gap
               and wn["wnoise_ok"])
    emit(f"bf16_kernels_{label}", ok=ok, **out)
    if not ok:
        raise AssertionError(f"bf16 kernel {label} disagrees with its plain "
                             f"version: {out}")
    return out


def bf16_kernels_phase(pm, auv, nnk, model, cost, z_big) -> dict:
    """Every bf16 kernel against its plain bf16 version on the card, in
    the working type, at full width: the point mass at (6, 3) K=100,000,
    H=50 with constant and dynamic (A, B) (the seeded DMD), the (4, 2)
    ellipse at K=700, H=7, the AUV rk2 at K=262,144, H=25 and rk4 at
    K=700, H=7, the NN 3x32 at K=65,536, H=25 and its bf16-products build
    (a model whose compute_dtype is bf16, on the f32 kernel, against the
    f32 products); the other instantiations at K=700, H=7
    (``bf16_variants_phase``); phase B at adim 3 and 6 on injected z and
    the Philox stream (``bf16_weights_check``)."""
    from mppi_tf_tpu_torch.models.dmd import DMDModel

    kp = SimpleNamespace(costs=pm.pm_fused_costs, solve=pm.pm_fused_solve,
                         fused_costs_plain=pm.fused_costs_plain,
                         fused_solve_plain=pm.fused_solve_plain)
    out, objs = {}, {}
    rng = np.random.default_rng(11)
    useq = torch.as_tensor(0.1 * rng.standard_normal((H, 3)),
                           dtype=torch.float32, device="cuda")
    x0 = torch.zeros(6, device="cuda")

    def pm_pair(cls, m, c, k, tau, sigma):
        return [cls(m, c, k=k, tau=tau, lam=LAM, upsilon=UPSILON,
                    sigma=sigma, compute_dtype=cd)
                for cd in ("float32", "bfloat16")]

    f32, b16 = pm_pair(pm.FusedPointMassMPPI, model, cost, K, H, SIGMA)
    dyn = b16.pack_dyn(x0, useq)
    out["pm"] = bf16_check(pm, "pm_K100000_H50", f32, b16, dyn, dyn, kp, z_big)
    objs["pm"] = (f32, b16, dyn)
    dmd = DMDModel(6, 3, dt=DT, init_A=model.A.cpu().numpy(),
                   init_B=model.B.cpu().numpy() / MASS, device="cuda")
    f32l, b16l = pm_pair(pm.FusedLTIMPPI, dmd, cost, K, H, SIGMA)
    dynl = b16l.pack_dyn(x0, useq)
    out["dynamic_ab"] = bf16_check(pm, "pm_dynamic_ab", f32l, b16l, dynl, dynl,
                                   kp, z_big)
    objs["dynamic_ab"] = (f32l, b16l, dynl)
    env = pm_env(4)
    el_model, el_cost, _ = tracking_fused(env, "tasks/elipse_task",
                                          "models/point_mass_model", 700, 7)
    f32e, b16e = [pm.FusedPointMassMPPI(
        el_model, el_cost, k=700, tau=7, lam=env["lambda"],
        upsilon=env["upsilon"], sigma=np.asarray(env["noise"]),
        compute_dtype=cd) for cd in ("float32", "bfloat16")]
    dyne = b16e.pack_dyn(torch.tensor(EL_X0, device="cuda"),
                         torch.zeros(7, 2, device="cuda"))
    z_el = torch.as_tensor(rng.standard_normal((7, 2, 700), np.float32),
                           device="cuda")
    out["elipse"] = bf16_check(pm, "pm_elipse_K700_H7", f32e, b16e, dyne, dyne,
                               kp, z_el)
    ka = quat_kernels(auv, "auv")
    for rk, k, tau in ((2, AUV_K, AUV_H), (4, 700, 7)):
        f32a = auv_fused(k, tau, rk=rk)
        b16a = auv_fused(k, tau, rk=rk, compute_dtype="bfloat16")
        dyna = auv_dyn(b16a, 200.0, seed=4)
        z_a = torch.as_tensor(rng.standard_normal((tau, 6, k), np.float32),
                              device="cuda")
        out[f"auv_rk{rk}"] = bf16_check(pm, f"auv_rk{rk}_K{k}_H{tau}", f32a,
                                        b16a, dyna, dyna, ka, z_a)
        objs[f"auv_rk{rk}"] = (f32a, b16a, dyna)
        del z_a
    kn = quat_kernels(nnk, "nn")
    f32n = nn_fused(NN_K, NN_H)
    b16n = nn_fused(NN_K, NN_H, compute_dtype="bfloat16")
    dynn = auv_dyn(b16n, 200.0, seed=6)
    z_n = torch.as_tensor(rng.standard_normal((NN_H, 6, NN_K), np.float32),
                          device="cuda")
    out["nn"] = bf16_check(pm, "nn_K65536_H25", f32n, b16n, dynn, dynn, kn, z_n)
    objs["nn"] = (f32n, b16n, dynn)
    bfp = nn_fused(NN_K, NN_H, model_compute_dtype=torch.bfloat16)
    bfp.model.load_state_dict(f32n.model.state_dict())
    dynp = auv_dyn(bfp, 200.0, seed=6)
    out["nn_bf16_products"] = bf16_check(pm, "nn_bf16_products", f32n, bfp,
                                         dynn, dynp, kn, z_n)
    objs["nn_bf16_products"] = (f32n, bfp, dynp)
    out.update(bf16_variants_phase(pm, auv, nnk, kp, ka, kn, rng))
    # phase B at bf16 over the phase-A costs of the point mass and the AUV
    z6 = torch.as_tensor(rng.standard_normal((AUV_H, 6, AUV_K), np.float32),
                         device="cuda")
    ok = True
    for adim, (f32o, b16o, dyn_o), z_w in ((3, objs["pm"], z_big),
                                           (6, objs["auv_rk2"], z6)):
        k, tau = b16o.k, b16o.tau
        costs, _ = (pm.pm_fused_costs if adim == 3 else auv.auv_fused_costs)(
            b16o.consts, dyn_o, k, tau, seed=9, solve=2)
        nrm = torch.stack([costs.min(), 1.0 / ((costs.max() - costs.min())
                                               * b16o.lam)])
        res = {}
        for src, kws in (("injected", ({"z": z_w}, {"z": z_w})),
                         ("philox", philox_pair(pm, 9, 2, k, tau, adim))):
            res[src] = bf16_weights_check(pm, nrm, costs, tau, adim, *kws)
            ok &= res[src]["ok"]
        res["wnoise_max_abs_err"] = max(r["wnoise_max_abs_err"]
                                        for r in res.values())
        out[f"weights_adim{adim}"] = res
    del z6
    emit("bf16_weights", ok=ok, **{n: out[n] for n in ("weights_adim3",
                                                        "weights_adim6")})
    if not ok:
        raise AssertionError("bf16 phase B disagrees with its plain version: "
                             f"{out['weights_adim3']}, {out['weights_adim6']}")
    return {"check": out, "objs": objs}


def bf16_weights_check(pm, nrm, costs, tau: int, adim: int, kw,
                       kw_p) -> dict:
    """mppi_weights at bf16 (keywords ``kw``) against weights_plain at
    bf16 (``kw_p``: the same normals, ``philox_pair``) on the same
    phase-A costs: the merged weighted noise (z units) under the f32
    tolerance; the block rows' zsum, where each block's roundings are not
    yet averaged away by the merge, under BF16_GAP_SHARE of the f32
    kernel's distance from the plain bf16 version."""
    rows = {cd: pm.mppi_weights(nrm, costs, tau, adim, compute_dtype=cd, **kw)
            for cd in ("bfloat16", "float32")}
    plain = pm.weights_plain(nrm, costs, tau, adim, compute_dtype="bfloat16",
                             **kw_p)
    zk, sk = pm.pm_merge(rows["bfloat16"])
    zp, sp = pm.merge_plain(plain)
    ok_m, err_m, tol_ratio = close(zk / sk[1], zp / sp[1], BF16_WNOISE_RTOL,
                                   BF16_WNOISE_ATOL)
    zs = pm.STATS
    err_r = (rows["bfloat16"][:, zs:].double()
             - plain[:, zs:].double()).abs().max().item()
    gap_r = (rows["float32"][:, zs:].double()
             - plain[:, zs:].double()).abs().max().item()
    return {"ok": ok_m and gap_r > 0 and err_r <= BF16_GAP_SHARE * gap_r,
            "wnoise_max_abs_err": err_m, "wnoise_tol_ratio": tol_ratio,
            "rows_max_abs_err": err_r, "rows_f32_gap_max": gap_r,
            "rows_ratio": err_r / gap_r if gap_r else None}


def bf16_variants_phase(pm, auv, nnk, kp, ka, kn, rng) -> dict:
    """The bf16 instantiations the full-width checks do not reach, each
    against its plain bf16 version (``bf16_check``) at K=700, H=7: the
    point mass's (2, 1) and (4, 2) quadratic, the AUV's waypoints_quat
    mission and elipse3d (rk2), and scheduled + antithetic solves of the
    point mass, the AUV and the NN."""
    from mppi_tf_tpu_torch.cfg import default_config
    from mppi_tf_tpu_torch.envs.runner import build_model_and_cost

    k, tau = 700, 7
    out = {}

    def z_of(adim):
        return torch.as_tensor(rng.standard_normal((tau, adim, k),
                                                   np.float32), device="cuda")

    def pair(env, task, model_name, **opts):
        model, cost, sigma = build_model_and_cost(
            env, task, default_config(model_name), device="cuda")
        cls = (auv.FusedAUVMPPI if model.get_state_dim() == 13
               else pm.FusedPointMassMPPI)
        return [cls(model, cost, k=k, tau=tau, lam=env["lambda"],
                    upsilon=env["upsilon"], sigma=sigma, compute_dtype=cd,
                    **opts) for cd in ("float32", "bfloat16")]

    for sdim, adim in ((2, 1), (4, 2)):
        env = pm_env(**{"state-dim": sdim, "action-dim": adim,
                        "noise": (0.25 * np.eye(adim)).tolist()})
        f32p, b16p = pair(env, {"type": "static", "diag": True,
                                "goal": [0.5] * sdim, "Q": [1.0] * sdim},
                          "models/point_mass_model")
        dyn = b16p.pack_dyn(
            torch.as_tensor(0.3 * rng.standard_normal(sdim),
                            dtype=torch.float32, device="cuda"),
            torch.as_tensor(0.1 * rng.standard_normal((tau, adim)),
                            dtype=torch.float32, device="cuda"))
        out[f"pm_{sdim}x{adim}"] = bf16_check(
            pm, f"pm_{sdim}x{adim}_K{k}_H{tau}", f32p, b16p, dyn, dyn, kp,
            z_of(adim))
    # the JAX bench's AUV mission on envs/uuv_sim, the 3D ellipse on
    # envs/bluerov from a point of the ellipse (4, 0, -3)
    wq_legs = [rest_state(), rest_state()]
    wq_legs[0][2] = -5.0
    wq_legs[1][[0, 2, 3, 6]] = [4.0, -8.0, np.sin(0.4), np.cos(0.4)]
    x_e3 = rest_state()
    x_e3[[0, 2]] = [4.0, -3.0]
    for name, env, task, x0, scale in (
            ("waypoints_quat", "envs/uuv_sim",
             {"type": "waypoints_quat", "diag": True, "alpha": 0.2,
              "waypoints": [w.tolist() for w in wq_legs],
              "Q": [100.0, 100.0, 100.0, 10.0] + [1.0] * 6}, None, 200.0),
            ("elipse3d", "envs/bluerov", default_config("tasks/elipse3d_task"),
             x_e3, 20.0)):
        f32a, b16a = pair(default_config(env), task, "models/rexrov2")
        if not (b16a.consts.rk == 2 and b16a.consts.cost_kind == name):
            raise AssertionError(f"bf16 {name}: rk {b16a.consts.rk}, "
                                 f"{b16a.consts.cost_kind}")
        dyn = auv_dyn(b16a, scale, seed=8, x0=x0)
        out[f"auv_{name}"] = bf16_check(pm, f"auv_{name}_rk2_K{k}_H{tau}",
                                        f32a, b16a, dyn, dyn, ka, z_of(6))
    model, cost = workload("cuda")
    f32s, b16s = [pm.FusedPointMassMPPI(
        model, cost, k=k, tau=tau, lam=LAM, upsilon=UPSILON, sigma=SIGMA,
        compute_dtype=cd, **FUSED_BOTH) for cd in ("float32", "bfloat16")]
    dyn = b16s.pack_dyn(torch.zeros(6, device="cuda"),
                        torch.zeros(tau, 3, device="cuda"))
    out["pm_sched_anti"] = bf16_check(pm, f"pm_sched_anti_K{k}_H{tau}", f32s,
                                      b16s, dyn, dyn, kp, z_of(3))
    for name, make, kern in (("auv", auv_fused, ka), ("nn", nn_fused, kn)):
        f32q = make(k, tau, **FUSED_BOTH)
        b16q = make(k, tau, compute_dtype="bfloat16", **FUSED_BOTH)
        b16q.model.load_state_dict(f32q.model.state_dict())
        dyn = auv_dyn(b16q, 200.0, seed=9)
        out[f"{name}_sched_anti"] = bf16_check(
            pm, f"{name}_sched_anti_K{k}_H{tau}", f32q, b16q, dyn, dyn, kern,
            z_of(6))
    return out


def bf16_noise_phase(pm) -> dict:
    """pm_noise_dump at bf16 against the f32 dump of the same seed rounded
    to bf16, bit for bit, at K=100,000, H=50, adim 3 and 6; the antithetic
    dump's pairs sum to exactly 0."""
    out = {}
    pm.reset_launch_counts()
    for adim in (3, 6):
        z16 = pm.pm_noise_dump(5, 3, K, H, adim, "cuda",
                               compute_dtype="bfloat16")
        z32 = pm.pm_noise_dump(5, 3, K, H, adim, "cuda")
        out[f"adim{adim}_equal"] = bool(torch.equal(
            z16, z32.to(torch.bfloat16).float()))
        del z16, z32
    half = pm.antithetic_half(K)
    za = pm.pm_noise_dump(5, 3, K, H, 3, "cuda", half=half,
                          compute_dtype="bfloat16")
    out["antithetic_pair_sum_max"] = (
        za[..., half:] + za[..., :K - half]).abs().max().item()
    out["launches"] = pm.launch_counts["pm_noise_dump_bf16"]
    emit("bf16_noise", K=K, H=H, **out)
    if not (out["adim3_equal"] and out["adim6_equal"]
            and out["antithetic_pair_sum_max"] == 0.0):
        raise AssertionError(f"bf16 noise: {out}")
    return out


def bf16_loops_phase(pm, smi: str) -> dict:
    """The bf16 closed loops, each with the gate of its f32 twin and one
    sync a step: point_mass_bf16 (LOOP_STEPS a mode), the AUV's normalized
    dive and unnormalized steps, the NN dive on the kernels in both modes
    and with a bf16-products model, and DMDMPPI (LOOP_STEPS a mode)."""
    loops = {}
    bf = {"kernel-dtype": "bfloat16"}
    for dmd in (False, True):
        for normalize in (False, True):
            phase = "bf16_dmd_closed_loop" if dmd else "point_mass_bf16"
            ctrl, ms, counts = pm_loop_phase(phase, normalize, H, dmd=dmd,
                                             suffix="_bf16", **bf)
            loops["dmd" if dmd else "pm", normalize] = (ms, counts)
            if not normalize:
                prof = profile_steps(ctrl)
                emit("profile", kernel_path=ctrl.kernel_path,
                     model="dmd" if dmd else "point_mass",
                     kernel_dtype="bfloat16", card=smi, **prof)
                check_syncs(prof)
            del ctrl
    for normalize, steps in ((True, DIVE_STEPS), (False, AUV_PLAIN_STEPS)):
        ctrl, states, ms, counts = auv_loop("cuda", normalize, steps,
                                            kernel_dtype="bfloat16")
        ok, reading = dive_gate(normalize, states)
        want = ({"auv_fused_costs_bf16": steps, "mppi_weights_bf16": steps,
                 "pm_merge": 2 * steps} if normalize else
                {"auv_fused_solve_bf16": steps, "pm_merge": steps})
        got = {n: c for n, c in counts.items() if c}
        emit("bf16_auv_closed_loop", normalize=normalize, steps=steps,
             launches=got, step_ms_median=float(np.median(ms)), **reading)
        if not (ok and got == want):
            raise AssertionError(f"bf16 AUV loop (normalize={normalize}): "
                                 f"{reading}, {got}")
        loops["auv", normalize] = (ms, counts)
        if normalize:
            prof = profile_steps(ctrl, x=rest_state())
            emit("profile", kernel_path="cuda", model="auv",
                 kernel_dtype="bfloat16", card=smi, **prof)
            check_syncs(prof)
        del ctrl
    for name, opts in (("nn", {"kernel_dtype": "bfloat16"}),
                       ("nn_bf16_products",
                        {"model_compute_dtype": torch.bfloat16})):
        for normalize in (False, True):
            ctrl, states, ms, counts = nn_loop("cuda", normalize, **opts)
            ok, reading = nn_dive_gate(normalize, states)
            sfx = "_bfp" if "model_compute_dtype" in opts else "_bf16"
            want = ({f"nn_fused_costs{sfx}": NN_LOOP_STEPS,
                     f"mppi_weights{'_bf16' if sfx == '_bf16' else ''}":
                         NN_LOOP_STEPS, "pm_merge": 2 * NN_LOOP_STEPS}
                    if normalize else
                    {f"nn_fused_solve{sfx}": NN_LOOP_STEPS,
                     "pm_merge": NN_LOOP_STEPS})
            got = {n: c for n, c in counts.items() if c}
            emit(f"bf16_{name}_closed_loop", normalize=normalize,
                 steps=NN_LOOP_STEPS, launches=got,
                 step_ms_median=float(np.median(ms)), **reading)
            if not (ok and got == want):
                raise AssertionError(f"{name} loop (normalize={normalize}): "
                                     f"{reading}, {got}")
            loops[name, normalize] = (ms, counts)
            if name == "nn" and not normalize:
                prof = profile_steps(ctrl, x=rest_state())
                emit("profile", kernel_path="cuda", model="nn",
                     normalize=False, kernel_dtype="bfloat16", card=smi,
                     **prof)
                check_syncs(prof)
            del ctrl
    return loops


def one_step_errors(model, data) -> tuple:
    """(one-step MSE of ``model`` on the transitions ``data``, the MSE of
    predicting no change), in f64 on the host."""
    dev = model.device
    with torch.no_grad():
        pred = model.step(
            torch.as_tensor(data["obs"], dtype=model.dtype, device=dev),
            torch.as_tensor(data["act"], dtype=model.dtype, device=dev))
    pred = pred.double().cpu().numpy()
    return (float(np.mean((pred - data["next_obs"]) ** 2)),
            float(np.mean((data["obs"] - data["next_obs"]) ** 2)))


def mbrl_dive(learner, plant, cost, normalize: bool, smi: str):
    """One dive of the mbrl phase: MPPI on the NN kernels (K=NN_K,
    H=NN_H) over the learner's weights, ClosedLoopRunner against the known
    plant with a refit every MBRL_TRAIN_EVERY steps, launch counts reset
    just before it; then 20 solve steps profiled (one sync a step).
    Returns (its readings, the runner)."""
    from mppi_tf_tpu_torch.controller import MPPI
    from mppi_tf_tpu_torch.envs.runner import ClosedLoopRunner
    from mppi_tf_tpu_torch.kernels import pm_mppi as pm
    from mppi_tf_tpu_torch.models.nn import NNAUVModel

    ctrl = MPPI(NNAUVModel(device="cuda"), cost, k=NN_K, tau=NN_H,
                lam=AUV_LAM, upsilon=AUV_UPSILON, sigma=NN_LOOP_SIGMA,
                seed=3, normalize_cost=normalize, kernel="cuda",
                device="cuda")
    ctrl.model_params = learner.params
    runner = ClosedLoopRunner(plant, ctrl, control_dt=plant.dt,
                              learner=learner,
                              train_every=MBRL_TRAIN_EVERY)
    solve_ms, train_ms, train_dev = [], [], []
    next_fn, train_fn = ctrl.next, runner.train_step

    def timed_next(x):
        t0 = time.perf_counter()
        u = next_fn(x)
        solve_ms.append((time.perf_counter() - t0) * 1e3)
        return u

    def timed_train():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        train_fn()
        end.record()
        torch.cuda.synchronize()
        train_ms.append((time.perf_counter() - t0) * 1e3)
        train_dev.append(start.elapsed_time(end))

    ctrl.next, runner.train_step = timed_next, timed_train
    plant.reset()
    pm.reset_launch_counts()
    t0 = time.perf_counter()
    states, _ = runner.run(NN_LOOP_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(pm.launch_counts)
    del ctrl.next, runner.train_step
    z_end = float(states[-1, 2])
    drift = float(np.abs(np.linalg.norm(states[:, 3:7], axis=1) - 1).max())
    prof = profile_steps(ctrl, x=rest_state())
    emit("profile", kernel_path=ctrl.kernel_path, model="mbrl",
         normalize=normalize, card=smi, **prof)
    check_syncs(prof)
    out = {"normalize": normalize, "K": NN_K, "H": NN_H,
           "steps": NN_LOOP_STEPS, "train_every": MBRL_TRAIN_EVERY,
           "refits": len(train_ms), "z_final": z_end,
           "z_err": abs(z_end + 1.0), "tol": MBRL_LOOP_TOL, "q_drift": drift,
           "launches": counts, "seconds": seconds,
           "solve_step_ms_median": float(np.median(solve_ms)),
           "solve_step_ms_p90": float(np.percentile(solve_ms, 90)),
           "train_step_ms": train_ms, "train_step_event_ms": train_dev,
           "ms_an_epoch_in_refits": float(np.mean(train_dev))
           / learner.num_epochs,
           "ms_a_step_with_refits": 1e3 * seconds / NN_LOOP_STEPS,
           "z_every_10": states[::10, 2].tolist(),
           "solve_profile": {k: prof[k] for k in (
               "wall_us_per_step", "device_us_per_step",
               "kernel_launches_per_step", "syncs_per_step")}}
    emit("mbrl_dive", card=smi, **out)
    want = ({"nn_fused_costs": NN_LOOP_STEPS, "mppi_weights": NN_LOOP_STEPS,
             "pm_merge": 2 * NN_LOOP_STEPS} if normalize else
            {"nn_fused_solve": NN_LOOP_STEPS, "pm_merge": NN_LOOP_STEPS})
    want = {n: want.get(n, 0) for n in counts}
    if not (ctrl.kernel_path == "cuda" and counts == want
            and len(train_ms) == NN_LOOP_STEPS // MBRL_TRAIN_EVERY
            and abs(z_end + 1.0) < MBRL_LOOP_TOL and drift < 1e-3
            and np.all(np.isfinite(states))):
        raise AssertionError(f"mbrl dive (normalize={normalize}): {out}, "
                             f"launches want {want}")
    return out, runner


def mbrl_phase(pm, nnk, nn_k, smi: str, workdir: str) -> dict:
    """The model-based RL loop through the NN kernels at full width: (a)
    MBRL_BUFFER transitions of the known plant into the learner's native
    replay buffer; (b) a 3x32 NNAUVModel learned from them on the card
    (ms an epoch with CUDA events; gates: one-step MSE below MBRL_MSE_SHARE
    of the stay-put error, the last loss below the first); (c) the NN
    kernels against their plain versions on the learned weights written
    through ``MPPI.model_params``, then again after a further training and
    write, whose costs must move; (d) the dive with online refits in each
    solve mode (``mbrl_dive``); (e) the analytic learner at the headline
    width: ``run_experiment(train_every=)`` on the bundled point mass
    through pm_fused_solve, the controller's live mass and the solve's dyn
    held to the learner's after every refit, and the CLI with -t."""
    from mppi_tf_tpu_torch.cfg import default_config
    from mppi_tf_tpu_torch.collect import collect_transitions
    from mppi_tf_tpu_torch.controller import MPPI
    from mppi_tf_tpu_torch.costs import get_cost
    from mppi_tf_tpu_torch.envs import run_experiment
    from mppi_tf_tpu_torch.envs.runner import ClosedLoopRunner
    from mppi_tf_tpu_torch.learning import Learner
    from mppi_tf_tpu_torch.models.nn import NNAUVModel

    out = {}
    # (a) collect
    learner = Learner(NNAUVModel(hidden=(32, 32, 32), seed=MBRL_SEED,
                                 device="cuda"))
    plant = KnownPlant()
    t0 = time.perf_counter()
    mbrl_collect(collect_transitions, plant, learner.rb)
    out["collect"] = {"transitions": len(learner.rb),
                      "backend": learner.rb.backend,
                      "seconds": time.perf_counter() - t0}
    if learner.rb.backend != "native" or len(learner.rb) != MBRL_BUFFER:
        raise AssertionError(f"mbrl collection: {out['collect']}")
    data = learner.rb_trans()
    # (b) learn on the card
    learner.stats()
    X, Y = learner._prepare(data)
    with torch.no_grad():
        loss0 = float(learner._loss(X, Y))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    last = learner.train_all(epoch=MBRL_EPOCHS, learning_rate=MBRL_LR)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with torch.no_grad():
        loss1 = float(learner._loss(X, Y))
    mse, base = one_step_errors(learner.model, data)
    epoch_ms = start.elapsed_time(end) / MBRL_EPOCHS
    out["learn"] = {"epochs": MBRL_EPOCHS, "lr": MBRL_LR,
                    "loss_first": loss0, "loss_last_epoch": last,
                    "loss_final": loss1, "one_step_mse": mse,
                    "stay_put_mse": base, "mse_share": mse / base,
                    "gate_share": MBRL_MSE_SHARE,
                    "ms_an_epoch": epoch_ms, "wall_s": wall}
    if not (mse < MBRL_MSE_SHARE * base and loss1 < loss0):
        raise AssertionError(f"mbrl learning: {out['learn']}")
    # (c) the kernels on learned weights, before and after a rewrite
    cost = get_cost(known_plant_task(), lam=AUV_LAM, gamma=AUV_GAMMA,
                    upsilon=AUV_UPSILON, sigma=NN_LOOP_SIGMA, device="cuda")
    ctrl = MPPI(NNAUVModel(device="cuda"), cost, k=NN_K, tau=NN_H,
                lam=AUV_LAM, upsilon=AUV_UPSILON, sigma=NN_LOOP_SIGMA,
                seed=3, kernel="cuda", device="cuda")
    fused = ctrl._fused
    ctrl.model_params = learner.params
    z = torch.as_tensor(np.random.default_rng(13).standard_normal(
        (NN_H, 6, NN_K), np.float32), device="cuda")
    chk_a = check_auv(nn_k, pm, fused, z, "mbrl_learned_K65536_H25",
                      useq_scale=5.0, end_to_end=True)
    costs_a = nnk.nn_fused_costs(fused.consts, auv_dyn(fused, 5.0, seed=11),
                                 NN_K, NN_H, z=z)[0]
    learner.train_all(epoch=MBRL_REWRITE_EPOCHS)
    ctrl.model_params = learner.params
    chk_b = check_auv(nn_k, pm, fused, z, "mbrl_rewritten_K65536_H25",
                      useq_scale=5.0, end_to_end=True)
    costs_b = nnk.nn_fused_costs(fused.consts, auv_dyn(fused, 5.0, seed=11),
                                 NN_K, NN_H, z=z)[0]
    same, moved_abs, _ = close(costs_b, costs_a, COST_RTOL, COST_ATOL)
    # the constant-feature case: weights learned from one episode, whose
    # quaternion features stay at rest (x_std 1e-8)
    one = Learner(NNAUVModel(hidden=(32, 32, 32), seed=MBRL_SEED,
                             device="cuda"))
    lim = MBRL_ACT_MAX * np.ones(6)
    collect_transitions(KnownPlant(), one.rb, MBRL_BUFFER, 6, -lim, lim,
                        seed=MBRL_ONE_EPISODE_SEED, control_dt=plant.dt)
    one.stats()
    one.train_all(epoch=MBRL_EPOCHS, learning_rate=MBRL_LR)
    ctrl.model_params = one.params
    chk_one = check_auv(nn_k, pm, fused, z, "mbrl_one_episode_K65536_H25",
                        useq_scale=5.0, end_to_end=True)
    chk_one["min_x_std"] = float(ctrl._model.x_std.min())
    out["kernels"] = {"learned": chk_a, "rewritten": chk_b,
                      "one_episode": chk_one,
                      "costs_moved_max_abs": moved_abs,
                      "costs_moved_beyond_tolerance": not same}
    if same:
        raise AssertionError(f"the rewrite did not reach the kernels: "
                             f"costs moved {moved_abs}")
    if not chk_one["min_x_std"] < 1e-7:
        raise AssertionError(f"one episode left no constant feature: "
                             f"{chk_one['min_x_std']}")
    del z, ctrl, fused, one
    # (d) the dives with online refits, each solve mode; then two refits
    # profiled apart from the solve steps
    out["dives"], runners = zip(*[
        mbrl_dive(learner, plant, cost, normalize, smi)
        for normalize in (False, True)])
    prof_t = profile_run(lambda: [runners[-1].train_step()
                                  for _ in range(2)], 2)
    emit("profile", kernel_path="cuda", model="mbrl_train_step", card=smi,
         epochs_a_step=learner.num_epochs, **prof_t)
    out["train_step_profile"] = {k: prof_t[k] for k in (
        "wall_us_per_step", "device_us_per_step", "kernel_launches_per_step",
        "syncs_per_step", "top_kernels_us_per_step")}
    del runners
    # (e) the analytic learner at the headline width, and the CLI's -t
    refits = []
    train_step = ClosedLoopRunner.train_step

    def checked(runner):
        train_step(runner)
        c = runner.controller
        with torch.no_grad():
            dyn = c._fused.pack_dyn(torch.zeros(6, device="cuda"), c.useq)
        learned = runner.learner.params["mass"]
        refits.append({"live": c._model.mass.item(), "learned":
                       float(learned), "dyn_inv_mass": float(dyn[0]),
                       "inv_learned": float((1.0 / learned).float())})

    ClosedLoopRunner.train_step = checked
    pm.reset_launch_counts()
    try:
        res = run_experiment(pm_env(), default_config("tasks/static_cost"),
                             default_config("models/point_mass_model"),
                             steps=MBRL_PM_STEPS,
                             train_every=MBRL_PM_TRAIN_EVERY)
    finally:
        ClosedLoopRunner.train_step = train_step
    counts = dict(pm.launch_counts)
    ctrl_pm = res["controller"]
    want = {n: 0 for n in counts}
    want.update(pm_fused_solve=MBRL_PM_STEPS, pm_merge=MBRL_PM_STEPS)
    out["point_mass"] = {"K": K, "H": H, "steps": MBRL_PM_STEPS,
                         "train_every": MBRL_PM_TRAIN_EVERY,
                         "kernel_path": ctrl_pm.kernel_path,
                         "structure": ctrl_pm._fused.consts.structure,
                         "refits": refits, "launches": counts}
    if not (ctrl_pm.kernel_path == "cuda" and counts == want
            and len(refits) == MBRL_PM_STEPS // MBRL_PM_TRAIN_EVERY
            and all(r["live"] == r["learned"]
                    and r["dyn_inv_mass"] == r["inv_learned"]
                    for r in refits)
            and refits[-1]["learned"] < 5.0):
        raise AssertionError(f"mbrl point mass: {out['point_mass']}")
    cli_out, cli_counts = run_cli(
        workdir, "pm_train", default_config("envs/point_mass"),
        "tasks/static_cost", "models/point_mass_model", MBRL_CLI_STEPS,
        "-t", str(MBRL_CLI_TRAIN))
    out["cli"] = dict(cli_out, launches=cli_counts)
    if not (cli_out["kernel_path"] == "cuda"
            and cli_counts["pm_fused_solve"] == MBRL_CLI_STEPS
            and np.all(np.isfinite(cli_out["final_state"]))):
        raise AssertionError(f"mbrl cli -t: {out['cli']}")
    emit("mbrl", card=smi, **out)
    return out


def od_rows(pm):
    """The on-device phase's three rows: name -> a function building
    (controller, plant, steps, substeps, radius, x0, re-arm, host plant,
    gate) afresh; each controller on the kernels (kernel="cuda")."""
    from mppi_tf_tpu_torch import flagship
    from mppi_tf_tpu_torch.controller import MPPI
    from mppi_tf_tpu_torch.controller.dmd import DMDMPPI
    from mppi_tf_tpu_torch.envs import (AUVEnv, DevicePointMassEnv,
                                        PointMassEnv)
    from mppi_tf_tpu_torch.models.dmd import DMDModel

    def point_mass():
        model, cost = workload("cuda")
        ctrl = MPPI(model, cost, k=K, tau=H, lam=LAM, upsilon=UPSILON,
                    sigma=SIGMA, kernel="cuda")

        def gate(states, _):
            err = float(np.linalg.norm(states[-1] - np.asarray(GOAL)))
            return {"goal_err": err, "goal_tol": GOAL_TOL}, err < GOAL_TOL

        return (ctrl, DevicePointMassEnv(n_dof=3, dt=0.01), OD_STEPS,
                OD_SUBSTEPS, None, np.zeros(6), None,
                PointMassEnv(n_dof=3, dt=0.01), gate)

    def adaptive():
        prior, cost = workload("cuda")
        A1, B1 = prior.A.cpu().numpy(), prior.B.cpu().numpy()
        model = DMDModel(6, 3, dt=DT, init_A=A1, init_B=B1, reg=DMD_REG,
                         device="cuda")
        ctrl = DMDMPPI(model, cost, k=K, tau=H, lam=LAM, upsilon=UPSILON,
                       sigma=SIGMA, kernel="cuda", refit_every=DMD_REFIT)

        def gate(states, fitted):
            err = float(np.linalg.norm(states[-1] - np.asarray(GOAL)))
            b_err = float(np.abs(fitted["B"].cpu().numpy()
                                 - B1 / DMD_PLANT_MASS).max())
            return ({"goal_err": err, "goal_tol": DMD_GOAL_TOL,
                     "B_max_abs_err": b_err, "B_tol": DMD_B_TOL},
                    err < DMD_GOAL_TOL and b_err < DMD_B_TOL)

        return (ctrl, DevicePointMassEnv(n_dof=3, mass=DMD_PLANT_MASS,
                                         dt=0.01), DMD_ADAPT_STEPS,
                OD_SUBSTEPS, None, np.zeros(6), None,
                PointMassEnv(n_dof=3, mass=DMD_PLANT_MASS, dt=0.01), gate)

    def auv_mission():
        wps = [rest_state(), rest_state()]
        wps[0][2], wps[1][2] = -1.0, -2.0
        task = {"type": "waypoints_quat", "diag": True, "Q": DIVE_Q,
                "waypoints": [w.tolist() for w in wps], "alpha": 0.2}
        model, cost, _, _ = auv_modules("cuda", task, DIVE_SIGMA)
        ctrl = MPPI(model, cost, k=OD_AUV_K, tau=OD_AUV_H, lam=AUV_LAM,
                    upsilon=AUV_UPSILON, sigma=DIVE_SIGMA, seed=3,
                    normalize_cost=True, kernel="cuda")

        def gate(states, _):
            depth = np.abs(states[:, 2] + 2.0)
            # the periods after the pop: within the radius of leg one
            closest = float(depth[np.argmax(states[:, 2] < -1.0):].min())
            settle = depth[-OD_AUV_SETTLE:]
            drift = float(np.abs(np.linalg.norm(states[:, 3:7], axis=1)
                                 - 1.0).max())
            left = ctrl.waypoints_remaining()
            return ({"z_err": float(depth[-1]),
                     "z_err_closest_after_leg_one": closest,
                     "z_err_closest_last_periods": float(settle.min()),
                     "z_err_farthest_last_periods": float(settle.max()),
                     "last_periods": OD_AUV_SETTLE, "z_tol": AUV_WP_TOL,
                     "z_every_10_periods": states[9::10, 2].tolist(),
                     "legs_remaining": left, "quat_drift": drift},
                    closest < AUV_WP_TOL and settle.min() < AUV_WP_TOL
                    and left == 1 and drift < 1e-3)

        return (ctrl, AUVEnv(flagship.auv_params(), dt=0.02), OD_AUV_STEPS,
                DIVE_SUBSTEPS, AUV_WP_RADIUS, rest_state(),
                lambda c: c.set_waypoints(wps),
                AUVEnv(flagship.auv_params(), dt=0.02), gate)

    return {"on_device_loop": point_mass,
            "on_device_adaptive_dmd": adaptive,
            "on_device_auv_mission": auv_mission}


def plant_ms(step_fn, x, u, substeps: int, reps: int = 200) -> float:
    """Device ms of ``substeps`` plant steps, captured as a graph of their
    own and replayed ``reps`` times between CUDA events."""
    x, u = x.clone(), u.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y = x
        for _ in range(substeps):
            y = step_fn(y, u)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = x
        for _ in range(substeps):
            y = step_fn(y, u)
    return cuda_ms(g.replay, reps)


def od_device_index(pm, fused, adim: int, x0) -> dict:
    """A row's kernels with the solve index as a device tensor against
    the int, bit for bit, at 5 and past 2^32: the solve and costs kernels
    of its solve object, phase B and the noise dump."""
    useq = torch.zeros(fused.tau, adim, device="cuda")
    dyn = fused.pack_dyn(x0, useq)
    k, tau = fused.k, fused.tau
    out = {}
    for s in (5, OD_HIGH_SOLVE):
        dev = torch.tensor([s], dtype=torch.int64, device="cuda")
        same = {}
        for name, fn in (("solve", fused._fused), ("costs", fused._costs)):
            a, b = fn(dyn, 3, s, None), fn(dyn, 3, dev, None)
            a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
            same[name] = all(torch.equal(p, q) for p, q in zip(a, b))
        costs = fused._costs(dyn, 3, s, None)[0]
        nrm = torch.stack([costs.min(), 1.0 / ((costs.max() - costs.min())
                                               * fused.lam)]).float()
        same["weights"] = torch.equal(
            pm.mppi_weights(nrm, costs, tau, adim, 3, s),
            pm.mppi_weights(nrm, costs, tau, adim, 3, dev))
        same["noise_dump"] = torch.equal(
            pm.pm_noise_dump(3, s, k, tau, adim, "cuda"),
            pm.pm_noise_dump(3, dev, k, tau, adim, "cuda"))
        out[str(s)] = same
    return out


def od_row(pm, name: str, make, smi: str, shards: int = 1) -> dict:
    """One on-device row: the first run (capture), the noise hand-over to
    a host next, three timed runs (host clock, the sync included, and
    CUDA events), one profiled (its kernels counted by name against
    the captured launches times the periods), the eager periods at the
    same solve indices (bit for bit), the row's kernels against their
    plain versions at its K and H, the plant's own graph, the device solve
    index, and the host-driven loop of the same cell. A controller over a
    mesh of ``shards`` shards (``parallel/fused.py``) launches its solve
    kernel once a shard a period; its kernels are checked at K / shards."""
    from mppi_tf_tpu_torch.envs import build_on_device_loop
    from mppi_tf_tpu_torch.envs.runner import ClosedLoopRunner
    from mppi_tf_tpu_torch.kernels import auv_mppi as auv

    ctrl, plant, steps, substeps, radius, x0, arm, host_env, gate = make()
    loop = build_on_device_loop(ctrl, plant.step_fn, steps, substeps,
                                waypoint_radius=radius)
    adim = ctrl._adim

    def run(fn=loop, step0=OD_STEP0):
        if arm is not None:
            arm(ctrl)
        return fn(x0, step0=step0)

    out = {"steps": steps, "substeps": substeps, "k": ctrl._k,
           "tau": ctrl._tau, "card": smi}
    t0 = time.perf_counter()
    first = run(step0=None)
    out["first_run_s"] = time.perf_counter() - t0
    out["capture_s"] = loop.capture_s
    # a host next after the run draws solve step0 + steps
    xd = torch.as_tensor(x0, dtype=torch.float32, device="cuda")
    want = ctrl._fused_step(xd, ctrl.useq, solve=steps)[0].cpu().numpy()
    steps_after = ctrl._steps
    got = ctrl.next(x0)
    noise_ok = (steps_after == steps and ctrl._steps == steps + 1
                and np.array_equal(got, want))
    out["noise"] = {"steps_after_run": steps_after, "next_equals_solve":
                    bool(np.array_equal(got, want)), "ok": noise_ok}
    # three timed runs, each on the host clock and between CUDA events
    # (the mission's re-arm outside both)
    walls, events = [], []
    for _ in range(3):
        if arm is not None:
            arm(ctrl)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        loop(x0, step0=OD_STEP0)
        walls.append(time.perf_counter() - t0)
        end.record()
        torch.cuda.synchronize()
        events.append(start.elapsed_time(end) / steps)
    events_ms = float(np.median(events))
    pm.reset_launch_counts()
    graph = run()
    counts = {n: c for n, c in pm.launch_counts.items() if c}
    useq_g = loop.useq
    queue_g = (ctrl._cost.count.clone(), ctrl._cost.waypoints.clone()) \
        if radius is not None else ()
    # the profiler's count of the row's kernels by name against the
    # captured launches x periods (``profiled_counts``, ``profile_ok``)
    expected = {n: c * steps for n, c in loop.nodes.items()}
    prof, tries = profiled_counts(lambda: run(loop), steps, expected,
                                  OD_KERNEL_RX)
    profiled = tries[-1]
    syncs = {k: v * steps for k, v in prof["syncs_per_step"].items()}
    eager = run(loop.eager)
    useq_e = loop.useq
    queue_e = (ctrl._cost.count.clone(), ctrl._cost.waypoints.clone()) \
        if radius is not None else ()
    pairs = [("states", graph[0], eager[0]),
             ("actions", graph[1], eager[1]), ("useq", useq_g, useq_e),
             *[(n, a, b) for n, a, b in zip(("count", "waypoints"),
                                              queue_g, queue_e)]]
    if len(graph) == 3:
        pairs += [(n, graph[2][n], eager[2][n]) for n in ("A", "B")]
    bits = {n: bool(torch.equal(a, b)) for n, a, b in pairs}
    p_ms = plant_ms(plant.step_fn, xd, graph[1][-1], substeps)
    states = graph[0].cpu().double().numpy()
    readings, gate_ok = gate(states, graph[2] if len(graph) == 3 else None)
    # the row's kernels against their plain versions at its K and H on
    # injected z: the point mass's fused solve and merge (check_solve);
    # the mission's two-phase solve from the run's last state and nominal
    # sequence, with the queue the run left (one leg) and re-armed (the
    # blend of two)
    fused = getattr(ctrl._fused, "shards", [ctrl._fused])[0]
    k, tau = fused.k, ctrl._tau
    z = torch.as_tensor(np.random.default_rng(13).standard_normal(
        (tau, adim, k), np.float32), device="cuda")
    tag = f"{name}_K{k}_H{tau}"
    if radius is None:
        chk = check_solve(pm, fused, z, tag)
        errs = {"pm_fused_solve": chk["solve_only_max_abs_err"],
                "pm_merge": chk["merge_only_max_abs_err"]}
    else:
        kern = quat_kernels(auv, "auv")
        chks = [check_two_phase(kern, pm, fused, z, f"{tag}_final",
                                graph[0][-1], useq_e)]
        arm(ctrl)
        chks.append(check_two_phase(kern, pm, fused, z,
                                    f"{tag}_armed", graph[0][-1], useq_e))
        errs = {n: max(c[f"{key}_max_abs_err"] for c in chks)
                for n, key in (("auv_fused_costs", "costs"),
                               ("mppi_weights", "weights"),
                               ("pm_merge", "merge"))}
    del z
    index = od_device_index(pm, fused, adim, xd)
    refit = None
    if loop.adaptive:
        # one refit of the loop's window (DMDModel.fit: the QR in f64 at
        # the window's W rows), profiled over 20 calls; the model is put
        # back as it was
        model = ctrl._model
        saved = (model.A.detach().clone(), model.B.detach().clone())
        b = loop._bufs
        rp = profile_run(lambda: [loop._fit(b) for _ in range(20)], 20)
        with torch.no_grad():
            model.A.copy_(saved[0])
            model.B.copy_(saved[1])
        refit = {"window_rows": loop.W, "device_us": rp["device_us_per_step"],
                 "wall_us": rp["wall_us_per_step"],
                 "kernels": rp["kernel_launches_per_step"],
                 "syncs": rp["syncs_per_step"],
                 "fit_dtype": "float64 reflections, cast to float32"}
    # the host-driven loop of the same cell, a fresh controller
    twin, *_ = make()
    if arm is not None:
        arm(twin)
    runner = ClosedLoopRunner(host_env, twin, control_dt=DT,
                              waypoint_radius=radius or 0.0)
    host_env.reset(x0)
    runner.run(2)
    t0 = time.perf_counter()
    runner.run(OD_TWIN_STEPS)
    twin_wall = (time.perf_counter() - t0) * 1e3 / OD_TWIN_STEPS
    twin_prof = profile_run(lambda: runner.run(OD_TWIN_STEPS),
                            OD_TWIN_STEPS)
    dev_ms = prof["device_us_per_step"] / 1e3
    out.update(
        readings, gate_ok=bool(gate_ok), launches=counts,
        launches_profiled=profiled, profiled_runs=tries,
        launches_a_period=loop.nodes,
        captures=loop.captures, max_abs_err_vs_plain=errs,
        wall_ms_a_period=float(np.median(walls)) * 1e3 / steps,
        wall_ms_runs=[w * 1e3 for w in walls],
        events_ms_a_period=events_ms, events_ms_runs=events,
        profiler_device_ms_a_period=dev_ms,
        profiler_kernels_a_period=prof["kernel_launches_per_step"],
        graph_launch_host_us=prof.get("graph_launch_host_us"),
        device_busy_share=prof["device_busy_share"],
        top_kernels_us_a_period=prof["top_kernels_us_per_step"],
        syncs_a_run=syncs, replay_equals_eager=bits,
        plant_ms_a_period=p_ms, plant_share_of_events=p_ms / events_ms,
        device_solve_index=index, refit=refit,
        profiled_wall_ms_a_period=dev_ms / prof["device_busy_share"],
        host_driven={"steps": OD_TWIN_STEPS, "wall_ms_a_step": twin_wall,
                     "profiled_wall_ms_a_step":
                         twin_prof["wall_us_per_step"] / 1e3,
                     "device_ms_a_step": twin_prof["device_us_per_step"]
                     / 1e3,
                     "device_busy_share": twin_prof["device_busy_share"],
                     "launches_a_step":
                         twin_prof["kernel_launches_per_step"],
                     "syncs_a_step": twin_prof["syncs_per_step"]})
    emit(name, **out)
    index_ok = all(all(v.values()) for v in index.values())
    one_sync = (syncs.get("cudaStreamSynchronize", 0.0) == 1.0
                and syncs.get("cudaDeviceSynchronize", 0.0) <= 1.0)
    solve = "auv_fused_costs" if radius is not None else "pm_fused_solve"
    if not (gate_ok and noise_ok and all(bits.values()) and index_ok
            and one_sync and loop.captures == 1 and first is not None
            and expected.get(solve) == shards * steps
            and counts == expected
            and profile_ok(tries, expected)):
        raise AssertionError(f"{name}: {out}")
    return out


def on_device_phase(pm, smi: str) -> dict:
    """The on-device loop at the JAX bench's three on-device rows
    (``od_rows``), each through ``od_row``."""
    return {name: od_row(pm, name, make, smi)
            for name, make in od_rows(pm).items()}


# ---- the fleet (controller/fleet.py): one launch over all vehicles --------

def solve_name(kind: str, normalize: bool) -> str:
    """The entry point of a fleet row's solve kernel."""
    return ("pm" if kind == "point_mass" else "auv") + (
        "_fused_costs" if normalize else "_fused_solve")


def fleet_goals(kind: str, goal0) -> np.ndarray:
    """The JAX bench's fleet goals (mppi_tf_tpu/bench.py:805-811): the
    point masses' positions uniform(-1, 1), the rexrov2s' depths
    uniform(-2, 0) about the task's goal, from default_rng(0)."""
    rng = np.random.default_rng(0)
    if kind == "point_mass":
        goals = np.zeros((FLEET_PM_N, 6))
        goals[:, 0::2] = rng.uniform(-1.0, 1.0, (FLEET_PM_N, 3))
        return goals
    goals = np.tile(np.asarray(goal0, np.float64), (FLEET_AUV_N, 1))
    goals[:, 2] = rng.uniform(-2.0, 0.0, FLEET_AUV_N)
    return goals


def fleet_build(kind: str, normalize: bool):
    """(fleet on the kernels, its goals, the host plant's model on the CPU,
    x0): the bench's fleet row of ``kind`` (point_mass: the point-mass
    workload; auv: the rexrov2 flagship at AUV_SIGMA, lam 0.5)."""
    from mppi_tf_tpu_torch import flagship
    from mppi_tf_tpu_torch.controller import FleetMPPI
    from mppi_tf_tpu_torch.costs import get_cost
    from mppi_tf_tpu_torch.models import get_model

    if kind == "point_mass":
        model, cost = workload("cuda")
        host, _ = workload("cpu")
        sigma, lam, n, x0 = SIGMA, LAM, FLEET_PM_N, np.zeros(6)
    else:
        model = get_model(flagship.auv_params(), dt=DT, action_dim=6,
                          device="cuda")
        host = get_model(flagship.auv_params(), dt=DT, action_dim=6)
        cost = get_cost(flagship.auv_task(), lam=AUV_LAM, gamma=AUV_GAMMA,
                        upsilon=AUV_UPSILON, sigma=AUV_SIGMA, device="cuda")
        sigma, lam, n, x0 = AUV_SIGMA, AUV_LAM, FLEET_AUV_N, rest_state()
    goals = fleet_goals(kind, cost.goal.cpu().numpy())
    fleet = FleetMPPI(model, cost, n, k=FLEET_K, tau=FLEET_H, lam=lam,
                      upsilon=UPSILON, sigma=sigma, goals=goals,
                      normalize_cost=normalize, kernel="cuda")
    host.requires_grad_(False)
    return fleet, goals, host, np.tile(x0, (n, 1))


def fleet_gate(kind: str, normalize: bool, states, goals) -> tuple:
    """Every vehicle near its own goal at the end of a run: the point
    masses' position error, the AUVs' depth error and |q| = 1. The
    unnormalized rexrov2 row (the bench's solve mode) swings about its
    depths at this K (PERF.md): its gate is |q| = 1 and finite states, its
    depth errors are readings."""
    if not np.all(np.isfinite(states)):
        return {"finite": False}, False
    if kind == "point_mass":
        err = np.linalg.norm(states[-1][:, 0::2] - goals[:, 0::2], axis=1)
        return ({"goal_err_max": float(err.max()),
                 "goal_err_mean": float(err.mean()),
                 "goal_tol": FLEET_PM_TOL}, bool(err.max() < FLEET_PM_TOL))
    err = np.abs(states[-1][:, 2] - goals[:, 2])
    drift = float(np.abs(np.linalg.norm(states[..., 3:7], axis=-1)
                         - 1.0).max())
    near = bool(err.max() < FLEET_AUV_TOL) or not normalize
    return ({"z_err_max": float(err.max()), "z_err_mean": float(err.mean()),
             "z_tol": FLEET_AUV_TOL if normalize else None,
             "quat_drift": drift}, near and drift < 1e-3)


def fleet_kernel_outputs(pm, fused, dyn, z, solve) -> tuple:
    """Every kernel with a vehicle axis of a fleet solve object on ``dyn``
    ([n, size], or one vehicle's [size]): the fused rows, the costs and
    their rows, phase B's rows and the three merges."""
    part = fused._fused(dyn, 11, solve, z)
    costs, crows = fused._costs(dyn, 11, solve, z)
    lo, hi = costs.min(-1).values, costs.max(-1).values
    nrm = torch.stack([lo, 1.0 / ((hi - lo) * fused.lam)], dim=-1)
    wrows = pm.mppi_weights(nrm, costs, fused.tau, fused.adim, 11, solve, z,
                            antithetic=fused.antithetic)
    return (part, costs, crows, wrows, *pm.pm_merge(part),
            *pm.pm_merge(crows), *pm.pm_merge(wrows))


def fleet_bits(pm, fused, dyn, z, solve: int) -> dict:
    """The fleet launch of each kernel against n one-vehicle launches with
    solve s n + v, bit for bit (Philox by value and on the device, and
    injected z), and at n = 1 against the one-vehicle entry."""
    n = dyn.shape[0]
    dev = torch.tensor([solve], dtype=torch.int64, device="cuda")
    names = ("solve", "costs", "costs_rows", "weights", "merge_zsum",
             "merge_stats", "stats_merge_zsum", "stats_merge",
             "weights_merge_zsum", "weights_merge_stats")
    out = {}
    for label, zz, s in (("philox", None, solve), ("philox_device", None,
                                                   dev), ("injected", z,
                                                          solve)):
        fleet = fleet_kernel_outputs(pm, fused, dyn, zz, s)
        same = dict.fromkeys(names, True)
        for v in range(n):
            one = fleet_kernel_outputs(pm, fused, dyn[v],
                                       None if zz is None else zz[v],
                                       solve * n + v)
            for name, a, b in zip(names, fleet, one):
                same[name] &= bool(torch.equal(a[v], b))
        out[label] = same
    n1 = fleet_kernel_outputs(pm, fused, dyn[:1], None, solve)
    out["n1"] = {name: bool(torch.equal(a[0], b)) for name, a, b in zip(
        names, n1, fleet_kernel_outputs(pm, fused, dyn[0], None, solve))}
    return out


def fleet_vs_plain(pm, kern, fused, dyn, z, cost_tol) -> dict:
    """The fleet launch of each kernel against its plain version on
    injected z, vehicle by vehicle, at the tolerances of check_solve,
    check_auv and check_two_phase: the per-sample costs (``cost_tol``),
    the fused rows' cost stats (rtol 1e-4) and softmax against
    block_partials of the kernel's own costs (zsum / l at 1e-3 / 1e-5, m
    at 1e-6, l at 1e-3), phase B against weights_plain on the kernel's
    costs (1e-4 / 1e-6), the merge against merge_plain on the plain rows
    (zsum / l at 1e-5 / 1e-6, stats at 1e-5). Max errors over vehicles."""
    n, k, tau, adim, c = (dyn.shape[0], fused.k, fused.tau, fused.adim,
                          fused.consts)
    costs_k, _ = kern.costs(c, dyn, k, tau, z=z)
    part_k = kern.solve(c, dyn, k, tau, z=z)
    lo, hi = costs_k.min(-1).values, costs_k.max(-1).values
    nrm = torch.stack([lo, 1.0 / ((hi - lo) * fused.lam)], dim=-1)
    wrows_k = pm.mppi_weights(nrm, costs_k, tau, adim, z=z)
    rows_p = torch.stack([pm.weights_plain(nrm[v], costs_k[v], tau, adim,
                                           z=z[v]) for v in range(n)])
    zm, stm = pm.pm_merge(rows_p)
    err = dict.fromkeys(("costs", "cost_stats_rel", "fused_wnoise",
                         "fused_m_rel", "fused_l_rel", "weights", "merge",
                         "merge_stats_rel"), 0.0)
    ok = True
    for v in range(n):
        costs_p = kern.sample_costs_plain(c, dyn[v], z[v])
        ok_c, e_c, _ = close(costs_k[v], costs_p, *cost_tol)
        ref = torch.stack([costs_p.min(), costs_p.max(), costs_p.sum()])
        zs_k, sk = pm.merge_plain(part_k[v])
        zs_o, so = pm.merge_plain(pm.block_partials(
            costs_k[v], z[v].reshape(tau * adim, k), c.lam))
        ok_f, e_f, _ = close(zs_k / sk[1], zs_o / so[1], 1e-3, 1e-5)
        zs_w, sw = pm.merge_plain(wrows_k[v])
        zs_p, sp = pm.merge_plain(rows_p[v])
        ok_w, e_w, _ = close(zs_w / sw[1], zs_p / sp[1], 1e-4, 1e-6)
        ok_m, e_m, _ = close(zm[v] / stm[v, 1], zs_p / sp[1], 1e-5, 1e-6)
        vals = {"costs": e_c,
                "cost_stats_rel": ((sk[2:5] - ref).abs()
                                   / ref.abs()).max().item(),
                "fused_wnoise": e_f,
                "fused_m_rel": abs(sk[0].item() - so[0].item())
                / abs(so[0].item()),
                "fused_l_rel": abs(sk[1].item() - so[1].item())
                / so[1].item(),
                "weights": e_w, "merge": e_m,
                "merge_stats_rel": ((stm[v, :5].double() - sp[:5].double())
                                    .abs() / sp[:5].double().abs()
                                    .clamp_min(1e-30)).max().item()}
        for key, val in vals.items():
            err[key] = max(err[key], val)
        ok &= ok_c and ok_f and ok_w and ok_m
    ok &= (err["cost_stats_rel"] <= 1e-4 and err["fused_m_rel"] <= 1e-6
           and err["fused_l_rel"] <= 1e-3 and err["merge_stats_rel"] <= 1e-5)
    return {"ok": bool(ok), "max_errs": err, "cost_rtol": cost_tol[0],
            "cost_atol": cost_tol[1]}


def fleet_host_run(fleet, host, x0, steps: int):
    """``steps`` host-driven fleet steps (FleetMPPI.next, the model as the
    plant on the host): states [steps, n, sdim] and the wall ms a step."""
    x = torch.as_tensor(x0, dtype=torch.float32)
    out, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        a = fleet.next(x.numpy())
        ms.append((time.perf_counter() - t0) * 1e3)
        with torch.no_grad():
            x = host.step(x, torch.as_tensor(a))
        out.append(x.numpy().copy())
    return np.stack(out), ms


def fleet_host_profile(fleet, x0, expected: dict,
                       steps: int = FLEET_TWIN_STEPS) -> dict:
    """``profiled_counts`` over ``steps`` fleet.next calls at x0 against
    ``expected`` ({entry: launches}); ``ok`` is ``profile_ok``."""
    fleet.next(x0)
    torch.cuda.synchronize()

    def run():
        for _ in range(steps):
            fleet.next(x0)

    prof, tries = profiled_counts(run, steps, expected, FLEET_KERNEL_RX)
    return dict(prof, profiled_runs=tries, ok=profile_ok(tries, expected))


def fleet_row(pm, kind: str, normalize: bool, smi: str) -> dict:
    """One fleet row: its kernels (bits against one-vehicle launches,
    against the plain versions), FLEET_STEPS host-driven steps, the same
    fleet as n one-vehicle launches a step (timed in turns), the on-device
    fleet loop (captured once, replayed; eager bit for bit; one sync a
    run; the profiler's launches; a re-task between two runs), each run
    held to ``fleet_gate``."""
    from mppi_tf_tpu_torch.kernels import auv_mppi as auv

    t_row = time.perf_counter()
    fleet, goals, host, x0 = fleet_build(kind, normalize)
    fused = fleet._tpl._fused
    n, tau, adim = fleet.n_vehicles, FLEET_H, fleet._adim
    if not (fleet.kernel_path == "cuda" and fused.fleet_axis):
        raise AssertionError(f"fleet {kind}: {fleet.kernel_path}")
    label = f"fleet_{kind}{'_normalized' if normalize else ''}"
    out = {"n": n, "k": FLEET_K, "tau": tau, "normalize": normalize,
           "card": smi}
    # the kernels at the row's K and H
    rng = np.random.default_rng(21)
    xs = torch.as_tensor(x0 + 0.05 * rng.standard_normal(x0.shape),
                         dtype=torch.float32, device="cuda")
    if kind != "point_mass":
        xs[:, 3:7] /= torch.linalg.vector_norm(xs[:, 3:7], dim=1,
                                               keepdim=True)
    scale = 0.1 if kind == "point_mass" else 200.0
    us = torch.as_tensor(scale * rng.standard_normal((n, tau, adim)),
                         dtype=torch.float32, device="cuda")
    with torch.no_grad():
        dyn = fused.pack_dyn(xs, us, fleet.cost_params)
    z = torch.as_tensor(rng.standard_normal((n, tau, adim, FLEET_K),
                                            np.float32), device="cuda")
    out["bits"] = fleet_bits(pm, fused, dyn, z, solve=7)
    kern = (SimpleNamespace(solve=pm.pm_fused_solve,
                            costs=pm.pm_fused_costs,
                            sample_costs_plain=pm.sample_costs_plain,
                            fused_solve_plain=pm.fused_solve_plain,
                            fused_costs_plain=pm.fused_costs_plain)
            if kind == "point_mass" else quat_kernels(auv, "auv"))
    out["vs_plain"] = fleet_vs_plain(
        pm, kern, fused, dyn, z,
        (PM_COST_RTOL, PM_COST_ATOL) if kind == "point_mass"
        else (COST_RTOL, COST_ATOL))
    # the kernels' times at the row's inputs: the fleet launch (with the
    # small op that writes the vehicles' solve indices), n one-vehicle
    # launches, the plain version (a vehicle at a time)
    c = fused.consts
    costs, srows = fused._costs(dyn, 11, 3, None)
    lo, hi = costs.min(-1).values, costs.max(-1).values
    nrm = torch.stack([lo, 1.0 / ((hi - lo) * fused.lam)], dim=-1)
    part = fused._fused(dyn, 11, 3, None)
    calls = {
        "solve": (lambda: fused._fused(dyn, 11, 3, None),
                  lambda: [fused._fused(dyn[v], 11, 3 * n + v, None)
                           for v in range(n)],
                  lambda: [kern.fused_solve_plain(c, dyn[v], FLEET_K, tau,
                                                  11, 3 * n + v)
                           for v in range(n)]),
        "costs": (lambda: fused._costs(dyn, 11, 3, None),
                  lambda: [fused._costs(dyn[v], 11, 3 * n + v, None)
                           for v in range(n)],
                  lambda: [kern.fused_costs_plain(c, dyn[v], FLEET_K, tau,
                                                  11, 3 * n + v)
                           for v in range(n)]),
        "weights": (lambda: pm.mppi_weights(nrm, costs, tau, adim, 11, 3),
                    lambda: [pm.mppi_weights(nrm[v], costs[v], tau, adim,
                                             11, 3 * n + v)
                             for v in range(n)],
                    lambda: [pm.weights_plain(nrm[v], costs[v], tau, adim,
                                              11, 3 * n + v)
                             for v in range(n)]),
        "merge": (lambda: pm.pm_merge(part),
                  lambda: [pm.pm_merge(part[v]) for v in range(n)],
                  lambda: [pm.merge_plain(part[v]) for v in range(n)])}
    nb, n_z = -(-FLEET_K // pm.BLOCK), tau * adim
    part_bytes = 4.0 * n * nb * (pm.STATS + n_z)
    ops = (solve_ops(c, FLEET_K, tau, prng=True),
           solve_ops(c, FLEET_K, tau, prng=True, costs_only=True)) \
        if kind == "point_mass" else (
        auv_solve_ops(c, dyn[0], FLEET_K, tau, prng=True),
        auv_solve_ops(c, dyn[0], FLEET_K, tau, prng=True, costs_only=True))
    bounds = {
        "solve": bound_ms(4.0 * dyn.numel() + part_bytes, n * ops[0]),
        "costs": bound_ms(4.0 * dyn.numel() + 4.0 * n * FLEET_K
                          + 4.0 * n * nb * pm.STATS, n * ops[1]),
        "weights": bound_ms(n * (4.0 * FLEET_K + 8.0) + part_bytes,
                            n * weights_ops(FLEET_K, n_z, True)),
        "merge": bound_ms(part_bytes + 4.0 * n * (n_z + pm.STATS),
                          n * nb * (2.0 * n_z + 6))}
    times = {}
    for name, (fleet_fn, one_fn, plain_fn) in calls.items():
        times[name] = {
            "ms": cuda_ms(fleet_fn, 50),
            # the kernel's own: a fleet launch also runs the small op of
            # its solve indices
            "device_ms": device_ms(fleet_fn, rx=FLEET_KERNEL_RX[
                {"solve": solve_name(kind, False),
                 "costs": solve_name(kind, True), "weights": "mppi_weights",
                 "merge": "pm_merge"}[name]]),
            "per_vehicle_ms": cuda_ms(one_fn, 10),
            "plain_ms": cuda_ms(plain_fn, 1, 1),
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1]}
    del part, costs, srows
    del z
    # host-driven, FLEET_STEPS steps
    pm.reset_launch_counts()
    states_h, ms_h = fleet_host_run(fleet, host, x0, FLEET_STEPS)
    counts_h = {e: c for e, c in pm.launch_counts.items() if c}
    host_read, host_ok = fleet_gate(kind, normalize, states_h, goals)
    solve = solve_name(kind, normalize)
    prof_f = fleet_host_profile(fleet, x0, {solve: FLEET_TWIN_STEPS})
    # the same fleet as n one-vehicle launches a step, in turns with the
    # fleet launch (fleet, one-vehicle, one-vehicle, fleet)
    turns = {"fleet": [], "per_vehicle": []}
    for mode in ("fleet", "per_vehicle", "per_vehicle", "fleet"):
        fused.fleet_axis = mode == "fleet"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(FLEET_TWIN_STEPS):
            fleet.next(x0)
        turns[mode].append((time.perf_counter() - t0) * 1e3
                           / FLEET_TWIN_STEPS)
    fused.fleet_axis = False
    prof_v = fleet_host_profile(fleet, x0, {solve: n * FLEET_TWIN_STEPS})
    fused.fleet_axis = True
    out["host_driven"] = {
        "steps": FLEET_STEPS, **host_read, "gate_ok": host_ok,
        "launches": counts_h,
        "wall_ms_a_step_median": float(np.median(ms_h)),
        "wall_ms_a_step_p90": float(np.percentile(ms_h, 90)),
        "vehicle_solves_per_s": 1e3 * n / float(np.median(ms_h)),
        "profile": prof_f,
        "turns_wall_ms_a_step": turns,
        "per_vehicle_profile": prof_v}
    # the on-device fleet loop: the model as the plant, one step a period
    model = fleet._model

    def plant(x, u):
        return model.step(x, u)

    loop = fleet.build_on_device_loop(plant, FLEET_STEPS, substeps=1)
    t0 = time.perf_counter()
    first = loop(x0)
    first_s = time.perf_counter() - t0
    read_d, ok_d = fleet_gate(kind, normalize,
                              first[0].cpu().double().numpy(), goals)
    walls, events = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        loop(x0, step0=OD_STEP0)
        walls.append((time.perf_counter() - t0) * 1e3 / FLEET_STEPS)
        end.record()
        torch.cuda.synchronize()
        events.append(start.elapsed_time(end) / FLEET_STEPS)
    pm.reset_launch_counts()
    graph = loop(x0, step0=OD_STEP0)
    counts_d = {e: c for e, c in pm.launch_counts.items() if c}
    expected = {e: c * FLEET_STEPS for e, c in loop.nodes.items()}
    prof, tries = profiled_counts(lambda: loop(x0, step0=OD_STEP0),
                                  FLEET_STEPS, expected, FLEET_KERNEL_RX)
    syncs = {e: v * FLEET_STEPS for e, v in prof["syncs_per_step"].items()}
    eager = loop.eager(x0, step0=OD_STEP0)
    bits = {name: bool(torch.equal(a, b))
            for name, a, b in zip(("states", "actions"), graph, eager)}
    # re-task: vehicle 0 to a new goal, a second run from where the first
    # ended; the same graph steers it there
    retask = None
    if kind == "point_mass":
        fleet.set_vehicle_goal(0, FLEET_RETASK)
        second = loop(first[0][-1].cpu().numpy())
        err0 = float(np.linalg.norm(second[0][-1, 0, 0::2].cpu().numpy()
                                    - np.asarray(FLEET_RETASK)[0::2]))
        retask = {"vehicle": 0, "goal": FLEET_RETASK, "goal_err": err0,
                  "goal_tol": FLEET_PM_TOL, "captures": loop.captures,
                  "ok": bool(err0 < FLEET_PM_TOL and loop.captures == 1)}
    out["on_device"] = {
        "steps": FLEET_STEPS, **read_d, "gate_ok": ok_d,
        "first_run_s": first_s, "capture_s": loop.capture_s,
        "captures": loop.captures, "launches_a_period": loop.nodes,
        "launches": counts_d, "launches_profiled": tries[-1],
        "profiled_runs": tries, "syncs_a_run": syncs,
        "wall_ms_a_period": float(np.median(walls)),
        "events_ms_a_period": float(np.median(events)),
        "events_ms_runs": events,
        "profiler_device_ms_a_period": prof["device_us_per_step"] / 1e3,
        "device_busy_share": prof["device_busy_share"],
        "graph_launch_host_us": prof.get("graph_launch_host_us"),
        "top_kernels_us_a_period": prof["top_kernels_us_per_step"],
        "vehicle_solves_per_s": 1e3 * n / float(np.median(events)),
        "replay_equals_eager": bits, "retask": retask}
    out["kernel_times"] = times
    out["seconds"] = time.perf_counter() - t_row
    emit(label, **out)
    bits_ok = all(all(v.values()) for v in out["bits"].values())
    one_launch = prof_f["ok"] and prof_v["ok"]
    host_syncs = prof_f["syncs_per_step"]
    one_sync = (syncs.get("cudaStreamSynchronize", 0.0) == 1.0
                and host_syncs.get("cudaStreamSynchronize", 0.0) <= 1.0)
    if not (bits_ok and out["vs_plain"]["ok"] and host_ok and ok_d
            and all(bits.values()) and loop.captures == 1 and one_launch
            and one_sync and counts_h.get(solve) == FLEET_STEPS
            and counts_d == expected and profile_ok(tries, expected)
            and expected.get(solve) == FLEET_STEPS
            and (retask is None or retask["ok"])):
        raise AssertionError(f"{label}: {out}")
    return out


def fleet_phase(pm, smi: str) -> dict:
    """The JAX bench's two fleet rows, each in its solve mode
    (unnormalized) and normalized, through ``fleet_row``."""
    return {(kind, normalize): fleet_row(pm, kind, normalize, smi)
            for kind in ("point_mass", "auv") for normalize in (False, True)}


# ---- multi-GPU and sharding (parallel/): the sharded phase ----------------
# n shards or ranks on ONE card measure the sharding's overhead, not
# multi-GPU scaling. The headline point mass on a local mesh of SHARDS
# shards (K_local 25,000), the rexrov2 dive (K_local 65,536), the
# adaptive DMD row and the on-device loop row on the same mesh; ranks in
# processes of their own on the one card over gloo (parallel/cluster.py);
# a one-rank NCCL group for the captured all-reduce; the 32-point-mass
# fleet split over the mesh on the torch route. Gates (PERF.md, stated
# before the first run): a mesh of one shard and a one-rank NCCL group give
# the single-device kernels' bits; SHARDS shards on injected z stand within
# SHARD_L1_TOL of the single-device solve in every column, over that
# column's weighted l1 mass (the f64 softmax of the costs kernel's
# costs), and their merge within MERGE_L1_TOL of an f64 merge of the same
# rows; ranks equal a local mesh of the same shards bit for bit (every
# collective gathers the shards' rows and reduces them in shard order);
# the closed loops meet their single-device gates; the dp x tp train step
# on 2 x 2 ranks stands within SHARD_TRAIN_ATOL (weights) and
# SHARD_TRAIN_LOSS_RTOL (losses) of the single-device Adam steps at f32
SHARDS = 4
SHARD_L1_TOL = 1e-4
SHARD_CLUSTER_TIMEOUT = 300
SHARD_GROUP_STEPS, SHARD_GROUP_SUBSTEPS = 50, 10
SHARD_TRAIN_STEPS = 3
SHARD_TRAIN_ATOL, SHARD_TRAIN_LOSS_RTOL = 1e-4, 1e-5
SHARD_PROFILE_STEPS = 20


def cuda_mesh(n: int, axes=("k",)):
    from mppi_tf_tpu_torch.parallel import make_mesh

    return make_mesh(devices=["cuda"] * n, axis_names=axes)


def sharded_pm(n: int, normalize: bool = False, dmd: bool = False, **extra):
    """The point-mass workload's controller over a local mesh of ``n``
    shards on the card through get_controller (kernel "cuda"): a
    ShardedFusedMPPI, or for ``dmd`` the dmd row's ShardedFusedDMDMPPI."""
    from mppi_tf_tpu_torch.controller import get_controller

    model, cost = workload("cuda", dmd)
    cfg = {"samples": K, "horizon": H, "lambda": LAM, "upsilon": UPSILON,
           "noise": SIGMA.tolist(), "kernel": "cuda",
           "normalize": normalize, **extra}
    return get_controller(model, cost, cfg, mesh=cuda_mesh(n))


def headline_spec() -> dict:
    """The headline point mass as a cluster worker's workload
    (``_mp_worker.run_fused``): injected z from default_rng(0), as
    ``z_big``."""
    return {"model": {"type": "point_mass", "mass": MASS},
            "task": {"type": "static", "diag": True, "goal": GOAL, "Q": Q},
            "state_dim": 6, "action_dim": 3, "dt": DT, "gamma": GAMMA,
            "env": {"samples": K, "horizon": H, "lambda": LAM,
                    "upsilon": UPSILON, "noise": SIGMA.tolist()},
            "z_seed": 0, "x0": [0.0] * 6, "prng_steps": 2}


def shard_bits(pm) -> dict:
    """A mesh of one shard: the single-device fused solve's bits, both
    modes, at an int and a device solve index."""
    out = {}
    rng = np.random.default_rng(31)
    x0 = torch.as_tensor(0.1 * rng.standard_normal(6), dtype=torch.float32,
                         device="cuda")
    useq = torch.as_tensor(0.1 * rng.standard_normal((H, 3)),
                           dtype=torch.float32, device="cuda")
    for normalize in (False, True):
        one = sharded_pm(1, normalize)
        single = pm_controller("cuda", normalize)
        want, winfo = single._fused.solve(x0, useq, seed=0, solve=5,
                                          normalize=normalize)
        same = {}
        for label, s in (("int", 5), ("device", torch.tensor(
                [5], dtype=torch.int64, device="cuda"))):
            got, info = one._fused.solve(x0, useq, seed=0, solve=s,
                                         normalize=normalize)
            same[label] = bool(torch.equal(got, want) and all(
                torch.equal(info[n], winfo[n])
                for n in ("cost_min", "cost_max", "cost_mean", "nabla")))
        a1 = one._fused_step(x0, useq, solve=5)[0]
        a2 = single._fused_step(x0, useq, solve=5)[0]
        same["step"] = bool(torch.equal(a1, a2))
        out["normalized" if normalize else "unnormalized"] = same
    return out


def shard_vs_single(pm, z) -> dict:
    """SHARDS shards against the single-device solve on injected z (x0 and
    the nominal sequence zero, as the cluster's workload): each solve's
    distance to the f64 softmax of the costs kernel's costs and to each
    other, over the column's weighted l1 mass; the shard merge against an
    f64 merge of the same rows (``merge_gate``); the launches of one
    sharded solve."""
    out = {}
    x0 = torch.zeros(6, device="cuda")
    useq = torch.zeros(H, 3, device="cuda")
    for normalize in (False, True):
        four = sharded_pm(SHARDS, normalize)
        single = pm_controller("cuda", normalize)
        fused = single._fused
        pm.reset_launch_counts()
        wn4, _ = four._fused.solve(x0, useq, z=z, normalize=normalize)
        counts = {n: c for n, c in pm.launch_counts.items() if c}
        wn1, _ = fused.solve(x0, useq, z=z, normalize=normalize)
        costs, _ = pm.pm_fused_costs(fused.consts,
                                     fused.pack_dyn(x0, useq), K, H, z=z)
        c = costs.double()
        arg = c - c.min()
        if normalize:
            arg = arg / arg.max()
        w = torch.exp(-arg / LAM)
        zd = z.double()
        l = w.sum()
        scale = fused._scale.double()
        ref = ((zd @ w) @ scale.T) / l
        mass = ((zd.abs() @ w) @ scale.abs().T) / l
        rel = {"sharded_vs_single": ((wn4 - wn1).double().abs()
                                     / mass).max().item(),
               "sharded_vs_f64": ((wn4.double() - ref).abs()
                                  / mass).max().item(),
               "single_vs_f64": ((wn1.double() - ref).abs()
                                 / mass).max().item()}
        row = {"rel_l1": rel, "tol": SHARD_L1_TOL, "launches": counts,
               "wnoise_max_abs": wn1.abs().max().item(),
               "ok": rel["sharded_vs_single"] <= SHARD_L1_TOL}
        if not normalize:
            g = four._fused.rows(x0, useq, z=z)
            zsum, st = four._fused.merge(g)
            row["merge_vs_f64"] = merge_gate(pm, g, zsum, st)
            row["ok"] &= row["merge_vs_f64"]["ok"]
            want = {"pm_fused_solve": SHARDS, "pm_merge": SHARDS}
        else:
            want = {"pm_fused_costs": SHARDS, "mppi_weights": SHARDS,
                    "pm_merge": 2 * SHARDS}
        row["ok"] &= counts == want
        out["normalized" if normalize else "unnormalized"] = row
    return out


def drive_pm(ctrl, steps: int = LOOP_STEPS):
    """``steps`` of MPPI.next against the analytic point mass from rest:
    (final goal error, host ms a step, launch counts)."""
    from mppi_tf_tpu_torch.envs import PointMassEnv
    from mppi_tf_tpu_torch.kernels import _launch

    env = PointMassEnv(n_dof=3, mass=MASS, dt=DT)
    x = env.reset()
    ms = []
    _launch.reset_launch_counts()
    for _ in range(steps):
        t0 = time.perf_counter()
        u = ctrl.next(x)
        ms.append((time.perf_counter() - t0) * 1e3)
        x = env.step(u)
    counts = {n: c for n, c in _launch.launch_counts.items() if c}
    return float(np.linalg.norm(x.ravel() - np.asarray(GOAL))), ms, counts


def shard_loops(smi: str) -> dict:
    """The headline closed loop in both modes on SHARDS shards and on one
    device, in turns (sharded, single, sharded, single; LOOP_STEPS steps
    each from rest), each held to GOAL_TOL; then SHARD_PROFILE_STEPS steps
    of each profiled (device time, launches and syncs a step)."""
    out = {}
    for normalize in (False, True):
        four = sharded_pm(SHARDS, normalize)
        single = pm_controller("cuda", normalize)
        four.trace()
        single.trace()
        runs = {"sharded": [], "single": []}
        for _ in range(2):
            for name, ctrl in (("sharded", four), ("single", single)):
                runs[name].append(drive_pm(ctrl))
        row = {"K": K, "H": H, "shards": SHARDS, "k_local": K // SHARDS,
               "steps": LOOP_STEPS, "card": smi}
        for name, rs in runs.items():
            row[name] = {
                "goal_err": [r[0] for r in rs],
                "step_ms_median": [float(np.median(r[1])) for r in rs],
                "step_ms_p90": [float(np.percentile(r[1], 90)) for r in rs],
                "launches": [r[2] for r in rs],
                "launches_a_step": [{n: c / LOOP_STEPS
                                     for n, c in r[2].items()}
                                    for r in rs]}
            ctrl = four if name == "sharded" else single
            prof = profile_steps(ctrl, SHARD_PROFILE_STEPS)
            check_syncs(prof)
            row[name]["profile"] = prof
        want = ({"pm_fused_costs": SHARDS, "mppi_weights": SHARDS,
                 "pm_merge": 2 * SHARDS} if normalize else
                {"pm_fused_solve": SHARDS, "pm_merge": SHARDS})
        row["ok"] = (all(e < GOAL_TOL for e in row["sharded"]["goal_err"]
                         + row["single"]["goal_err"])
                     and all(a == want for a in
                             row["sharded"]["launches_a_step"]))
        emit("sharded_pm_loop", normalize=normalize, **row)
        out["normalized" if normalize else "unnormalized"] = row
    return out


def shard_dive(smi: str) -> dict:
    """The rexrov2 dive (normalized, K=262,144, H=25, DIVE_STEPS) on
    SHARDS shards: |z + 1| < DIVE_TOL and |q| = 1 within 1e-3, the
    two-phase kernels on every shard each step."""
    from mppi_tf_tpu_torch import flagship
    from mppi_tf_tpu_torch.envs import AUVEnv
    from mppi_tf_tpu_torch.kernels import _launch
    from mppi_tf_tpu_torch.parallel.fused import ShardedFusedMPPI

    goal = np.zeros(13)
    goal[[2, 6]] = [-1.0, 1.0]
    task = {"type": "static_quat", "diag": True, "goal": goal.tolist(),
            "Q": DIVE_Q}
    model, cost, sigma, ups = auv_modules("cuda", task, DIVE_SIGMA)
    ctrl = ShardedFusedMPPI(model, cost, cuda_mesh(SHARDS), k=AUV_K,
                            tau=AUV_H, lam=AUV_LAM, upsilon=ups, sigma=sigma,
                            seed=3, normalize_cost=True)
    ctrl.trace()
    env = AUVEnv(flagship.auv_params(), dt=0.02)
    x = env.reset()
    states, ms = [], []
    _launch.reset_launch_counts()
    for _ in range(DIVE_STEPS):
        t0 = time.perf_counter()
        u = ctrl.next(x)
        ms.append((time.perf_counter() - t0) * 1e3)
        for _ in range(DIVE_SUBSTEPS):
            x = env.step(u)
        states.append(x.ravel())
    counts = {n: c for n, c in _launch.launch_counts.items() if c}
    states = np.asarray(states)
    z_err = abs(float(states[-1, 2]) + 1.0)
    drift = float(np.abs(np.linalg.norm(states[:, 3:7], axis=1)
                         - 1.0).max())
    prof = profile_steps(ctrl, SHARD_PROFILE_STEPS, x=rest_state())
    check_syncs(prof)
    want = {"auv_fused_costs": SHARDS * DIVE_STEPS,
            "mppi_weights": SHARDS * DIVE_STEPS,
            "pm_merge": 2 * SHARDS * DIVE_STEPS}
    out = {"K": AUV_K, "H": AUV_H, "shards": SHARDS,
           "k_local": AUV_K // SHARDS, "steps": DIVE_STEPS, "z_err": z_err,
           "z_tol": DIVE_TOL, "quat_drift": drift, "launches": counts,
           "step_ms_median": float(np.median(ms)),
           "step_ms_p90": float(np.percentile(ms, 90)), "profile": prof,
           "card": smi,
           "ok": z_err < DIVE_TOL and drift < 1e-3 and counts == want}
    emit("sharded_auv_dive", **out)
    return out


def shard_dmd(smi: str) -> dict:
    """The adaptive DMD row's host-driven loop (``dmd_adaptive_phase``) on
    SHARDS shards: ShardedFusedDMDMPPI, the dynamic_ab solve on every
    shard, the refits due, the goal and the identified B."""
    from mppi_tf_tpu_torch.envs import PointMassEnv
    from mppi_tf_tpu_torch.envs.runner import ClosedLoopRunner
    from mppi_tf_tpu_torch.kernels import _launch
    from mppi_tf_tpu_torch.models.dmd import DMDModel
    from mppi_tf_tpu_torch.controller import ShardedFusedDMDMPPI

    prior, cost = workload("cuda")
    A1, B1 = prior.A.cpu().numpy(), prior.B.cpu().numpy()
    model = DMDModel(6, 3, dt=DT, init_A=A1, init_B=B1, reg=DMD_REG,
                     device="cuda")
    ctrl = ShardedFusedDMDMPPI(model, cost, cuda_mesh(SHARDS), k=K, tau=H,
                               lam=LAM, upsilon=UPSILON, sigma=SIGMA,
                               refit_every=DMD_REFIT)
    env = PointMassEnv(n_dof=3, mass=DMD_PLANT_MASS, dt=0.01)
    runner = ClosedLoopRunner(env, ctrl, control_dt=DT)
    _launch.reset_launch_counts()
    t0 = time.perf_counter()
    runner.run(DMD_PROFILE_FROM)
    fits_before = ctrl.n_fits
    prof = profile_run(lambda: runner.run(DMD_PROFILE_STEPS),
                       DMD_PROFILE_STEPS)
    prof["refits"] = ctrl.n_fits - fits_before
    runner.run(DMD_ADAPT_STEPS - DMD_PROFILE_FROM - DMD_PROFILE_STEPS)
    seconds = time.perf_counter() - t0
    counts = {n: c for n, c in _launch.launch_counts.items() if c}
    x = env.getState().ravel()
    B = ctrl.model_params["B"].cpu().numpy()
    goal_err = float(np.linalg.norm(x - np.asarray(GOAL)))
    b_err = float(np.abs(B - B1 / DMD_PLANT_MASS).max())
    fits_due = (DMD_ADAPT_STEPS - ctrl._min_samples) // DMD_REFIT + 1
    check_syncs(prof)
    want = {"pm_fused_solve": SHARDS * DMD_ADAPT_STEPS,
            "pm_merge": SHARDS * DMD_ADAPT_STEPS}
    out = {"K": K, "H": H, "shards": SHARDS, "steps": DMD_ADAPT_STEPS,
           "structure": ctrl._fused.consts.structure,
           "n_fits": ctrl.n_fits, "fits_due": fits_due,
           "goal_err": goal_err, "goal_tol": DMD_GOAL_TOL,
           "B_max_abs_err": b_err, "B_tol": DMD_B_TOL, "launches": counts,
           "ms_per_step_with_plant_and_refits": 1e3 * seconds
           / DMD_ADAPT_STEPS, "profile": prof, "card": smi,
           "ok": (ctrl.n_fits == fits_due and prof["refits"] == 2
                  and goal_err < DMD_GOAL_TOL and b_err < DMD_B_TOL
                  and counts == want
                  and ctrl._fused.consts.dynamic_ab)}
    emit("sharded_dmd_adaptive", **out)
    return out


def mbrl_training_data():
    """The mbrl phase's 264 transitions of the known-plant network
    (``mbrl_collect``) and a fresh 3x32 NNAUVModel on the card:
    (learner, X, Y), the pairs normalised by the learner's stats."""
    from mppi_tf_tpu_torch.collect import collect_transitions
    from mppi_tf_tpu_torch.learning import Learner
    from mppi_tf_tpu_torch.models.nn import NNAUVModel

    learner = Learner(NNAUVModel(hidden=(32, 32, 32), seed=MBRL_SEED,
                                 device="cuda"))
    mbrl_collect(collect_transitions, KnownPlant(), learner.rb)
    learner.stats()
    X, Y = learner._prepare(learner.rb_trans())
    return learner, X, Y


def shard_cluster(pm, smi: str) -> dict:
    """Ranks in processes of their own on the one card, over gloo
    (run_cluster(device="cuda")): 2 ranks x 1 shard and 2 x 2 on the
    headline's injected z and Philox streams against local meshes of the
    same shards, bit for bit; the dp x tp train step on 2 x 2 ranks
    against the single-device Adam steps; a one-rank NCCL group's solve
    and captured on-device loop (group_loop)."""
    from mppi_tf_tpu_torch.parallel._mp_worker import run_fused
    from mppi_tf_tpu_torch.parallel.cluster import run_cluster

    spec = headline_spec()
    out = {"card": smi}
    keys = ("fused_action", "fused_useq", "fused_prng_actions")
    for nproc, shards in ((2, 1), (2, 2)):
        t0 = time.perf_counter()
        ranks = run_cluster(nproc=nproc, devices_per_proc=shards,
                            timeout=SHARD_CLUSTER_TIMEOUT, device="cuda",
                            workloads=("fused",), spec=spec)
        seconds = time.perf_counter() - t0
        local = run_fused(cuda_mesh(nproc * shards), torch.device("cuda"),
                          spec)
        agree = all(r[k] == ranks[0][k] for r in ranks for k in keys)
        equal = {k: ranks[0][k] == local[k] for k in keys}
        per_rank = {n: c for n, c in ranks[0]["fused_launches"].items()}
        row = {"ranks": nproc, "shards_a_rank": shards,
               "ranks_agree": agree, "equal_to_local_mesh": equal,
               "launches_rank0": per_rank, "seconds": seconds,
               "backend": ranks[0]["backend"],
               "ok": agree and all(equal.values())
               and per_rank.get("pm_fused_solve") == 3 * shards}
        emit("sharded_ranks", **row)
        out[f"{nproc}x{shards}"] = row
    # the dp x tp train step on 2 x 2 ranks (one shard a rank)
    learner, X, Y = mbrl_training_data()
    data = {"X": X.cpu().numpy(), "Y": Y.cpu().numpy(),
            "hidden": np.asarray([32, 32, 32]), "lr": MBRL_LR,
            "steps": SHARD_TRAIN_STEPS, "dp": 2, "tp": 2,
            "dtype": "float32"}
    for i, layer in enumerate(learner.model.net):
        data[f"w{i}"] = layer.w.detach().cpu().numpy()
        data[f"b{i}"] = layer.b.detach().cpu().numpy()
    t0 = time.perf_counter()
    ranks = run_cluster(nproc=4, devices_per_proc=1,
                        timeout=SHARD_CLUSTER_TIMEOUT, device="cuda",
                        workloads=("train",), train=data)
    seconds = time.perf_counter() - t0
    # the single-device reference: SHARD_TRAIN_STEPS steps of one Adam
    # (optax's defaults, as Learner.train) on the whole network
    params = [p for _, p in learner._trainable(learner.model)]
    opt = torch.optim.Adam(params, lr=MBRL_LR, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for _ in range(SHARD_TRAIN_STEPS):
        opt.zero_grad()
        loss = learner._loss(X, Y)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    net = [{"w": layer.w.detach().cpu().double().numpy(),
            "b": layer.b.detach().cpu().double().numpy()}
           for layer in learner.model.net]
    w_err = max(float(np.abs(np.asarray(p[a]) - q[a]).max())
                for p, q in zip(ranks[0]["train_net"], net)
                for a in ("w", "b"))
    loss_err = max(abs(a - b) / abs(b) for a, b in
                   zip(ranks[0]["train_losses"], losses))
    agree = all(r["train_net"] == ranks[0]["train_net"]
                and r["train_losses"] == ranks[0]["train_losses"]
                for r in ranks)
    row = {"ranks": 4, "dp": 2, "tp": 2, "transitions": int(X.shape[0]),
           "hidden": [32, 32, 32], "steps": SHARD_TRAIN_STEPS,
           "lr": MBRL_LR, "ranks_agree": agree,
           "weights_max_abs_err": w_err, "weights_atol": SHARD_TRAIN_ATOL,
           "loss_max_rel_err": loss_err,
           "loss_rtol": SHARD_TRAIN_LOSS_RTOL,
           "losses": ranks[0]["train_losses"], "single_losses": losses,
           "seconds": seconds,
           "ok": agree and w_err <= SHARD_TRAIN_ATOL
           and loss_err <= SHARD_TRAIN_LOSS_RTOL}
    emit("sharded_train_dp_tp", **row)
    out["train"] = row
    # a one-rank NCCL group: the collective in the captured graph
    t0 = time.perf_counter()
    group = run_cluster(nproc=1, devices_per_proc=1,
                        timeout=SHARD_CLUSTER_TIMEOUT, device="cuda",
                        backend="nccl", workloads=("group_loop",),
                        spec=dict(spec, loop={
                            "steps": SHARD_GROUP_STEPS,
                            "substeps": SHARD_GROUP_SUBSTEPS,
                            "dt": 0.01}))[0]
    row = {k.removeprefix("group_"): v for k, v in group.items()
           if k.startswith("group_")}
    row.update(backend=group["backend"], seconds=time.perf_counter() - t0,
               ok=(group["backend"] == "nccl"
                   and all(group["group_solve_bits"].values())
                   and group["group_loop_replay_equals_eager"]
                   and group["group_loop_nodes"].get("pm_fused_solve") == 1
                   and group["group_loop_captures"] == 1))
    emit("sharded_nccl_group", **row)
    out["nccl"] = row
    return out


def shard_fleet(smi: str) -> dict:
    """The 32-point-mass fleet row split over SHARDS shards (the torch
    route: kernel="cuda" with a mesh raises): FLEET_STEPS host-driven
    steps, each vehicle held to FLEET_PM_TOL of its goal."""
    from mppi_tf_tpu_torch.controller import FleetMPPI

    model, cost = workload("cuda")
    host, _ = workload("cpu")
    host.requires_grad_(False)
    goals = fleet_goals("point_mass", cost.goal.cpu().numpy())
    kw = dict(k=FLEET_K, tau=FLEET_H, lam=LAM, upsilon=UPSILON,
              sigma=SIGMA, goals=goals, mesh=cuda_mesh(SHARDS, ("fleet",)))
    try:
        FleetMPPI(model, cost, FLEET_PM_N, kernel="cuda", **kw)
        refused = False
    except ValueError:
        refused = True
    fleet = FleetMPPI(model, cost, FLEET_PM_N, **kw)
    x0 = np.zeros((FLEET_PM_N, 6))
    fleet.next(x0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states, ms = fleet_host_run(fleet, host, x0, FLEET_STEPS)
    seconds = time.perf_counter() - t0
    readings, gate = fleet_gate("point_mass", False, states, goals)
    prof = profile_run(lambda: [fleet.next(x0) for _ in range(3)], 3)
    out = {"n": FLEET_PM_N, "shards": SHARDS,
           "vehicles_a_shard": FLEET_PM_N // SHARDS, "k": FLEET_K,
           "tau": FLEET_H, "steps": FLEET_STEPS,
           "kernel_path": fleet.kernel_path, "cuda_refused": refused,
           **readings, "step_ms_median": float(np.median(ms)),
           "seconds": seconds, "profile": prof, "card": smi,
           "ok": gate and refused and fleet.kernel_path == "torch"}
    emit("sharded_fleet", **out)
    return out


def sharded_launches(sh: dict) -> dict:
    """Each kernel row's launches in the sharded phase's runs, as counted
    in each run: the headline loops (both turns of both modes), the dive,
    the adaptive DMD loop (the dynamic_ab solve) and the on-device row's
    graph run."""
    total = {}

    def add(counts, rename=None):
        for name, c in counts.items():
            key = (rename or {}).get(name, name)
            total[key] = total.get(key, 0) + c

    for row in sh["loops"].values():
        for counts in row["sharded"]["launches"]:
            add(counts)
    add(sh["dive"]["launches"])
    add(sh["dmd"]["launches"],
        rename={"pm_fused_solve": "pm_fused_solve[dynamic_ab]"})
    add(sh["on_device"]["launches"])
    return {name: int(c) for name, c in total.items()}


def sharded_phase(pm, smi: str, on_device) -> dict:
    """The sharded phase (ROADMAP item 14); see SHARDS. Raises on any
    failed gate after printing every sub-phase's line. ``on_device``: the
    on-device phase's rows, beside which the sharded row is printed (None:
    not run)."""
    z = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (H, 3, K), np.float32), device="cuda")   # z_big's draw
    out = {"bits_one_shard": shard_bits(pm)}
    emit("sharded_one_shard_bits", **out["bits_one_shard"])
    out["vs_single"] = shard_vs_single(pm, z)
    del z
    emit("sharded_vs_single", K=K, H=H, shards=SHARDS,
         **out["vs_single"])
    out["loops"] = shard_loops(smi)
    out["dive"] = shard_dive(smi)
    out["dmd"] = shard_dmd(smi)
    out["cluster"] = shard_cluster(pm, smi)

    def make():
        from mppi_tf_tpu_torch.envs import (DevicePointMassEnv,
                                            PointMassEnv)

        ctrl = sharded_pm(SHARDS)

        def gate(states, _):
            err = float(np.linalg.norm(states[-1] - np.asarray(GOAL)))
            return {"goal_err": err, "goal_tol": GOAL_TOL}, err < GOAL_TOL

        return (ctrl, DevicePointMassEnv(n_dof=3, dt=0.01), OD_STEPS,
                OD_SUBSTEPS, None, np.zeros(6), None,
                PointMassEnv(n_dof=3, dt=0.01), gate)

    row = od_row(pm, "sharded_on_device_loop", make, smi, shards=SHARDS)
    rows = [("sharded", row)]
    if on_device is not None:
        rows.append(("single", on_device["on_device_loop"]))
    emit("sharded_on_device_vs_single", shards=SHARDS, card=smi, **{
        name: {key: r[key] for key in (
            "wall_ms_a_period", "events_ms_a_period",
            "profiler_device_ms_a_period", "profiler_kernels_a_period",
            "device_busy_share", "graph_launch_host_us", "syncs_a_run")}
        for name, r in rows})
    out["on_device"] = row
    out["fleet"] = shard_fleet(smi)
    bad = [name for name, ok in (
        ("bits_one_shard", all(all(v.values())
                               for v in out["bits_one_shard"].values())),
        ("vs_single", all(r["ok"] for r in out["vs_single"].values())),
        ("loops", all(r["ok"] for r in out["loops"].values())),
        ("dive", out["dive"]["ok"]), ("dmd", out["dmd"]["ok"]),
        ("cluster", all(r["ok"] for r in out["cluster"].values()
                        if isinstance(r, dict))),
        ("fleet", out["fleet"]["ok"])) if not ok]
    if bad:
        raise AssertionError(f"sharded phase failed: {bad}")
    return out


# ---- serving and tooling (ROADMAP item 15): serve.py, the coalescer, ------
# ---- the native f64 golden model, the card's ceilings, sweeps ----------------

#: the served headline loop (serve): the point mass at K, H through a
#: ControlServer on 127.0.0.1 and a ControlClient, LOOP_STEPS steps gated on
#: GOAL_TOL; then SERVE_MSTEP_ROUNDS m-step requests at m = SERVE_M from
#: rest, gated on JAX's SERVE_MSTEP_TOL (tests/test_serve.py:370)
SERVE_M, SERVE_MSTEP_ROUNDS, SERVE_MSTEP_TOL = 3, 100, 0.3
#: the coalesced fleet (serve_fleet): the point-mass fleet row (FLEET_PM_N
#: vehicles, FLEET_K, FLEET_H, unnormalized) behind the coalescer, one
#: client thread and socket a vehicle, SERVE_FLEET_ROUNDS lockstep rounds
SERVE_FLEET_ROUNDS = 100
#: the native golden model (native_golden): the kernel's distance from the
#: f64 core at most NATIVE_SHARE times the plain f32 path's, over max
#: |wnoise| and for each cost stat relative to the f64 stat. A cost stat
#: is one sample's cost (or their mean), a sum of H f32 terms: a kernel
#: stat within NATIVE_STAT_FLOOR = H f32 half-ulps of f64, the bound of
#: that sum's rounding, also passes (twice a plain distance that happens
#: to land near 0 is no gate)
NATIVE_SHARE, NATIVE_STAT_FLOOR = 2.0, H * 2.0 ** -24
#: the ceilings (roofline): a measured FMA or HBM rate above
#: CEILING_SHARE of its datasheet peak is a broken microbenchmark
CEILING_SHARE = 1.05
#: the sweep: two combos of SWEEP_STEPS on the bundled point-mass configs
SWEEP_STEPS = 50


def serve_phase(pm, smi: str) -> dict:
    """The headline controller behind the port's ControlServer: LOOP_STEPS
    closed-loop steps from a ControlClient (the plant on the client's
    side), held to GOAL_TOL, to one launch of pm_fused_solve and pm_merge
    a request, and bit for bit to a twin controller of the same seed
    driven directly on the same states; then SERVE_MSTEP_ROUNDS m-step
    requests (SERVE_M) from rest, and m = H + 2 refused. Times: the
    client's round trip, the server's solve_ms, the twin's MPPI.next."""
    from mppi_tf_tpu_torch.envs import PointMassEnv
    from mppi_tf_tpu_torch.serve import ControlClient, ControlServer

    ctrl, twin = pm_controller("auto"), pm_controller("auto")
    if (ctrl.kernel_path, twin.kernel_path) != ("cuda", "cuda"):
        raise AssertionError(f"served kernel='auto' resolved to "
                             f"{ctrl.kernel_path}")
    ctrl.trace()
    twin.trace()
    server = ControlServer(ctrl)
    host, port = server.serve_background()
    client = ControlClient(host, port)
    env = PointMassEnv(n_dof=3, mass=MASS, dt=DT)
    try:
        info = client.info()
        x = np.asarray(env.reset(), np.float64).ravel()
        states, served, rtt, solve_ms = [], [], [], []
        pm.reset_launch_counts()
        for _ in range(LOOP_STEPS):
            states.append(x.copy())
            t0 = time.perf_counter()
            resp = client.request(op="next", state=x.tolist())
            rtt.append((time.perf_counter() - t0) * 1e3)
            if "error" in resp:
                raise AssertionError(f"served next: {resp['error']}")
            served.append(resp["action"])
            solve_ms.append(resp["solve_ms"])
            x = np.asarray(env.step(np.asarray(resp["action"])),
                           np.float64).ravel()
        counts = dict(pm.launch_counts)
        err = float(np.linalg.norm(x - np.asarray(GOAL)))
        # m-step replies from rest: the plan advances by m a request
        x = np.asarray(env.reset(), np.float64).ravel()
        pm.reset_launch_counts()
        for _ in range(SERVE_MSTEP_ROUNDS):
            for u in client.next_plan(x, m=SERVE_M):
                x = np.asarray(env.step(u), np.float64).ravel()
        m_counts = dict(pm.launch_counts)
        m_err = float(np.linalg.norm(x - np.asarray(GOAL)))
        too_long = client.request(op="next", state=x.tolist(), m=H + 2)
        refused_launches = {n: pm.launch_counts[n] - m_counts[n]
                            for n in m_counts}
    finally:
        client.close()
        server.close()
    # the twin, driven directly on the served run's states
    twin_ms, twin_actions = [], []
    for s in states:
        t0 = time.perf_counter()
        twin_actions.append(twin.next(s))
        twin_ms.append((time.perf_counter() - t0) * 1e3)
    same = np.array_equal(np.asarray(served, np.float32),
                          np.asarray(twin_actions))
    want = {n: 0 for n in counts}
    want.update(pm_fused_solve=LOOP_STEPS, pm_merge=LOOP_STEPS)
    m_want = {n: 0 for n in m_counts}
    m_want.update(pm_fused_solve=SERVE_MSTEP_ROUNDS,
                  pm_merge=SERVE_MSTEP_ROUNDS)
    out = {"kernel": info["kernel"], "K": K, "H": H, "steps": LOOP_STEPS,
           "goal_err": err, "launches": counts, "bits_equal_twin": same,
           "round_trip_ms_median": float(np.median(rtt)),
           "round_trip_ms_p90": float(np.percentile(rtt, 90)),
           "solve_ms_median": float(np.median(solve_ms)),
           "solve_ms_p90": float(np.percentile(solve_ms, 90)),
           "twin_next_ms_median": float(np.median(twin_ms)),
           "twin_next_ms_p90": float(np.percentile(twin_ms, 90)),
           "mstep": {"m": SERVE_M, "rounds": SERVE_MSTEP_ROUNDS,
                     "goal_err": m_err, "tol": SERVE_MSTEP_TOL,
                     "launches": m_counts,
                     "m_tau_plus_2": too_long,
                     "launches_of_refused": refused_launches}}
    emit("serve", card=smi, **out)
    if not (info["kernel"] == "cuda" and counts == want and same
            and err < GOAL_TOL):
        raise AssertionError(f"served loop: kernel {info['kernel']}, "
                             f"launches {counts}, twin bits {same}, "
                             f"goal error {err}")
    if not (m_counts == m_want and m_err < SERVE_MSTEP_TOL
            and "error" in too_long and not any(refused_launches.values())):
        raise AssertionError(f"served m-step replies: {out['mstep']}")
    return out


def serve_fleet_phase(pm, smi: str) -> dict:
    """The point-mass fleet row behind the coalescer: one client thread
    and socket a vehicle, SERVE_FLEET_ROUNDS lockstep rounds. Gates: no
    error reply; each reply is its dispatch's row bit for bit (the
    fleet's next and the dispatcher wrapped to record each dispatch's
    states, actions and batch); the batches hold every request once; one
    launch of pm_fused_solve and of pm_merge a dispatch; fewer dispatches
    than requests. No goal gate: a vehicle answered in a round's first
    batch is replanned again from its cached state in the next (the JAX
    server's semantics); the final errors are reported."""
    import threading

    from mppi_tf_tpu_torch.envs import PointMassEnv
    from mppi_tf_tpu_torch.serve import ControlClient, ControlServer

    fleet, goals, _host, x0 = fleet_build("point_mass", False)
    n = fleet.n_vehicles
    fleet.next(x0)     # warm-up: the first call builds the solve's buffers
    dispatches, batches = [], []
    fleet_next = fleet.next

    def recorded_next(states):
        actions = fleet_next(states)
        dispatches.append((np.array(states), actions.copy()))
        return actions

    fleet.next = recorded_next
    server = ControlServer(fleet)
    coalescer = server._coalescer
    dispatch = coalescer._dispatch

    def recorded_dispatch(batch):
        dispatch(batch)
        batches.append([(v, s.copy(), box["resp"])
                        for v, s, _m, box, _ev in batch])

    coalescer._dispatch = recorded_dispatch
    host, port = server.serve_background()
    start = threading.Barrier(n + 1, timeout=300)
    done = threading.Barrier(n + 1, timeout=300)
    finals, errors = {}, []

    def vehicle(v):
        env = PointMassEnv(n_dof=3, mass=MASS, dt=DT)
        x = np.asarray(env.reset(), np.float64).ravel()
        client = ControlClient(host, port)
        try:
            for _ in range(SERVE_FLEET_ROUNDS):
                start.wait()
                resp = client.request(op="next", vehicle=v,
                                      state=x.tolist())
                if "error" in resp:
                    errors.append((v, resp["error"]))
                else:
                    x = np.asarray(env.step(np.asarray(resp["action"])),
                                   np.float64).ravel()
                done.wait()
        finally:
            client.close()
            finals[v] = x

    threads = [threading.Thread(target=vehicle, args=(v,), daemon=True)
               for v in range(n)]
    for t in threads:
        t.start()
    pm.reset_launch_counts()
    walls = []
    try:
        for _ in range(SERVE_FLEET_ROUNDS):
            start.wait()
            t0 = time.perf_counter()
            done.wait()
            walls.append((time.perf_counter() - t0) * 1e3)
    finally:
        for t in threads:
            t.join(timeout=60)
        server.close()
    counts = dict(pm.launch_counts)
    rows_equal = len(batches) == len(dispatches) and all(
        resp.get("batched") == len(batch)
        and np.array_equal(states[v], s)
        and resp["action"] == actions[v].tolist()
        for batch, (states, actions) in zip(batches, dispatches)
        for v, s, resp in batch)
    requests = n * SERVE_FLEET_ROUNDS
    answered = sum(len(b) for b in batches)
    err = np.linalg.norm(np.stack([finals[v] for v in range(n)])[:, 0::2]
                         - goals[:, 0::2], axis=1)
    total_s = sum(walls) / 1e3
    out = {"vehicles": n, "K": FLEET_K, "H": FLEET_H,
           "rounds": SERVE_FLEET_ROUNDS, "requests": requests,
           "answered_in_batches": answered, "dispatches": len(dispatches),
           "dispatches_per_round": len(dispatches) / SERVE_FLEET_ROUNDS,
           "batch_sizes": sorted({len(b) for b in batches}),
           "launches": counts, "error_replies": errors[:5],
           "rows_equal_dispatch": rows_equal,
           "wall_ms_per_round_median": float(np.median(walls)),
           "wall_ms_per_round_p90": float(np.percentile(walls, 90)),
           "answered_vehicle_solves_per_s": requests / total_s,
           "dispatched_vehicle_solves_per_s": n * len(dispatches) / total_s,
           "host_driven_vehicle_solves_per_s_perf_md": 20397,
           "final_goal_err_max": float(err.max()),
           "final_goal_err_median": float(np.median(err))}
    emit("serve_fleet", card=smi, **out)
    if not (not errors and rows_equal and answered == requests
            and counts["pm_fused_solve"] == len(dispatches)
            and counts["pm_merge"] == len(dispatches)
            and len(dispatches) < requests):
        raise AssertionError(f"coalesced fleet: {out}")
    return out


def native_golden_phase(pm, fused, z_big) -> dict:
    """The headline kernel solve (pm_fused_solve + pm_merge) on the
    injected z_big and check_solve's inputs against the native f64 core
    (``native/core.py``: pm_rollout + update at f64 on the same normals,
    eps = upsilon sigma z as [K, H, 3], the f64 model's A and B / mass),
    and the plain f32 path (fused_solve_plain + merge_plain on the card)
    against the same reference. Distances: max |wnoise - f64| / max |f64
    wnoise| (action units), and each cost stat's relative error. Gate: the
    kernel's at most NATIVE_SHARE times the plain path's (a stat: or
    within NATIVE_STAT_FLOOR)."""
    from mppi_tf_tpu_torch.models import get_model
    from mppi_tf_tpu_torch.native import core as native

    k, tau = fused.k, fused.tau
    rng = np.random.default_rng(7)          # check_solve's inputs
    x0 = torch.zeros(6, device="cuda")
    useq = torch.as_tensor(0.1 * rng.standard_normal((tau, 3)),
                           dtype=torch.float32, device="cuda")
    dyn = fused.pack_dyn(x0, useq)
    t0 = time.perf_counter()
    zs_k, st_k = pm.pm_merge(pm.pm_fused_solve(fused.consts, dyn, k, tau,
                                               z=z_big))
    zs_p, st_p = pm.merge_plain(pm.fused_solve_plain(fused.consts, dyn, k,
                                                     tau, z=z_big))
    wn = {"kernel": (fused.unfold_wnoise(zs_k) / st_k[1]).double(),
          "plain": (fused.unfold_wnoise(zs_p) / st_p[1]).double()}
    stats = {"kernel": st_k, "plain": st_p}
    model64 = get_model({"type": "point_mass", "mass": MASS}, dt=DT,
                        state_dim=6, action_dim=3, dtype=torch.float64)
    z64 = z_big.double().cpu().numpy()                     # [H, 3, K]
    eps = np.ascontiguousarray(np.einsum("ij,tjk->ktj", UPSILON * SIGMA,
                                         z64))
    args = (model64.A.detach().numpy(),
            model64.B.detach().numpy() / MASS, np.zeros(6),
            useq.double().cpu().numpy(), eps, np.diag(Q), np.asarray(GOAL),
            np.linalg.inv(SIGMA))
    costs = native.pm_rollout(*args, lam=LAM, gamma=GAMMA, upsilon=UPSILON)
    wn_ref, st_ref = native.update(costs, eps, LAM)
    native_s = time.perf_counter() - t0
    ref_stats = {"cost_min": st_ref["beta"], "cost_max": st_ref["cost_max"],
                 "cost_mean": st_ref["cost_mean"]}
    scale = float(np.abs(wn_ref).max())
    dist = {}
    for side in ("kernel", "plain"):
        st = stats[side].double().cpu().numpy()
        got = {"cost_min": st[2], "cost_max": st[3], "cost_mean": st[4] / k}
        dist[side] = {
            "wnoise": float(np.abs(wn[side].cpu().numpy() - wn_ref).max())
            / scale,
            **{name: abs(got[name] - v) / abs(v)
               for name, v in ref_stats.items()}}
    ok = {name: bool(dist["kernel"][name]
                     <= NATIVE_SHARE * dist["plain"][name]
                     or (name != "wnoise"
                         and dist["kernel"][name] <= NATIVE_STAT_FLOOR))
          for name in dist["kernel"]}
    out = {"K": k, "H": tau, "distance": dist, "ok": ok,
           "share": NATIVE_SHARE, "stat_floor": NATIVE_STAT_FLOOR,
           "max_abs_wnoise_f64": scale, "f64_cost_stats": ref_stats,
           "native_library": native.library_path().name,
           "seconds": native_s}
    emit("native_golden", **out)
    if not all(ok.values()):
        raise AssertionError(f"kernel farther from the f64 core than "
                             f"{NATIVE_SHARE} x the plain path: {out}")
    return out


def roofline_phase(_build, pm, fused, dyn, smi: str) -> dict:
    """The card's ceilings from the microbenchmarks of csrc/roofline.cu
    (``roofline.measure_ceilings``) beside the datasheet peaks the kernel
    table's bounds use; a measured FMA or HBM rate above CEILING_SHARE of
    its peak fails (a broken microbenchmark). The headline solve's own
    device ms (``pm_fused_solve``, the work ``pm_work`` counts: no merge,
    no glue) classified against them, beside its datasheet ``bound_ms``
    (the bound that governs), and the f32 operations a normal costs at
    the measured pair rate (against OPS_PER_NORMAL)."""
    from mppi_tf_tpu_torch import roofline

    t0 = time.perf_counter()
    ceil = roofline.measure_ceilings()
    seconds = time.perf_counter() - t0
    regs = [r for r in _build.ptxas_report() if "roofline" in r["kernel"]]
    k, tau, n_z = fused.k, fused.tau, fused.tau * fused.adim
    solve_ms = device_ms(lambda: pm.pm_fused_solve(fused.consts, dyn, k, tau,
                                                   seed=1, solve=1))
    row = roofline.classify(roofline.pm_work(fused), ceil, solve_ms)
    datasheet_ms, _by = bound_ms(
        4.0 * dyn.numel() + 4.0 * -(-k // pm.BLOCK) * (pm.STATS + n_z),
        solve_ops(fused.consts, k, tau, prng=True))
    share = {"fma_of_peak": ceil["vpu_flops"] / PEAK_OPS,
             "hbm_of_peak": ceil["hbm_bytes_per_s"] / PEAK_BYTES}
    out = {"ceilings": ceil, "datasheet": {"f32_flops": PEAK_OPS,
                                           "hbm_bytes_per_s": PEAK_BYTES},
           **share, "share_gate": CEILING_SHARE, "seconds": seconds,
           "microbenchmark_ptxas": regs,
           "headline_solve_device_ms": solve_ms,
           "headline_classify": row, "pct_of_bound": row["pct_of_bound"],
           "headline_bound_ms": datasheet_ms,
           "pct_of_datasheet_bound": datasheet_ms / solve_ms,
           "ops_per_normal": OPS_PER_NORMAL,
           "ops_per_normal_at_pair_ceiling":
               PEAK_OPS / (2.0 * ceil["bm_pairs_per_s"])}
    emit("roofline", card=smi, **out)
    if not all(v <= CEILING_SHARE for v in share.values()):
        raise AssertionError(f"a measured ceiling above {CEILING_SHARE} x "
                             f"its peak: {share}")
    return out


def sweep_phase(pm, workdir: str) -> dict:
    """``sweep.main`` over lambda in {0.5, 1.0} on the bundled point-mass
    configs, SWEEP_STEPS each, on the card: two records with finite costs,
    each combo's controller on the kernels (its kernel_path, and one
    launch of pm_fused_solve and pm_merge a step)."""
    from mppi_tf_tpu_torch import sweep
    from mppi_tf_tpu_torch.envs import runner

    paths, run = [], runner.run_experiment

    def recorded(*a, **kw):
        result = run(*a, **kw)
        paths.append(result["controller"].kernel_path)
        return result

    out_path = os.path.join(workdir, "sweep_results.jsonl")
    runner.run_experiment = recorded
    pm.reset_launch_counts()
    try:
        rc = sweep.main(["--config", "envs/point_mass", "--task",
                         "tasks/static_cost", "--model",
                         "models/point_mass_model", "--set",
                         "lambda=0.5,1.0", "-s", str(SWEEP_STEPS), "--out",
                         out_path])
    finally:
        runner.run_experiment = run
    counts = dict(pm.launch_counts)
    with open(out_path) as f:
        records = [json.loads(line) for line in f]
    finite = all(np.isfinite([r["final_cost"], r["mean_cost"]]).all()
                 for r in records)
    out = {"rc": rc, "records": records, "kernel_paths": paths,
           "launches": counts}
    emit("sweep", **out)
    if not (rc == 0 and len(records) == 2 and finite
            and paths == ["cuda", "cuda"]
            and counts["pm_fused_solve"] == 2 * SWEEP_STEPS
            and counts["pm_merge"] == 2 * SWEEP_STEPS):
        raise AssertionError(f"sweep: {out}")
    return out


def library_randn(shapes: dict) -> dict:
    """The PyTorch call that computes the noise dump's function, a fill of
    [H, adim, K] with standard normals (another stream, the same job),
    timed as the kernels are (kernel_time): {row: ms, device ms}."""
    out = {}
    for row, (shape, dtype) in shapes.items():
        t = kernel_time(lambda: torch.randn(shape, dtype=dtype,
                                            device="cuda"),
                        lambda: None, reps=200)
        out[row] = {"ms": t["ms"], "device_ms": t["device_ms"],
                    "shape": list(shape), "dtype": str(dtype)}
    return out


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout of the parent commit: build "
                    "its library too and hold this tree's kernels against it "
                    "(parent_bits, parent_times, the parent's sass counts)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    parent_build = build_parent(args.parent) if args.parent else None
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
    reg_rows = registers_vs_base(ptxas)
    moved = [r for r in reg_rows
             if r["base"] is not None and r["registers"] != r["base"]]
    f32 = sum(r["base"] is not None for r in reg_rows)
    emit("registers_vs_base", rows=reg_rows, f32_instantiations=f32,
         f32_moved=moved,
         bf16_instantiations=sum("_bf16_" in r["kernel"] for r in reg_rows),
         bf16_products_instantiations=sum("_bfp_" in r["kernel"]
                                          for r in reg_rows))
    parent_lib = parent_path = None
    if parent_build is not None:
        parent_lib, parent_path = load_parent(parent_build, _build)
    sass_phase(_build, parent_path)
    occupancy_phase(_build.load_library(), reg_rows,
                    torch.cuda.get_device_properties(0).multi_processor_count)
    spills = [r["kernel"] for r in ptxas
              if r.get("spill_stores") or r.get("spill_loads")]
    if spills:
        raise AssertionError(f"kernels spill registers: {spills}")
    if f32 != len(BASE_REGISTERS):
        raise AssertionError(f"{f32} of {len(BASE_REGISTERS)} f32 "
                             f"instantiations built")
    # the point mass's f32 body: (fused, costs) x four (dims, cost) x
    # (integrator, dense, dense with dynamic (A, B))
    pm_f32 = sum(r["kernel"] == "pm_fused_solve_kernel" for r in reg_rows)
    if pm_f32 != 24:
        raise AssertionError(f"{pm_f32} of 24 f32 point-mass "
                             f"instantiations built")
    if parent_lib is not None:
        parent_phase(_build, parent_lib, pm, auv, nnk, smi)
        parent_loops(_build, parent_lib, smi)

    # ---- 3. kernels against plain versions on injected z --------------------
    model, cost = workload("cuda")
    fused = pm.FusedPointMassMPPI(model, cost, k=K, tau=H, lam=LAM,
                                  upsilon=UPSILON, sigma=SIGMA)
    rng = np.random.default_rng(0)
    z_big = torch.as_tensor(rng.standard_normal((H, 3, K), np.float32),
                            device="cuda")
    main_chk = check_solve(pm, fused, z_big, "K100000_H50")
    # the same solve against the native f64 golden model (item 15)
    native_golden_phase(pm, fused, z_big)
    small = pm.FusedPointMassMPPI(model, cost, k=700, tau=7, lam=LAM,
                                  upsilon=UPSILON, sigma=SIGMA)
    z_small = torch.as_tensor(rng.standard_normal((7, 3, 700), np.float32),
                              device="cuda")
    check_solve(pm, small, z_small, "K700_H7_ragged")
    # the dense instantiations at the same shapes: the dense-constant point
    # mass (full sigma and Q); the workload itself runs the integrator
    dense_model, dense_cost = workload("cuda", dense=True)
    pm_dense = pm.FusedPointMassMPPI(dense_model, dense_cost, k=K, tau=H,
                                     lam=LAM, upsilon=UPSILON,
                                     sigma=PM_DENSE_SIGMA)
    if (fused.consts.structure, pm_dense.consts.structure) != (
            "integrator", "dense"):
        raise AssertionError(f"point-mass structures: workload "
                             f"{fused.consts.structure}, dense-constant "
                             f"{pm_dense.consts.structure}")
    dense_pm_chk = check_solve(pm, pm_dense, z_big, "dense_K100000_H50")

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
    prof_main = profile_steps(ctrl)
    emit("profile", kernel_path=ctrl.kernel_path, card=smi, **prof_main)
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

    # ---- 7b. the dense-constant point mass's loops (the dense kernels) -------
    pm_dense_loops = {}
    for normalize in (False, True):
        ctrl_dp, err_dp, ms_dp, counts_dp = closed_loop(
            "auto", normalize, steps=DENSE_STEPS, dense=True)
        want = {n: 0 for n in counts_dp}
        want.update({"pm_fused_costs": DENSE_STEPS,
                     "mppi_weights": DENSE_STEPS,
                     "pm_merge": 2 * DENSE_STEPS} if normalize else
                    {"pm_fused_solve": DENSE_STEPS,
                     "pm_merge": DENSE_STEPS})
        emit("pm_dense_closed_loop", normalize=normalize,
             kernel_path=ctrl_dp.kernel_path,
             structure=ctrl_dp._fused.consts.structure, K=K, H=H,
             steps=DENSE_STEPS, goal_err=err_dp, launches=counts_dp,
             step_ms_median=float(np.median(ms_dp)))
        if not (counts_dp == want and np.isfinite(err_dp)):
            raise AssertionError(f"dense point-mass loop (normalize="
                                 f"{normalize}): {counts_dp}, err {err_dp}")
        pm_dense_loops[normalize] = counts_dp
        del ctrl_dp

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
    dense_dyn = pm_dense.pack_dyn(x0, torch.zeros(H, 3, device="cuda"))
    ok_dc, err_dc, ratio_dc = close(
        pm.pm_fused_costs(pm_dense.consts, dense_dyn, K, H, z=z_big)[0],
        pm.fused_costs_plain(pm_dense.consts, dense_dyn, K, H, z=z_big)[0],
        PM_COST_RTOL, PM_COST_ATOL)
    emit("pm_costs_vs_plain_dense", k=K, tau=H, ok=ok_dc,
         max_abs_err=err_dc, ratio=ratio_dc, rtol=PM_COST_RTOL,
         atol=PM_COST_ATOL)
    if not ok_dc:
        raise AssertionError(f"dense pm_fused_costs disagrees: {err_dc}")
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
    # the kDense instantiations: the dense-constant vehicle
    dense_flag = auv_fused(AUV_K, AUV_H, dense=True)
    if (flag.consts.structure, dense_flag.consts.structure) != (
            "diagonal", "dense"):
        raise AssertionError("AUV structures: flagship "
                             f"{flag.consts.structure}, dense vehicle "
                             f"{dense_flag.consts.structure}")
    dense_chk = check_auv(auv_k, pm, dense_flag, z_auv,
                          "dense_K262144_H25_rk2", useq_scale=200.0)
    del z_auv
    x_dive = rest_state()
    x_dive[2] = -1.0
    rng_b = np.random.default_rng(2)   # a second draw of z for each rk
    rng_d = np.random.default_rng(5)   # the dense vehicle's draws
    small_sigma = np.diag([40.0] * 3 + [5.0] * 3)
    for rk in (1, 2, 4):
        sm = auv_fused(700, 7, rk=rk, sigma=small_sigma)
        for draw, r in (("a", rng), ("b", rng_b)):
            z_s = torch.as_tensor(r.standard_normal((7, 6, 700), np.float32),
                                  device="cuda")
            check_auv(auv_k, pm, sm, z_s, f"K700_H7_rk{rk}_ragged_{draw}",
                      useq_scale=5.0, x0=x_dive, end_to_end=True)
        z_s = torch.as_tensor(rng_d.standard_normal((7, 6, 700), np.float32),
                              device="cuda")
        for cost_kind in ("static_quat", "waypoints_quat", "elipse3d"):
            sm = auv_fused(700, 7, rk=rk, sigma=small_sigma, kind=cost_kind,
                           dense=True)
            check_auv(auv_k, pm, sm, z_s,
                      f"dense_{cost_kind}_K700_H7_rk{rk}", useq_scale=5.0,
                      x0=([4.0, 0, -3.0, 0, 0, 0, 1.0] + [0.0] * 6
                          if cost_kind == "elipse3d" else x_dive))
        # the kDense solve end to end, on a softmax that is not degenerate,
        # and both structures' fused costs and exponents against the costs
        # mode's, bit for bit
        for lam in DENSE_E2E_LAMS:
            tag = "" if lam == DENSE_E2E_LAMS[0] else f"lam{lam:g}_"
            sm = auv_fused(700, 7, rk=rk, sigma=DENSE_E2E_SIGMA, dense=True,
                           lam=lam)
            e2e = check_auv(auv_k, pm, sm, z_s,
                            f"dense_e2e_{tag}K700_H7_rk{rk}", useq_scale=5.0,
                            x0=x_dive, end_to_end=True)
            if not e2e["ess"] >= DENSE_E2E_MIN_ESS:
                raise AssertionError(f"dense end-to-end case rk{rk} lambda "
                                     f"{lam}: ESS {e2e['ess']} < "
                                     f"{DENSE_E2E_MIN_ESS}")
            for dense in (True, False):
                f = sm if dense else auv_fused(
                    700, 7, rk=rk, sigma=DENSE_E2E_SIGMA, lam=lam)
                mode_bits(auv, f, auv_dyn(f, 5.0, seed=11, x0=x_dive), z_s,
                          f"{f.consts.structure}_{tag}K700_H7_rk{rk}")

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
    if (ctrl_a.kernel_path, ctrl_a._fused.consts.structure) != (
            "cuda", "diagonal"):
        raise AssertionError(f"AUV kernel='auto' resolved to "
                             f"{ctrl_a.kernel_path}, "
                             f"{ctrl_a._fused.consts.structure}")
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
            and ctrl_u._fused.consts.structure == "diagonal"
            and unnorm_counts["auv_fused_solve"] == AUV_PLAIN_STEPS
            and unnorm_counts["pm_merge"] == AUV_PLAIN_STEPS
            and np.all(np.isfinite(states_u))
            and states_u[-1, 2] < states_u[0, 2]):
        raise AssertionError(f"unnormalized AUV path: {ctrl_u.kernel_path}, "
                             f"{unnorm_counts}, z {states_u[:, 2]}")
    emit("profile", kernel_path="cuda", model="auv", normalize=False,
         card=smi, **profile_steps(ctrl_u, x=rest_state()))
    del ctrl_u

    # ---- 12b. the dense-constant vehicle's loops (the kDense kernels) -------
    dense_loops = {}
    for normalize in (False, True):
        ctrl_d, states_d, ms_d, counts_d = auv_loop(
            "auto", normalize, DENSE_STEPS, dense=True)
        drift = float(np.abs(np.linalg.norm(states_d[:, 3:7], axis=1)
                             - 1.0).max())
        want = {n: 0 for n in counts_d}
        want.update({"auv_fused_costs": DENSE_STEPS,
                     "mppi_weights": DENSE_STEPS,
                     "pm_merge": 2 * DENSE_STEPS} if normalize else
                    {"auv_fused_solve": DENSE_STEPS,
                     "pm_merge": DENSE_STEPS})
        emit("auv_dense_closed_loop", normalize=normalize,
             kernel_path=ctrl_d.kernel_path,
             structure=ctrl_d._fused.consts.structure, K=AUV_K, H=AUV_H,
             steps=DENSE_STEPS, z_every_5=states_d[::5, 2].tolist(),
             q_drift=drift, launches=counts_d,
             step_ms_median=float(np.median(ms_d)))
        if not (ctrl_d.kernel_path == "cuda"
                and ctrl_d._fused.consts.structure == "dense"
                and counts_d == want and np.all(np.isfinite(states_d))
                and drift < 1e-3):
            raise AssertionError(f"dense AUV loop (normalize={normalize}): "
                                 f"{counts_d}, drift {drift}")
        dense_loops[normalize] = counts_d
        del ctrl_d

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
    wq_model, wq_cost, _, _ = auv_modules(
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
    check_pm_structure(ctrl_w, "integrator", "point-mass mission")
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

    # ---- 27. the bf16 block compute: kernels against plain bf16, the ------
    # ---- bf16 noise, the bf16 loops ---------------------------------------
    z_bf = torch.as_tensor(np.random.default_rng(12).standard_normal(
        (H, 3, K), np.float32), device="cuda")
    bf16 = bf16_kernels_phase(pm, auv, nnk, model, cost, z_bf)
    del z_bf
    bf16_noise = bf16_noise_phase(pm)
    bf16_loops = bf16_loops_phase(pm, smi)

    # ---- 27b. the model-based RL loop: collect, learn, the NN kernels on --
    # ---- learned weights, the dives with refits, the analytic learner ------
    with tempfile.TemporaryDirectory() as workdir:
        mbrl = mbrl_phase(pm, nnk, nn_k, smi, workdir)
    mbrl_launches = {
        name: sum(d["launches"].get(name, 0) for d in mbrl["dives"])
        for name in ("nn_fused_solve", "nn_fused_costs", "mppi_weights",
                     "pm_merge")}
    mbrl_launches["pm_fused_solve"] = mbrl["point_mass"]["launches"][
        "pm_fused_solve"]

    # ---- 27c. the on-device loop: the bench's three rows as replayed ------
    # ---- CUDA graphs, each beside its host-driven loop ----------------------
    on_device = on_device_phase(pm, smi)

    # ---- 27d. the fleet: the bench's two fleet rows, one launch of each ----
    # ---- kernel over all vehicles, host-driven and on the device ------------
    fleet = fleet_phase(pm, smi)

    # ---- 27e. multi-GPU and sharding: the headline, the dive, adaptive ----
    # ---- DMD and the on-device row over a local mesh, ranks on the card, --
    # ---- a one-rank NCCL group, the dp x tp step, the fleet mesh ---------
    sharded = sharded_phase(pm, smi, on_device)

    # ---- 27f. serving and tooling: the served headline loop and m-step ----
    # ---- replies, the coalesced fleet, the card's ceilings and the --------
    # ---- headline's roofline share, a sweep (native_golden: section 3) ----
    serve = serve_phase(pm, smi)
    serve_fleet = serve_fleet_phase(pm, smi)
    roofline_phase(_build, pm, fused, dyn, smi)
    with tempfile.TemporaryDirectory() as workdir:
        sweep_phase(pm, workdir)
    # each kernel row's launches in the on-device runs (the profiler's
    # count by kernel name) and its largest error against the plain
    # version at those runs' shapes, from the rows that launch it
    od_rows_of = {
        "pm_fused_solve": (("on_device_loop", "pm_fused_solve"),),
        "pm_fused_solve[dynamic_ab]": (("on_device_adaptive_dmd",
                                        "pm_fused_solve"),),
        "pm_merge": tuple((r, "pm_merge") for r in on_device),
        "auv_fused_costs[waypoints_quat]": (("on_device_auv_mission",
                                             "auv_fused_costs"),),
        "mppi_weights": (("on_device_auv_mission", "mppi_weights"),)}
    od_launches = {
        row: (sum(on_device[r]["launches_profiled"][n] for r, n in of),
              max(on_device[r]["max_abs_err_vs_plain"][n] for r, n in of))
        for row, of in od_rows_of.items()}

    # ---- 28. times -------------------------------------------------------------
    consts, nb = fused.consts, -(-K // pm.BLOCK)
    n_z = H * 3
    part = pm.pm_fused_solve(consts, dyn, K, H, seed=1, solve=1)
    t_pair = cuda_ms(lambda: pm.pm_merge(pm.pm_fused_solve(
        consts, dyn, K, H, seed=1, solve=1)), 200)
    t_solve = cuda_ms(lambda: pm.pm_fused_solve(consts, dyn, K, H, seed=1,
                                                solve=1), 200)
    t_merge = cuda_ms(lambda: pm.pm_merge(part), 200)
    d_merge = device_ms(lambda: pm.pm_merge(part))
    stream = torch.cuda.current_stream().cuda_stream
    d_empty = device_ms(lambda: _build.load_library().pm_empty(stream))
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
    pm_c, pm_srows = pm.pm_fused_costs(consts, dyn, K, H, seed=1, solve=1)
    pm_nrm = torch.stack([pm_c.min(), 1.0 / ((pm_c.max() - pm_c.min())
                                             * LAM)])
    t_pmc = cuda_ms(lambda: pm.pm_fused_costs(consts, dyn, K, H, seed=1,
                                              solve=1), 200)
    t_w3 = cuda_ms(lambda: pm.mppi_weights(pm_nrm, pm_c, H, 3, seed=1,
                                           solve=1), 200)
    d_w3 = device_ms(lambda: pm.mppi_weights(pm_nrm, pm_c, H, 3, seed=1,
                                             solve=1))
    p_pmc = cuda_ms(lambda: pm.fused_costs_plain(consts, dyn, K, H, seed=1,
                                                 solve=1), 5, 1)
    p_w3 = cuda_ms(lambda: pm.weights_plain(pm_nrm, pm_c, H, 3, seed=1,
                                            solve=1), 5, 1)
    rows_b = 4.0 * nb * pm.STATS
    b_pmc = bound_ms(4.0 * dyn.numel() + 4.0 * K + rows_b,
                     solve_ops(consts, K, H, prng=True, costs_only=True))
    b_w3 = bound_ms(4.0 * K + 8.0 + part_bytes, weights_ops(K, n_z, True))
    # the stats-only merge after phase A (pm_merge_stats_kernel), against
    # an f64 merge of the same rows (merge_gate)
    zs_s, st_s = pm.pm_merge(pm_srows)
    g_stats = merge_gate(pm, pm_srows, zs_s, st_s)
    if not g_stats["ok"]:
        raise AssertionError(f"stats-only pm_merge: {g_stats}")
    err_stats = (st_s[:5].double() - pm.merge_plain(
        pm_srows.double())[1][:5]).abs().max().item()
    t_stats = cuda_ms(lambda: pm.pm_merge(pm_srows), 200)
    d_stats = device_ms(lambda: pm.pm_merge(pm_srows))
    p_stats = cuda_ms(lambda: pm.merge_plain(pm_srows), 50)
    b_stats = bound_ms(rows_b + 4.0 * pm.STATS, nb * 6.0)
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
    d_w6 = device_ms(lambda: pm.mppi_weights(a_nrm, a_c, AUV_H, 6, seed=1,
                                             solve=1))
    d_amerge = device_ms(lambda: pm.pm_merge(a_wrows))
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
    # the kDense kernels on the dense-constant vehicle at the same shapes
    dd, dyn_d = dense_flag.consts, auv_dyn(dense_flag, 200.0, seed=5)
    dense_t = {
        "solve": dict(kernel_time(
            lambda: auv.auv_fused_solve(dd, dyn_d, AUV_K, AUV_H, seed=1,
                                        solve=1),
            lambda: auv.fused_solve_plain(dd, dyn_d, AUV_K, AUV_H, seed=1,
                                          solve=1)),
            bound=bound_ms(4.0 * dyn_d.numel() + a_part_bytes,
                           auv_solve_ops(dd, dyn_d, AUV_K, AUV_H,
                                         prng=True))),
        "costs": dict(kernel_time(
            lambda: auv.auv_fused_costs(dd, dyn_d, AUV_K, AUV_H, seed=1,
                                        solve=1),
            lambda: auv.fused_costs_plain(dd, dyn_d, AUV_K, AUV_H, seed=1,
                                          solve=1)),
            bound=bound_ms(4.0 * dyn_d.numel() + 4.0 * AUV_K
                           + 4.0 * a_nb * pm.STATS,
                           auv_solve_ops(dd, dyn_d, AUV_K, AUV_H, prng=True,
                                         costs_only=True)))}

    # the dense kernels on the dense-constant point mass at the same shapes
    pd, dyn_pd = pm_dense.consts, pm_dense.pack_dyn(x0, useq)
    pm_dense_t = {
        "solve": dict(kernel_time(
            lambda: pm.pm_fused_solve(pd, dyn_pd, K, H, seed=1, solve=1),
            lambda: pm.fused_solve_plain(pd, dyn_pd, K, H, seed=1,
                                         solve=1)),
            bound=bound_ms(4.0 * dyn_pd.numel() + part_bytes,
                           solve_ops(pd, K, H, prng=True))),
        "costs": dict(kernel_time(
            lambda: pm.pm_fused_costs(pd, dyn_pd, K, H, seed=1, solve=1),
            lambda: pm.fused_costs_plain(pd, dyn_pd, K, H, seed=1,
                                         solve=1)),
            bound=bound_ms(4.0 * dyn_pd.numel() + 4.0 * K + rows_b,
                           solve_ops(pd, K, H, prng=True,
                                     costs_only=True)))}

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
    d_nw6 = device_ms(lambda: pm.mppi_weights(n_nrm, n_c, NN_H, 6, seed=1,
                                              solve=1))
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
    # the bounds of the tensor-core form the kernels compute (nn_tc_bound)
    tc_nsolve = nn_tc_bound(nc, 4.0 * dyn_n.numel() + n_part_bytes, NN_K,
                            NN_H, prng=True)
    tc_ncosts = nn_tc_bound(nc, 4.0 * dyn_n.numel() + 4.0 * NN_K
                            + 4.0 * n_nb * pm.STATS, NN_K, NN_H, prng=True,
                            costs_only=True)
    # a reading never called by the port: the MLP's four products over the
    # K*H rows of a horizon as torch.matmul (cuBLAS, f32, no TF32), the
    # work the torch route does a step beside its elementwise ops
    layers = [(layer.w.detach(), layer.b.detach())
              for layer in nn_flag.model.net]
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
         empty_kernel_device_ms=d_empty, weights_adim3_device_ms=d_w3,
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
              "weights_adim6_device_ms": d_w6,
              "merge_weights_rows_device_ms": d_amerge,
              "plain_solve_ms": p_asolve, "plain_costs_ms": p_acosts,
              "plain_weights_adim6_ms": p_w6,
              "bound_solve": b_asolve, "bound_costs": b_acosts,
              "bound_weights": b_w6, "structure": ac.structure,
              "dense_vehicle": dense_t,
              "dive_mppi_next_ms_median": float(np.median(step_ms_a)),
              "unnormalized_mppi_next_ms_median": float(
                  np.median(step_ms_u))},
         nn={"K": NN_K, "H": NN_H, "sizes": list(nc.sizes),
             "solve_ms": t_nsolve, "costs_ms": t_ncosts,
             "weights_adim6_ms": t_nw6, "weights_adim6_device_ms": d_nw6,
             "plain_solve_ms": p_nsolve,
             "plain_costs_ms": p_ncosts, "plain_weights_adim6_ms": p_nw6,
             "bound_solve": b_nsolve, "bound_costs": b_ncosts,
             "tc_bound_solve": tc_nsolve, "tc_bound_costs": tc_ncosts,
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
        if key == "nn":
            vt["nn_fused_solve[sched, antithetic]"]["tc_bound"] = nn_tc_bound(
                vc, 4.0 * dyn_v.numel() + 4.0 * nb_ * (pm.STATS + nz_), k_,
                h_, prng=True, extra=extra)
            vt["nn_fused_costs[sched, antithetic]"]["tc_bound"] = nn_tc_bound(
                vc, 4.0 * dyn_v.numel() + 4.0 * k_ + 4.0 * nb_ * pm.STATS,
                k_, h_, prng=True, costs_only=True, extra=extra)
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
    # the bf16 builds beside their f32 builds on the same inputs; bounds
    # count the rollout's bf16 ops at PEAK_OPS_BF16, the rest at PEAK_OPS
    bo = bf16["objs"]
    for key, kmod, pre, k_, h_ in (("pm", pm, "pm", K, H),
                                   ("dynamic_ab", pm, "pm", K, H),
                                   ("auv_rk2", auv, "auv", AUV_K, AUV_H),
                                   ("nn", nnk, "nn", NN_K, NN_H),
                                   ("nn_bf16_products", nnk, "nn", NN_K,
                                    NN_H)):
        f32o, b16o, dyn_o = bo[key]
        dyn_32 = bo["nn"][2] if key == "nn_bf16_products" else dyn_o
        solve_k = getattr(kmod, f"{pre}_fused_solve")
        costs_k = getattr(kmod, f"{pre}_fused_costs")
        ops_fn = {"pm": lambda c, **kw: solve_ops(c, K, H, prng=True, **kw),
                  "auv": lambda c, **kw: auv_solve_ops(c, dyn_o, k_, h_,
                                                       prng=True, **kw),
                  "nn": lambda c, **kw: nn_solve_ops(c, k_, h_, prng=True,
                                                     **kw)}[pre]
        b16c, f32c = b16o.consts, f32o.consts
        nz_, nb_ = h_ * b16o.adim, -(-k_ // pm.BLOCK)
        ops16 = (0.0 if key == "nn_bf16_products"
                 else bf16_rollout_ops(b16c, k_, h_, dyn_o))
        tag = {"nn_bf16_products": "bf16 products",
               "dynamic_ab": "dynamic_ab, bf16"}.get(key, "bf16")
        vt[f"{pre}_fused_solve[{tag}]"] = dict(variant_times(
            lambda: solve_k(f32c, dyn_32, k_, h_, seed=1, solve=1),
            lambda: solve_k(b16c, dyn_o, k_, h_, seed=1, solve=1),
            lambda: kmod.fused_solve_plain(b16c, dyn_o, k_, h_, seed=1,
                                           solve=1)),
            bound=bf16_bound(4.0 * dyn_o.numel()
                             + 4.0 * nb_ * (pm.STATS + nz_),
                             ops_fn(b16c), ops16))
        vt[f"{pre}_fused_costs[{tag}]"] = dict(variant_times(
            lambda: costs_k(f32c, dyn_32, k_, h_, seed=1, solve=1),
            lambda: costs_k(b16c, dyn_o, k_, h_, seed=1, solve=1),
            lambda: kmod.fused_costs_plain(b16c, dyn_o, k_, h_, seed=1,
                                           solve=1)),
            bound=bf16_bound(4.0 * dyn_o.numel() + 4.0 * k_
                             + 4.0 * nb_ * pm.STATS,
                             ops_fn(b16c, costs_only=True), ops16))
        if key == "nn_bf16_products":
            vt[f"nn_fused_solve[{tag}]"]["tc_bound"] = nn_tc_bound(
                b16c, 4.0 * dyn_o.numel() + 4.0 * nb_ * (pm.STATS + nz_),
                k_, h_, prng=True)
            vt[f"nn_fused_costs[{tag}]"]["tc_bound"] = nn_tc_bound(
                b16c, 4.0 * dyn_o.numel() + 4.0 * k_ + 4.0 * nb_ * pm.STATS,
                k_, h_, prng=True, costs_only=True)
    bf = "bfloat16"
    vt["pm_noise_dump[bf16]"] = dict(variant_times(
        lambda: pm.pm_noise_dump(1, 1, K, H, 3, "cuda"),
        lambda: pm.pm_noise_dump(1, 1, K, H, 3, "cuda", compute_dtype=bf),
        lambda: pm.round_bf16(pm.noise_plain(1, 1, K, H, 3, device="cuda"))),
        bound=b_dump)
    vt["mppi_weights[bf16]"] = dict(variant_times(
        lambda: pm.mppi_weights(pm_nrm, pm_c, H, 3, seed=1, solve=1),
        lambda: pm.mppi_weights(pm_nrm, pm_c, H, 3, seed=1, solve=1,
                                compute_dtype=bf),
        lambda: pm.weights_plain(pm_nrm, pm_c, H, 3, seed=1, solve=1,
                                 compute_dtype=bf)), bound=b_w3)
    vt["mppi_weights[bf16, adim 6]"] = dict(variant_times(
        lambda: pm.mppi_weights(a_nrm, a_c, AUV_H, 6, seed=1, solve=1),
        lambda: pm.mppi_weights(a_nrm, a_c, AUV_H, 6, seed=1, solve=1,
                                compute_dtype=bf),
        lambda: pm.weights_plain(a_nrm, a_c, AUV_H, 6, seed=1, solve=1,
                                 compute_dtype=bf)), bound=b_w6)
    vt["bf16_mppi_next_ms_median"] = {
        f"{name}_{'normalized' if n else 'unnormalized'}": float(
            np.median(ms)) for (name, n), (ms, _) in bf16_loops.items()}
    emit("variant_times", card=smi, **vt,
         note="ms: the variant; unvaried_ms: the same kernel without the "
              "schedule or antithetic at the same shapes and inputs, for "
              "dynamic_ab with the constant (A, B) of the same map, for "
              "bf16 its f32 build (bf16 products: the f32-products kernel "
              "on the same weights; dynamic_ab, bf16: the f32 dynamic_ab "
              "build), timed in turns (unvaried, variant, "
              "variant, unvaried); point mass sched at K=100000, H=100, "
              "antithetic, dynamic_ab and bf16 at H=50; AUV rk2 K=262144, "
              "H=25; NN 3x32 K=65536, H=25")

    src = "mppi_tf_tpu_torch/csrc/pm_mppi.cu"
    asrc = "mppi_tf_tpu_torch/csrc/auv_mppi.cu"
    kernels = [
        {"name": "pm_fused_solve", "route": "cuda", "source": src,
         "replaces": "mppi_tf_tpu/kernels/pm_mppi.py:1000",
         "structure": consts.structure,
         "launches": main_counts["pm_fused_solve"],
         "launches_mbrl": mbrl_launches["pm_fused_solve"],
         "max_abs_err": main_chk["solve_only_max_abs_err"],
         "ms": t_solve, "plain_ms": p_solve, "bound_ms": b_solve[0],
         "bound_by": b_solve[1], "library_ms": None},
        {"name": "pm_merge", "route": "cuda", "source": src,
         "replaces": "mppi_tf_tpu/kernels/pm_mppi.py:1000",
         "launches": main_counts["pm_merge"],
         "launches_mbrl": mbrl_launches["pm_merge"],
         "max_abs_err": main_chk["merge_only_max_abs_err"],
         "ms": t_merge, "device_ms": d_merge,
         "empty_kernel_device_ms": d_empty, "plain_ms": p_merge,
         "bound_ms": b_merge[0], "bound_by": b_merge[1], "library_ms": None,
         "redesigned": "column tiles, a cluster of row slices from 640 "
                       "rows"},
        {"name": "pm_merge[stats]", "route": "cuda", "source": src,
         "replaces": "mppi_tf_tpu/kernels/pm_mppi.py:1000",
         "kernel": "pm_merge_stats_kernel",
         "launches": pm_norm_counts["pm_fused_costs"],
         "launches_of": "pm_merge on stats-only rows, one after each "
                        "phase A (pm_fused_costs) of the point-mass "
                        "normalized closed loop",
         "max_abs_err": err_stats,
         "max_abs_err_of": "m, l, cost min, max, sum against an f64 merge "
                           "of the same rows, K=100000",
         "rel_l1": g_stats["rel_l1"],
         "ms": t_stats, "device_ms": d_stats,
         "empty_kernel_device_ms": d_empty, "plain_ms": p_stats,
         "bound_ms": b_stats[0], "bound_by": b_stats[1],
         "library_ms": None},
        {"name": "pm_noise_dump", "route": "cuda", "source": src,
         "replaces": "mppi_tf_tpu/kernels/pm_mppi.py:274",
         "launches": noise["launches"], "path": "noise statistics check",
         "max_abs_err": noise["max_abs_err"],
         "ms": t_dump, "plain_ms": p_dump, "bound_ms": b_dump[0],
         "bound_by": b_dump[1], "library_ms": None},
        {"name": "pm_fused_costs", "route": "cuda", "source": src,
         "replaces": "mppi_tf_tpu/kernels/pm_mppi.py:1073",
         "structure": consts.structure,
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
         "launches_mbrl": mbrl_launches["mppi_weights"],
         "max_abs_err": w6["wnoise_max_abs_err"],
         "max_abs_err_adim3": w3["wnoise_max_abs_err"],
         "ms": t_w6, "device_ms": d_w6, "plain_ms": p_w6,
         "bound_ms": b_w6[0], "bound_by": b_w6[1], "ms_adim3": t_w3,
         "device_ms_adim3": d_w3, "plain_ms_adim3": p_w3,
         "bound_ms_adim3": b_w3[0], "library_ms": None,
         "redesigned": "grouped regeneration, groups of Philox blocks "
                       "over blockIdx.y"},
        {"name": "auv_fused_solve", "route": "cuda", "source": asrc,
         "replaces": "mppi_tf_tpu/kernels/auv_mppi.py:804",
         "launches": unnorm_counts["auv_fused_solve"],
         "path": "AUV unnormalized closed loop", "structure": ac.structure,
         "max_abs_err": auv_chk["fused_cost_stats_max_abs_err"],
         "max_abs_err_of": "merged cost min, max, mean of the fused rows "
                           "against the plain costs, K=262144, H=25",
         "softmax_vs_own_costs_max_abs_err": auv_chk["fused_max_abs_err"],
         "ms": t_asolve, "plain_ms": p_asolve, "bound_ms": b_asolve[0],
         "bound_by": b_asolve[1], "library_ms": None},
        {"name": "auv_fused_costs", "route": "cuda", "source": asrc,
         "replaces": "mppi_tf_tpu/kernels/auv_mppi.py:872",
         "launches": dive_counts["auv_fused_costs"],
         "path": "AUV normalized closed loop", "structure": ac.structure,
         "max_abs_err": auv_chk["costs_max_abs_err"],
         "ms": t_acosts, "plain_ms": p_acosts, "bound_ms": b_acosts[0],
         "bound_by": b_acosts[1], "library_ms": None},
    ]
    for name, mode, err, err_of in (
            ("solve", False, dense_chk["fused_cost_stats_max_abs_err"],
             "merged cost min, max, mean of the fused rows against the "
             "plain costs, K=262144, H=25"),
            ("costs", True, dense_chk["costs_max_abs_err"],
             "per-sample costs against the plain version, K=262144, H=25")):
        t = dense_t[name]
        kernels.append({
            "name": f"auv_fused_{name}[dense]", "route": "cuda",
            "source": asrc, "replaces": "mppi_tf_tpu/kernels/auv_mppi.py:"
            + ("872" if mode else "804"), "structure": dd.structure,
            "launches": dense_loops[mode][f"auv_fused_{name}"],
            "path": f"dense-constant AUV loop, "
                    f"{'normalized' if mode else 'unnormalized'}",
            "max_abs_err": err, "max_abs_err_of": err_of, "ms": t["ms"],
            "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": None})
    for name, mode, err, err_of in (
            ("solve", False, dense_pm_chk["solve_only_max_abs_err"],
             "weighted noise of the solve's rows (plain merge) against the "
             "plain solve, K=100000, H=50"),
            ("costs", True, err_dc,
             "per-sample costs against the plain version, K=100000, H=50")):
        t = pm_dense_t[name]
        kernels.append({
            "name": f"pm_fused_{name}[dense]", "route": "cuda",
            "source": src, "replaces": "mppi_tf_tpu/kernels/pm_mppi.py:"
            + ("1073" if mode else "1000"), "structure": pd.structure,
            "launches": pm_dense_loops[mode][f"pm_fused_{name}"],
            "path": f"dense-constant point-mass loop, "
                    f"{'normalized' if mode else 'unnormalized'}",
            "max_abs_err": err, "max_abs_err_of": err_of, "ms": t["ms"],
            "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": None})
    nsrc = "mppi_tf_tpu_torch/csrc/nn_mppi.cu"
    kernels += [
        {"name": "nn_fused_solve", "route": "cuda", "source": nsrc,
         "replaces": "mppi_tf_tpu/kernels/nn_mppi.py:631",
         "launches": nn_unnorm_counts["nn_fused_solve"],
         "path": "NN known-plant closed loop, unnormalized",
         "launches_mbrl": mbrl_launches["nn_fused_solve"],
         "max_abs_err_mbrl": max(mbrl["kernels"][n][
             "fused_cost_stats_max_abs_err"] for n in (
                 "learned", "rewritten", "one_episode")),
         "max_abs_err": nn_chk["fused_cost_stats_max_abs_err"],
         "max_abs_err_of": "merged cost min, max, mean of the fused rows "
                           "against the plain costs, K=65536, H=25, 3x32",
         "softmax_vs_own_costs_max_abs_err": nn_chk["fused_max_abs_err"],
         "ms": t_nsolve, "plain_ms": p_nsolve, "bound_ms": b_nsolve[0],
         "bound_by": b_nsolve[1], "tc_bound_ms": tc_nsolve[0],
         "library_ms": None},
        {"name": "nn_fused_costs", "route": "cuda", "source": nsrc,
         "replaces": "mppi_tf_tpu/kernels/nn_mppi.py:647",
         "launches": nn_norm_counts["nn_fused_costs"],
         "path": "NN known-plant closed loop, normalized",
         "launches_mbrl": mbrl_launches["nn_fused_costs"],
         "max_abs_err_mbrl": max(mbrl["kernels"][n]["costs_max_abs_err"]
                                 for n in ("learned", "rewritten",
                                           "one_episode")),
         "max_abs_err": nn_chk["costs_max_abs_err"],
         "ms": t_ncosts, "plain_ms": p_ncosts, "bound_ms": b_ncosts[0],
         "bound_by": b_ncosts[1], "tc_bound_ms": tc_ncosts[0],
         "library_ms": None},
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
    bc = bf16["check"]

    def worst16(name, key):   # over injected z and the Philox stream
        return max(bc[name][s][key] for s in ("injected", "philox"))

    bl = bf16_loops
    c16 = ("per-sample costs against the plain bf16 version, injected z "
           "and Philox, K={}, H={}")
    w16 = ("weighted noise (z units) of the merged solve against the plain "
           "bf16 solve, injected z and Philox, K={}, H={}")
    nn_py = "mppi_tf_tpu/kernels/nn_mppi.py"
    variant_rows += (
        ("pm_fused_solve[bf16]", src, f"{pm_py}:1042",
         bl["pm", False][1]["pm_fused_solve_bf16"],
         "point_mass_bf16 closed loop, unnormalized",
         worst16("pm", "wnoise_e2e_max_abs_err"), w16.format(K, H)),
        ("pm_fused_costs[bf16]", src, f"{pm_py}:1111",
         bl["pm", True][1]["pm_fused_costs_bf16"],
         "point_mass_bf16 closed loop, normalized",
         worst16("pm", "costs_max_abs_err"), c16.format(K, H)),
        ("pm_fused_solve[dynamic_ab, bf16]", src, f"{pm_py}:1042",
         bl["dmd", False][1]["pm_fused_solve_bf16"],
         "bf16 DMDMPPI closed loop, unnormalized",
         worst16("dynamic_ab", "wnoise_e2e_max_abs_err"), w16.format(K, H)),
        ("pm_fused_costs[dynamic_ab, bf16]", src, f"{pm_py}:1111",
         bl["dmd", True][1]["pm_fused_costs_bf16"],
         "bf16 DMDMPPI closed loop, normalized",
         worst16("dynamic_ab", "costs_max_abs_err"), c16.format(K, H)),
        ("pm_noise_dump[bf16]", src, f"{pm_py}:289",
         bf16_noise["launches"], "bf16 noise check",
         0.0, "the bf16 dump against the f32 dump rounded to bf16, bit for "
              "bit, adim 3 and 6, K=100000, H=50"),
        ("mppi_weights[bf16]", src, f"{pm_py}:1169",
         bl["pm", True][1]["mppi_weights_bf16"],
         "point_mass_bf16 closed loop, normalized (adim 3)",
         bc["weights_adim3"]["wnoise_max_abs_err"],
         "weighted noise (z units) against the plain bf16 version, "
         "injected z and Philox, K=100000, H=50"),
        ("mppi_weights[bf16, adim 6]", src, f"{auv_py}:967",
         bl["auv", True][1]["mppi_weights_bf16"],
         "AUV dive at bf16 (adim 6)",
         bc["weights_adim6"]["wnoise_max_abs_err"],
         "weighted noise (z units) against the plain bf16 version, "
         "injected z and Philox, K=262144, H=25"),
        ("auv_fused_solve[bf16]", asrc, f"{auv_py}:841",
         bl["auv", False][1]["auv_fused_solve_bf16"],
         "AUV unnormalized loop at bf16",
         worst16("auv_rk2", "wnoise_e2e_max_abs_err"),
         w16.format(AUV_K, AUV_H)),
        ("auv_fused_costs[bf16]", asrc, f"{auv_py}:910",
         bl["auv", True][1]["auv_fused_costs_bf16"], "AUV dive at bf16",
         worst16("auv_rk2", "costs_max_abs_err"), c16.format(AUV_K, AUV_H)),
        ("nn_fused_solve[bf16]", nsrc, f"{nn_py}:615",
         bl["nn", False][1]["nn_fused_solve_bf16"],
         "NN known-plant dive at bf16, unnormalized",
         worst16("nn", "wnoise_e2e_max_abs_err"), w16.format(NN_K, NN_H)),
        ("nn_fused_costs[bf16]", nsrc, f"{nn_py}:615",
         bl["nn", True][1]["nn_fused_costs_bf16"],
         "NN known-plant dive at bf16, normalized",
         worst16("nn", "costs_max_abs_err"), c16.format(NN_K, NN_H)),
        ("nn_fused_solve[bf16 products]", nsrc, f"{nn_py}:615",
         bl["nn_bf16_products", False][1]["nn_fused_solve_bfp"],
         "NN known-plant dive with a bf16-compute model, unnormalized",
         worst16("nn_bf16_products", "wnoise_e2e_max_abs_err"),
         w16.format(NN_K, NN_H)),
        ("nn_fused_costs[bf16 products]", nsrc, f"{nn_py}:615",
         bl["nn_bf16_products", True][1]["nn_fused_costs_bfp"],
         "NN known-plant dive with a bf16-compute model, normalized",
         worst16("nn_bf16_products", "costs_max_abs_err"),
         c16.format(NN_K, NN_H)))
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
            **({"tc_bound_ms": t["tc_bound"][0]} if "tc_bound" in t
               else {}),
            "library_ms": None})
    # the fleet launches: one launch of each kernel over all vehicles of a
    # fleet step, its bound n times one vehicle's work
    fleet_rows = (
        ("pm_fused_solve[fleet]", src, f"{pm_py}:1042", ("point_mass",
                                                         False), "solve"),
        ("pm_fused_costs[fleet]", src, f"{pm_py}:1111", ("point_mass", True),
         "costs"),
        ("mppi_weights[fleet]", src, f"{pm_py}:1169", ("point_mass", True),
         "weights"),
        ("pm_merge[fleet]", src, "mppi_tf_tpu/parallel/fused.py:90",
         ("point_mass", False), "merge"),
        ("auv_fused_solve[fleet]", asrc, f"{auv_py}:841", ("auv", False),
         "solve"),
        ("auv_fused_costs[fleet]", asrc, f"{auv_py}:910", ("auv", True),
         "costs"),
        ("mppi_weights[fleet, adim 6]", src, f"{auv_py}:967",
         ("auv", True), "weights"))
    errs_of = {"solve": ("fused_wnoise", "the fused rows' zsum / l (z units) "
                         "against block_partials of the kernel's own costs"),
               "costs": ("costs", "per-sample costs against the plain "
                         "version"),
               "weights": ("weights", "phase B's zsum / l (z units) against "
                           "weights_plain on the kernel's costs"),
               "merge": ("merge", "zsum / l against merge_plain on the "
                         "plain rows")}
    for name, source, replaces, key, which in fleet_rows:
        row = fleet[key]
        entry = {"solve": solve_name(key[0], False),
                 "costs": solve_name(key[0], True),
                 "weights": "mppi_weights", "merge": "pm_merge"}[which]
        runs = [fleet[r] for r in fleet] if which == "merge" else [row]
        t = row["kernel_times"][which]
        err_key, err_of = errs_of[which]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(r[part]["launches"].get(entry, 0) for r in runs
                            for part in ("host_driven", "on_device")),
            "path": (f"the fleet of {row['n']} ({key[0]}, K={FLEET_K}, "
                     f"H={FLEET_H}{', normalized' if key[1] else ''}): "
                     f"{FLEET_STEPS} host-driven steps and {FLEET_STEPS} "
                     "on-device periods" + (", every fleet row"
                                            if which == "merge" else "")),
            "vehicles": row["n"],
            "max_abs_err": max(fleet[r]["vs_plain"]["max_errs"][err_key]
                               for r in fleet if r[0] == key[0]),
            "max_abs_err_of": f"{err_of}, vehicle by vehicle, injected z, "
                              f"K={FLEET_K}, H={FLEET_H}",
            "ms": t["ms"], "device_ms": t["device_ms"],
            "per_vehicle_ms": t["per_vehicle_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None})
    # one PyTorch call computes the noise dump's function (another stream):
    # torch.randn at the dump's shape; the serving phases' launches
    lib_ms = library_randn({
        "pm_noise_dump": ((H, 3, K), torch.float32),
        "pm_noise_dump[antithetic]": ((H, 3, K), torch.float32),
        "pm_noise_dump[bf16]": ((H, 3, K), torch.bfloat16)})
    served = {n: serve["launches"][n] + serve["mstep"]["launches"][n]
              for n in ("pm_fused_solve", "pm_merge")}
    served.update({f"{n}[fleet]": serve_fleet["launches"][n]
                   for n in ("pm_fused_solve", "pm_merge")})
    sh_launches = sharded_launches(sharded)
    for row in kernels:
        if row["name"] in lib_ms:
            row["library_ms"] = lib_ms[row["name"]]["ms"]
            row["library_device_ms"] = lib_ms[row["name"]]["device_ms"]
            row["library_call"] = (f"torch.randn({lib_ms[row['name']]['shape']}"
                                   f", dtype={lib_ms[row['name']]['dtype']})")
            if row["name"] == "pm_noise_dump[bf16]":
                # the dump writes bf16 values held in f32, 4 bytes a normal
                row["library_note"] = ("torch.randn at bf16 writes 2 bytes "
                                       "a normal, the dump 4")
        if row["name"] in served:
            # launched by the serve phases: the served headline loop and
            # its m-step requests, or the coalescer's dispatches
            row["launches_serve"] = served[row["name"]]
        if row["name"] in sh_launches:
            # launched once a shard by the sharded phase's runs
            row["launches_sharded"] = sh_launches[row["name"]]
        if row["name"] in od_launches:
            # launched by the on-device phase's replayed graphs, as the
            # profiler counted them, and checked at their shapes there
            (row["launches_on_device"],
             row["max_abs_err_on_device"]) = od_launches[row["name"]]
            row["max_abs_err_on_device_of"] = (
                "kernel vs plain at the on-device rows' K and H, injected "
                "z: the solve's wnoise (action units), the costs, phase "
                "B's and the merge's zsum / l")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
