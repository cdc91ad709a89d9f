#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root:  python3 chip_smoke.py

Builds the CUDA kernels of ``mppi_tf_tpu_torch`` from the sources in the
checkout, holds each kernel against its plain PyTorch version, checks the
in-kernel noise stream, drives the main path (``MPPI.next`` over the
point-mass model and static cost at K=100,000 samples, H=50, closed loop
against the analytic plant) and times it. Each phase prints one JSON line;
any failed check raises and the script exits non-zero. Without a CUDA
device it exits non-zero before printing any result.

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


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def workload(device):
    from mppi_tf_tpu_torch.costs import get_cost
    from mppi_tf_tpu_torch.models import get_model

    model = get_model({"type": "point_mass", "mass": MASS}, dt=DT,
                      state_dim=6, action_dim=3, device=device)
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


def close(a: torch.Tensor, b: torch.Tensor, rtol: float, atol: float):
    """(ok, max abs err, max err / (atol + rtol |b|)) of a against b."""
    err = (a.double() - b.double()).abs()
    ratio = (err / (atol + rtol * b.double().abs())).max().item()
    return ratio <= 1.0, err.max().item(), ratio


def nnz(a) -> int:
    return int(np.count_nonzero(a))


def solve_ops(consts, k: int, tau: int, prng: bool) -> float:
    """Operations of one fused solve, from the nonzeros of this run's
    matrices (FMA = 2): rollout and cost per sample-step, the terminal
    cost, the softmax, the w*z reduction, and two noise passes."""
    sdim, adim = consts.dims
    q_ops = sdim + 2 * nnz(consts.Q) + 2 * sdim
    step = (2 * nnz(consts.A) + 2 * nnz(consts.Bs) + 2 * sdim + q_ops
            + 2 * adim + 2 * nnz(consts.Mz) + 2 * adim + 2)
    n_normals = k * tau * adim
    ops = k * (tau * step + q_ops + 6) + 2 * n_normals
    if prng:
        ops += 2 * n_normals * OPS_PER_NORMAL
    return float(ops)


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


def closed_loop(kernel: str):
    """K=100k, H=50 closed loop through the factories against the analytic
    plant; returns (controller, final goal error, per-step host ms)."""
    from mppi_tf_tpu_torch.controller import get_controller
    from mppi_tf_tpu_torch.envs import PointMassEnv
    from mppi_tf_tpu_torch.kernels import pm_mppi as pm

    model, cost = workload("cuda")
    cfg = {"samples": K, "horizon": H, "lambda": LAM, "upsilon": UPSILON,
           "noise": SIGMA.tolist(), "kernel": kernel}
    ctrl = get_controller(model, cost, cfg)
    ctrl.trace()  # builds and warms up; restores the controller's state
    env = PointMassEnv(n_dof=3, mass=MASS, dt=DT)
    x = env.reset()
    step_ms = []
    pm.reset_launch_counts()
    for _ in range(LOOP_STEPS):
        t0 = time.perf_counter()
        u = ctrl.next(x)  # returns a host array: ends in a sync
        step_ms.append((time.perf_counter() - t0) * 1e3)
        x = env.step(u)
    counts = dict(pm.launch_counts)
    err = float(np.linalg.norm(x.ravel() - np.asarray(GOAL)))
    return ctrl, err, step_ms, counts


def profile_steps(ctrl, steps: int = 20) -> dict:
    """Where a step's time goes: ``torch.profiler`` over ``steps`` calls of
    MPPI.next; device busy share = summed kernel time / wall time (one
    stream, so kernels do not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = np.zeros(6)
    ctrl.next(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            ctrl.next(x)
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "steps": steps, "wall_us_per_step": wall_us / steps,
        "device_us_per_step": dev_us / steps,
        "device_busy_share": dev_us / wall_us,
        "kernel_launches_per_step": sum(e.count for e in kern) / steps,
        "top_kernels_us_per_step": {
            e.key[:60]: e.self_device_time_total / steps for e in top},
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mppi_tf_tpu_torch.kernels import _build
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

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    emit("build", seconds=time.perf_counter() - t0,
         library=str(_build.library_path().name),
         ptxas=_build.ptxas_report())

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

    # ---- 6. closed loop on the main path ------------------------------------
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

    # ---- 7. times -------------------------------------------------------------
    consts, nb = fused.consts, -(-K // pm.BLOCK)
    n_z = H * 3
    part = pm.pm_fused_solve(consts, dyn, K, H, seed=1, solve=1)
    t_pair = cuda_ms(lambda: pm.pm_merge(pm.pm_fused_solve(
        consts, dyn, K, H, seed=1, solve=1)), 200)
    t_solve = cuda_ms(lambda: pm.pm_fused_solve(consts, dyn, K, H, seed=1,
                                                solve=1), 200)
    t_merge = cuda_ms(lambda: pm.pm_merge(part), 200)
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
    emit("times", card=smi, K=K, H=H,
         solve_plus_merge_ms=t_pair, solve_ms=t_solve, merge_ms=t_merge,
         noise_dump_ms=t_dump,
         mppi_next_ms_median=float(np.median(step_ms)),
         plain_solve_ms=p_solve, plain_merge_ms=p_merge,
         plain_noise_ms=p_dump,
         plain_note="plain PyTorch versions repeat the kernels' arithmetic; "
                    "no yardstick of speed",
         timing="CUDA events over back-to-back launches after warm-up; "
                "MPPI.next on the host clock ending in a sync")

    src = "mppi_tf_tpu_torch/csrc/pm_mppi.cu"
    kernels = [
        {"name": "pm_fused_solve", "route": "cuda", "source": src,
         "replaces": "mppi_tf_tpu/kernels/pm_mppi.py:998",
         "launches": main_counts["pm_fused_solve"],
         "max_abs_err": main_chk["solve_only_max_abs_err"],
         "ms": t_solve, "plain_ms": p_solve, "bound_ms": b_solve[0],
         "bound_by": b_solve[1], "library_ms": None},
        {"name": "pm_merge", "route": "cuda", "source": src,
         "replaces": "mppi_tf_tpu/kernels/pm_mppi.py:998",
         "launches": main_counts["pm_merge"],
         "max_abs_err": main_chk["merge_only_max_abs_err"],
         "ms": t_merge, "plain_ms": p_merge, "bound_ms": b_merge[0],
         "bound_by": b_merge[1], "library_ms": None},
        {"name": "pm_noise_dump", "route": "cuda", "source": src,
         "replaces": "mppi_tf_tpu/kernels/pm_mppi.py:273",
         "launches": noise["launches"], "path": "noise statistics check",
         "max_abs_err": noise["max_abs_err"],
         "ms": t_dump, "plain_ms": p_dump, "bound_ms": b_dump[0],
         "bound_by": b_dump[1], "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
