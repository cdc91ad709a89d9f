"""Worker program of the local multi-process cluster (``cluster.py``).

Every process runs this same program (the model of ``launch.py``): join
the group through ``launch.initialize``, build the global mesh of
``--shards`` shards a rank, run the workloads and write the replicated
results to a JSON file, which the parent compares across ranks and
against a single-process mesh. Counterpart of
``mppi_tf_tpu/parallel/_mp_worker.py``; its workloads:

- ``mppi`` (the JAX worker's three, at its sizes: k 64, tau 6, f64):
  ``ShardedMPPI._solve_with_noise`` on injected noise, the same with
  ``normalize_cost`` (all four collectives of the update law across the
  ranks), and ``next`` on the shards' own generators (the PRNG path);
- ``fused``: ``ShardedFusedMPPI`` (``get_controller(mesh=,
  kernel="cuda")``) on the workload of ``--spec``: injected normals from
  its seed, then ``next`` on the Philox streams. On the card every rank
  launches the kernels on its shards. JAX's worker leaves this path out
  because its interpret mode cannot run across processes; the port's
  wrappers have no such limit;
- ``group_loop`` (a group of one rank, ``--backend nccl``): the sharded
  solve of ``--spec`` against the single-device kernels, bit for bit, and
  its on-device loop captured with the group's all-reduces in the graph,
  replayed == eager;
- ``fleet``: ``FleetMPPI(mesh=)``, 8 vehicles split over the ranks'
  shards, every rank returning every vehicle's action;
- ``train``: the dp x tp train step (``train.py``) on ``--train``'s data;
- ``--bench K,TAU,CHAIN``: a chained sharded solve timed a worker, beside
  a local mesh with the same work a shard.

Run it as ``python -m mppi_tf_tpu_torch.parallel._mp_worker --init
file:///path/store --nproc N --pid I --out result.json``; the shards
lie on the card unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def _tolist(t) -> list:
    return torch.as_tensor(t).detach().cpu().double().numpy().tolist()


def run_mppi(mesh, device) -> dict:
    """The JAX worker's three workloads (its _mp_worker.py:87-131)."""
    from ..costs.static import StaticCost
    from ..models.point_mass import PointMassModel
    from .sharded import ShardedMPPI

    k, tau, sdim, adim = 64, 6, 6, 3
    dt, mass, lam, gamma, ups = 0.1, 1.5, 1.2, 1.1, 2.0
    sigma = np.diag([0.25, 0.3, 0.2])
    goal = np.zeros(sdim)
    goal[0] = 1.0
    f64 = torch.float64
    model = PointMassModel(mass=mass, dt=dt, state_dim=sdim,
                           action_dim=adim, dtype=f64)
    cost = StaticCost(lam, gamma, ups, sigma, goal, np.eye(sdim), dtype=f64)
    rng = np.random.default_rng(7)
    eps = torch.as_tensor(rng.normal(size=(k, tau, adim)) * 0.3,
                          device=device)
    x0 = torch.as_tensor(rng.normal(size=sdim), device=device)
    useq = torch.as_tensor(rng.normal(size=(tau, adim)) * 0.1, device=device)
    out = {}
    for norm, prefix in ((False, ""), (True, "norm_")):
        ctrl = ShardedMPPI(model, cost, mesh, k=k, tau=tau, lam=lam,
                           upsilon=ups, sigma=sigma, seed=3,
                           normalize_cost=norm)
        action, new_useq, _ = ctrl._solve_with_noise(eps, x0, useq)
        out[prefix + "action"] = _tolist(action)
        out[prefix + "useq"] = _tolist(new_useq)
        if not norm:
            out["prng_action"] = _tolist(ctrl.next(np.zeros(sdim)))
    return out


def run_fused(mesh, device, spec: dict) -> dict:
    """``ShardedFusedMPPI`` on ``spec``: {"model", "task" (configs of
    get_model / get_cost), "state_dim", "action_dim", "dt", "gamma",
    "env" (get_controller's config), "z_seed", "x0", "prng_steps"}."""
    from ..controller import get_controller
    from ..kernels import _launch

    env = spec["env"]
    model, cost = _spec_modules(spec, device)
    ctrl = get_controller(model, cost, env, mesh=mesh, kernel="cuda")
    k, tau, adim = env["samples"], env["horizon"], spec["action_dim"]
    z = np.random.default_rng(spec["z_seed"]).standard_normal(
        (tau, adim, k), np.float32)
    x0 = torch.as_tensor(np.asarray(spec["x0"], np.float32), device=device)
    useq = torch.zeros(tau, adim, device=device)
    _launch.reset_launch_counts()
    action, new_useq, info = ctrl._solve_with_noise(
        torch.as_tensor(z, device=device), x0, useq)
    prng = [_tolist(ctrl.next(np.asarray(spec["x0"])))
            for _ in range(spec.get("prng_steps", 1))]
    counts = {n: c for n, c in _launch.launch_counts.items() if c}
    return {"fused_class": type(ctrl).__name__,
            "fused_action": _tolist(action), "fused_useq": _tolist(new_useq),
            "fused_nabla": float(info["nabla"]),
            "fused_prng_actions": prng, "fused_launches": counts}


def _spec_modules(spec: dict, device):
    """The model and cost of a workload ``spec`` (``run_fused``)."""
    from ..costs import get_cost
    from ..models import get_model

    env = spec["env"]
    model = get_model(spec["model"], dt=spec["dt"],
                      state_dim=spec["state_dim"],
                      action_dim=spec["action_dim"], device=device)
    cost = get_cost(spec["task"], lam=env["lambda"], gamma=spec["gamma"],
                    upsilon=env["upsilon"],
                    sigma=np.asarray(env["noise"], np.float64),
                    device=device)
    return model, cost


def run_group_loop(mesh, device, spec: dict) -> dict:
    """On a group of one rank (NCCL, whose collectives a CUDA graph can
    capture): the sharded solve of ``spec`` against the single-device
    ``MPPI`` fused solve at the same seed and solve index, bit for bit;
    then the on-device loop of ``spec["loop"]`` (steps, substeps; the
    point-mass plant) captured with the group's all-reduces in its graph,
    replayed and run eagerly at the same solve indices."""
    from ..controller import MPPI, get_controller
    from ..envs import DevicePointMassEnv
    from ..envs.mjx_env import build_on_device_loop
    from ..kernels import _launch

    env = spec["env"]
    model, cost = _spec_modules(spec, device)
    ctrl = get_controller(model, cost, env, mesh=mesh, kernel="cuda")
    single = MPPI(model, cost, k=env["samples"], tau=env["horizon"],
                  lam=env["lambda"], upsilon=env["upsilon"],
                  sigma=np.asarray(env["noise"]), kernel="cuda",
                  device=device)
    norm = bool(env.get("normalize", False))
    x0 = torch.as_tensor(np.asarray(spec["x0"], np.float32), device=device)
    useq = torch.full((env["horizon"], spec["action_dim"]), 0.1,
                      device=device)
    bits = {}
    for s in (5, torch.tensor([5], device=device)):
        got, _ = ctrl._fused.solve(x0, useq, seed=0, solve=s,
                                   normalize=norm)
        want, _ = single._fused.solve(x0, useq, seed=0, solve=5,
                                      normalize=norm)
        bits["int" if isinstance(s, int) else "device"] = bool(
            torch.equal(got, want))
    lp = spec["loop"]
    run = build_on_device_loop(ctrl, DevicePointMassEnv(
        n_dof=spec["action_dim"], dt=lp["dt"]).step_fn, lp["steps"],
        lp["substeps"])
    _launch.reset_launch_counts()
    t0 = time.perf_counter()
    s_g, a_g = run(spec["x0"], step0=0)
    first_s = time.perf_counter() - t0
    counts = {n: c for n, c in _launch.launch_counts.items() if c}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    run(spec["x0"], step0=0)
    wall = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    s_e, a_e = run.eager(spec["x0"], step0=0)
    goal = np.asarray(spec["task"]["goal"])
    return {"group_solve_bits": bits,
            "group_loop_replay_equals_eager": bool(
                torch.equal(s_g, s_e) and torch.equal(a_g, a_e)),
            "group_loop_nodes": run.nodes,
            "group_loop_launches": counts,
            "group_loop_captures": run.captures,
            "group_loop_first_run_s": first_s,
            "group_loop_wall_ms_a_period": wall * 1e3 / lp["steps"],
            "group_loop_events_ms_a_period":
                start.elapsed_time(end) / lp["steps"],
            "group_loop_goal_err": float(np.linalg.norm(
                s_g[-1].cpu().double().numpy() - goal))}


def run_fleet(mesh, device) -> dict:
    """``FleetMPPI(mesh=)``: 8 point masses to distinct goals split over
    the mesh (the JAX test's fleet, tests/test_fleet.py:86), 3 steps; the
    actions every rank returns."""
    from ..controller import FleetMPPI
    from ..costs import get_cost
    from ..models import get_model

    sigma = np.diag([0.4, 0.4])
    model = get_model({"type": "point_mass", "mass": 1.0}, dt=0.1,
                      state_dim=4, action_dim=2, dtype=torch.float64,
                      device=device)
    cost = get_cost({"type": "static", "diag": True,
                     "goal": [1.0, 0.0, -0.5, 0.0], "Q": [8.0, 1.5, 8.0,
                                                          1.5]},
                    lam=0.6, gamma=0.2, upsilon=1.0, sigma=sigma,
                    dtype=torch.float64, device=device)
    fleet = FleetMPPI(model, cost, n_vehicles=8, k=64, tau=5, lam=0.6,
                      upsilon=1.0, sigma=sigma, goals=fleet_goals(),
                      seed=9, mesh=mesh, device=device)
    states = np.random.default_rng(1).normal(size=(8, 4))
    return {"fleet_actions": [fleet.next(states).tolist()
                              for _ in range(3)]}


def fleet_goals() -> np.ndarray:
    """The fleet workload's goals: x from -1 to 1, y = -0.5."""
    goals = np.tile(np.array([[1.0, 0.0, -0.5, 0.0]]), (8, 1))
    goals[:, 0] = np.linspace(-1.0, 1.0, 8)
    return goals


def run_train(mesh_devices, data: dict) -> dict:
    """The dp x tp train step on ``data`` (X, Y, the initial net w0.., b..,
    hidden, lr, steps, dp, tp, dtype): the losses and the final net."""
    from ..models.nn import NNAUVModel
    from . import launch
    from .train import make_sharded_train_step

    dtype = getattr(torch, str(data["dtype"]))
    hidden = tuple(int(h) for h in data["hidden"])
    model = NNAUVModel(action_dim=6, dt=0.1, hidden=hidden, dtype=dtype,
                       device=mesh_devices[0])
    model.with_trainable([{"w": data[f"w{i}"], "b": data[f"b{i}"]}
                          for i in range(len(hidden) + 1)])
    mesh = launch.global_mesh(("dp", "tp"),
                              (int(data["dp"]), int(data["tp"])),
                              devices=mesh_devices)
    init, step_fn, place_batch = make_sharded_train_step(
        model, mesh, learning_rate=float(data["lr"]))
    params, opt = init()
    X, Y = place_batch(data["X"], data["Y"])
    losses = []
    for _ in range(int(data["steps"])):
        params, opt, loss = step_fn(params, opt, X, Y)
        losses.append(float(loss))
    net = params.full()
    return {"train_losses": losses,
            "train_net": [{"w": _tolist(p["w"]), "b": _tolist(p["b"])}
                          for p in net]}


def run_bench(mesh, device, bench: str, nproc: int, shards: int) -> dict:
    """Chained sharded solves timed a worker (median of 3 runs of CHAIN
    steps, one sync a run), beside a local mesh of ``shards`` shards with
    the same work a shard: the difference is what the cross-rank
    collectives cost a solve."""
    from ..costs.static import StaticCost
    from ..models.point_mass import PointMassModel
    from .mesh import Mesh
    from .sharded import ShardedMPPI

    bk, btau, bchain = (int(v) for v in bench.split(","))
    sigma = np.diag([0.25, 0.3, 0.2])
    goal = np.zeros(6)
    goal[0] = 1.0
    f64 = torch.float64
    model = PointMassModel(mass=1.5, dt=0.1, state_dim=6, action_dim=3,
                           dtype=f64)
    cost = StaticCost(1.2, 1.1, 2.0, sigma, goal, np.eye(6), dtype=f64)

    def chained(m, k) -> float:
        ctrl = ShardedMPPI(model, cost, m, k=k, tau=btau, lam=1.2,
                           upsilon=2.0, sigma=sigma, seed=3)
        times = []
        for _ in range(4):
            x = torch.zeros(6, dtype=f64, device=device)
            useq = torch.zeros(btau, 3, dtype=f64, device=device)
            t0 = time.perf_counter()
            for _ in range(bchain):
                a, useq, _ = ctrl._solve(x, useq)
                x = model.step(x[None], a[None])[0].detach()
            float(x[0])
            times.append((time.perf_counter() - t0) / bchain)
        return 1e3 * float(np.median(times[1:]))

    local = Mesh([device] * shards)
    return {"p50_solve_ms": chained(mesh, bk),
            "p50_local_ms": chained(local, bk // nproc),
            "bench": {"K": bk, "TAU": btau, "CHAIN": bchain}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--init", required=True,
                    help="the rendezvous: host:port or an init_method URL")
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--out", required=True, help="result JSON path")
    ap.add_argument("--shards", type=int, default=1,
                    help="shards a rank")
    ap.add_argument("--device", default="cuda",
                    help="the shards' device: cuda (the card the ranks "
                    "share) or cpu")
    ap.add_argument("--workloads", default="mppi")
    ap.add_argument("--spec", help="the fused workload's JSON spec")
    ap.add_argument("--train", help="the train workload's .npz")
    ap.add_argument("--bench", default="", help="'K,TAU,CHAIN'")
    ap.add_argument("--backend", default="gloo")
    args = ap.parse_args()
    torch.set_num_threads(1)

    from . import launch

    launch.initialize(coordinator_address=args.init,
                      num_processes=args.nproc, process_id=args.pid,
                      backend=args.backend)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no GPU is present; pass --device cpu")
    devices = [device] * args.shards
    mesh = launch.global_mesh(devices=devices)
    info = launch.process_info(mesh)
    assert info["process_count"] == args.nproc, info
    assert info["process_index"] == args.pid, info
    assert info["global_devices"] == args.nproc * args.shards, info
    out = {"pid": args.pid, "nproc": args.nproc, "global_devices":
           mesh.size, "backend": info["backend"]}
    workloads = [w for w in args.workloads.split(",") if w]
    if "mppi" in workloads:
        out.update(run_mppi(mesh, device))
    if "fused" in workloads:
        with open(args.spec) as f:
            out.update(run_fused(mesh, device, json.load(f)))
    if "group_loop" in workloads:
        with open(args.spec) as f:
            out.update(run_group_loop(mesh, device, json.load(f)))
    if "fleet" in workloads:
        out.update(run_fleet(mesh, device))
    if "train" in workloads:
        with np.load(args.train) as d:
            out.update(run_train(devices, {n: d[n] for n in d.files}))
    if args.bench:
        out.update(run_bench(mesh, device, args.bench, args.nproc,
                             args.shards))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    with open(args.out, "w") as f:
        json.dump(out, f)
    print(f"worker {args.pid}/{args.nproc} OK ({mesh.size} shards)",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
