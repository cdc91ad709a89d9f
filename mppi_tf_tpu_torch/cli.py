"""Command-line closed-loop experiment runner of the port.

Reference: scripts/main.py (the intended flow): run a configured MPPI
experiment (``--config`` / ``--task`` / ``--model``), or replay one from the
config snapshots of a directory (``--replay --log-dir``). It runs on the
card unless ``--cpu`` (or ``--f64``, float64 on the CPU) is given. ``-l``
writes metrics and config snapshots into a stamped directory under
``--log-dir`` (observer/); ``-t N`` trains the model from the run's
transitions every N steps (``learning/learner.py``) and hands it to the
controller; ``--on-device`` runs the whole experiment in the on-device
loop (``envs/mjx_env.py``; a ``jax:point_mass`` or analytic AUV plant, no
``-t``). ``-g`` writes an animated GIF of the run, ``run.gif`` in the
run's log directory (``-l``) or the working directory
(``utils/plotting.py``; matplotlib and imageio on the host).

Usage:
    python -m mppi_tf_tpu_torch.cli --config envs/point_mass \\
        --task tasks/static_cost --model models/point_mass_model -s 100
    python -m mppi_tf_tpu_torch.cli --replay --log-dir <dir with config.yaml>

Prints one JSON line: steps, final_state, logdir, avg_solve_ms (with
``--on-device``, on_device_ms_per_step instead: the host-side solve timer
never ticks), the kernel path the controller resolved to, with ``-g`` the
GIF's path and, for the adaptive DMD controller (``--model
models/dmd_model``), its refit count n_fits.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", help="env config: bundled name "
                                    "(envs/point_mass) or YAML path")
    p.add_argument("--task", help="task config: bundled name or YAML path")
    p.add_argument("--model", help="model config: bundled name or YAML path")
    p.add_argument("--replay", action="store_true",
                   help="re-run an experiment from a directory's snapshots")
    p.add_argument("--log-dir", default="logs",
                   help="log output dir (or replay source with --replay)")
    p.add_argument("-s", "--steps", type=int, default=100,
                   help="number of control steps")
    p.add_argument("-t", "--train", type=int, default=0,
                   help="train the model every N steps (0 = never)")
    p.add_argument("-l", "--log", action="store_true",
                   help="write TensorBoard/JSONL metrics and config "
                        "snapshots")
    p.add_argument("-r", "--render", action="store_true",
                   help="render the simulation (the analytic plants draw "
                        "nothing)")
    p.add_argument("-g", "--gif", action="store_true",
                   help="write an animated GIF of the run (run.gif)")
    p.add_argument("-f", "--filter", action="store_true",
                   help="Savitzky-Golay smooth the action sequence "
                        "('filter: true' in the env config)")
    p.add_argument("--on-device", action="store_true",
                   help="run the whole experiment (solve + plant) on the "
                        "device, one CUDA graph a control period on the "
                        "card (needs a jax:/analytic-AUV plant; excludes "
                        "-t)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--f64", action="store_true",
                   help="run in float64 on the CPU (parity mode)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import torch

    from .cfg import load_config, parse_dir
    from .envs.runner import run_experiment

    if args.replay:
        env_cfg, task_cfg, model_cfg = parse_dir(args.log_dir)
    else:
        env_cfg = load_config(args.config)
        task_cfg = load_config(args.task)
        model_cfg = load_config(args.model)
        if env_cfg is None or task_cfg is None or model_cfg is None:
            print("error: --config, --task and --model are required "
                  "(or --replay --log-dir)", file=sys.stderr)
            return 2
    if args.filter:
        env_cfg = dict(env_cfg, filter=True)

    result = run_experiment(
        env_cfg, task_cfg, model_cfg, steps=args.steps, log=args.log,
        log_path=None if args.replay else args.log_dir, render=args.render,
        seed=args.seed, train_every=args.train,
        dtype=torch.float64 if args.f64 else torch.float32,
        on_device=args.on_device,
        device="cpu" if (args.cpu or args.f64) else "cuda")
    ctrl, observer = result["controller"], result["observer"]
    timing = ctrl.timing
    gif = None
    if args.gif:
        from .utils.plotting import run_to_gif

        out = os.path.join(observer.get_logdir() if observer is not None
                           else ".", "run.gif")
        gif = run_to_gif(result["states"], out, goal=task_cfg.get("goal"))
    if observer is not None:
        observer.close()
    if "on_device_ms_per_step" in result:
        speed = {"on_device_ms_per_step": round(
            result["on_device_ms_per_step"], 3)}
    else:
        speed = {"avg_solve_ms": round(1e3 * timing["total"]
                                       / max(timing["calls"], 1), 3)}
    print(json.dumps({
        "steps": int(args.steps),
        "final_state": [round(float(v), 4) for v in result["states"][-1]],
        "logdir": observer.get_logdir() if observer is not None else None,
        **speed,
        "kernel_path": ctrl.kernel_path,
        **({"gif": gif} if args.gif else {}),
        **({"n_fits": ctrl.n_fits} if hasattr(ctrl, "n_fits") else {}),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
