"""Command-line closed-loop experiment runner of the port.

Reference: scripts/main.py (the intended flow): run a configured MPPI
experiment (``--config`` / ``--task`` / ``--model``), or replay one from the
config snapshots of a directory (``--replay --log-dir``). It runs on the
card unless ``--cpu`` (or ``--f64``, float64 on the CPU) is given. Logging
(``-l``), GIFs (``-g``), training (``-t``) and the on-device loop
(``--on-device``) are not ported yet and raise ``NotImplementedError``
naming their ROADMAP items.

Usage:
    python -m mppi_tf_tpu_torch.cli --config envs/point_mass \\
        --task tasks/static_cost --model models/point_mass_model -s 100
    python -m mppi_tf_tpu_torch.cli --replay --log-dir <dir with config.yaml>

Prints one JSON line: steps, final_state, logdir, avg_solve_ms and the
kernel path the controller resolved to.
"""

from __future__ import annotations

import argparse
import json
import sys

#: flags of the JAX CLI whose machinery is not ported yet
_NOT_PORTED = (
    ("log", "-l/--log: observers are not ported yet: ROADMAP item 7"),
    ("gif", "-g/--gif: GIF plotting is not ported yet: ROADMAP item 15"),
    ("train", "-t/--train: the learner is not ported yet: ROADMAP item 11"),
    ("on_device", "--on-device: the on-device closed loop is not ported "
                  "yet: ROADMAP item 13"),
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", help="env config: bundled name "
                                    "(envs/point_mass) or YAML path")
    p.add_argument("--task", help="task config: bundled name or YAML path")
    p.add_argument("--model", help="model config: bundled name or YAML path")
    p.add_argument("--replay", action="store_true",
                   help="re-run an experiment from a directory's snapshots")
    p.add_argument("--log-dir", default="logs",
                   help="replay source with --replay")
    p.add_argument("-s", "--steps", type=int, default=100,
                   help="number of control steps")
    p.add_argument("-t", "--train", type=int, default=0,
                   help="train the model every N steps (not ported yet)")
    p.add_argument("-l", "--log", action="store_true",
                   help="write metrics and config snapshots (not ported yet)")
    p.add_argument("-r", "--render", action="store_true",
                   help="render the simulation (the analytic plants draw "
                        "nothing)")
    p.add_argument("-g", "--gif", action="store_true",
                   help="write an animated GIF of the run (not ported yet)")
    p.add_argument("-f", "--filter", action="store_true",
                   help="Savitzky-Golay smooth the action sequence "
                        "('filter: true' in the env config)")
    p.add_argument("--on-device", action="store_true",
                   help="one device program for the whole experiment "
                        "(not ported yet)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--f64", action="store_true",
                   help="run in float64 on the CPU (parity mode)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    for flag, message in _NOT_PORTED:
        if getattr(args, flag):
            raise NotImplementedError(message)

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
        env_cfg, task_cfg, model_cfg, steps=args.steps, render=args.render,
        seed=args.seed,
        dtype=torch.float64 if args.f64 else torch.float32,
        device="cpu" if (args.cpu or args.f64) else "cuda")
    ctrl = result["controller"]
    timing = ctrl.timing
    print(json.dumps({
        "steps": int(args.steps),
        "final_state": [round(float(v), 4) for v in result["states"][-1]],
        "logdir": None,
        "avg_solve_ms": round(1e3 * timing["total"]
                              / max(timing["calls"], 1), 3),
        "kernel_path": ctrl.kernel_path,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
