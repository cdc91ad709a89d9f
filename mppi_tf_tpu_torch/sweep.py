"""Hyperparameter sweep driver.

The port of the JAX package's ``sweep.py``. Reference:
scripts/src/mujoco/gen_config.py (patches the default env / task YAMLs with
swept values) and bash/experiment.sh (nested loops over lambda / upsilon /
gamma / noise re-invoking main.py). Both collapse into one in-process
driver: base configs, a grid of dotted-key overrides, and for every
combination either the closed-loop experiment on the card (``--cpu``: on
the CPU), one JSON record a combo with the JAX package's keys (final
state, the task's own state cost over the run, the mean solve time), or
only the patched YAMLs (``--dump-dir``, the gen_config behaviour).

Usage:
    python -m mppi_tf_tpu_torch.sweep --config envs/point_mass \\
        --task tasks/static_cost --model models/point_mass_model \\
        --set lambda=0.5,1.0,1.5 --set upsilon=1.0,1.2 -s 50 \\
        --out sweep_results.jsonl
"""

from __future__ import annotations

import argparse
import copy
import itertools
import json
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", required=True)
    p.add_argument("--task", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--set", action="append", default=[], metavar="KEY=V1,V2",
                   help="sweep axis: dotted key into the env (default), "
                        "task.* or model.* config, with comma-separated "
                        "values; repeatable (cross product)")
    p.add_argument("-s", "--steps", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="sweep_results.jsonl")
    p.add_argument("--dump-dir", default=None,
                   help="only write the patched YAML files here (one "
                        "subdir per combo), do not run (gen_config mode)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    return p.parse_args(argv)


def _parse_value(text: str):
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return text


def _split_values(text: str):
    """Split on commas at bracket depth 0 so JSON lists survive:
    "0.5,[1,2],2.0" -> ["0.5", "[1,2]", "2.0"]."""
    parts, depth, cur = [], 0, []
    for ch in text:
        if ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return [p for p in parts if p]


def _set_dotted(cfg: dict, dotted: str, value):
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def expand_grid(set_specs):
    """["KEY=V1,V2", ...] -> iterator of [(target, dotted_key, value)]
    combos, the cross product of the axes."""
    axes = []
    for spec in set_specs:
        key, _, vals = spec.partition("=")
        if not vals:
            raise ValueError(f"--set needs KEY=V1,V2,...: {spec!r}")
        target = "env"
        if key.startswith(("task.", "model.")):
            target, key = key.split(".", 1)
        axes.append([(target, key, _parse_value(v))
                     for v in _split_values(vals)])
    for combo in itertools.product(*axes):
        yield list(combo)


def main(argv=None):
    args = parse_args(argv)

    from .cfg import load_config, write_config

    base = {"env": load_config(args.config), "task": load_config(args.task),
            "model": load_config(args.model)}

    results = []
    for i, combo in enumerate(expand_grid(args.set) if args.set else [[]]):
        cfgs = copy.deepcopy(base)
        label = {}
        for target, key, value in combo:
            _set_dotted(cfgs[target], key, value)
            label[f"{target}.{key}"] = value

        if args.dump_dir is not None:
            d = os.path.join(args.dump_dir, f"combo_{i:04d}")
            for name in ("env", "task", "model"):
                write_config(cfgs[name], os.path.join(d, f"{name}.yaml"))
            with open(os.path.join(d, "overrides.json"), "w") as f:
                json.dump(label, f)
            print(f"combo {i}: wrote {d}  {label}")
            continue

        import torch

        from .envs.runner import run_experiment

        out = run_experiment(cfgs["env"], cfgs["task"], cfgs["model"],
                             steps=args.steps, log=False, seed=args.seed,
                             device="cpu" if args.cpu else "cuda")
        ctrl = out["controller"]
        states = out["states"]
        # score the trajectory with the task's own state cost
        with torch.no_grad():
            traj = ctrl._cost.state_cost(torch.as_tensor(
                states, dtype=ctrl._dtype, device=ctrl._device))
        traj_costs = [float(c) for c in traj.cpu()]
        rec = {
            "combo": i,
            "overrides": label,
            "final_state": [float(v) for v in states[-1]],
            "final_cost": traj_costs[-1],
            "mean_cost": sum(traj_costs) / len(traj_costs),
            "avg_solve_ms": round(
                1e3 * ctrl.timing["total"] / max(ctrl.timing["calls"], 1), 3),
        }
        results.append(rec)
        print(json.dumps(rec))

    if results and args.out:
        with open(args.out, "w") as f:
            for rec in results:
                f.write(json.dumps(rec) + "\n")
        print(f"wrote {len(results)} results to {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
