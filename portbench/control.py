"""Readings that set the judge's limits, run on the card at a cell's own
size (not part of a benchmark run):

    python3 portbench/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--kernel-dtype float32|bfloat16]

For each seed, one run's window and judge in this process, printing one
JSON line of the numbers compared: at ``float32`` the sound program's
readings (the lower ends), at ``bfloat16`` the control's, the port's
bf16 block compute in the program's place (the upper ends). For a loop
cell each line also carries ``state_gap_bf16_plant``: the state gap with
the reference's plant computed in bf16 put in the program's plant's
place, stepping from the program's states under its actions (the plant
runs in f32 whatever the kernels' compute type, so the port has no lower
path of its own there).
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def bf16_plant_gap(ref, out: dict, traffic: dict) -> float:
    """The state gap of the reference's plant computed in bf16, stepping
    from each period's starting state (the program's) under the
    program's action, against the same steps in f64."""
    import torch

    low = copy.copy(ref)
    for name, v in vars(ref).items():
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            setattr(low, name, v.to(torch.bfloat16))
    states = out["states"].to(ref.device)
    actions = out["actions"].to(ref.device)
    dt, sub = float(traffic["plant_dt"]), int(traffic["plant_substeps"])
    x = torch.as_tensor(traffic["start"], dtype=torch.float64,
                        device=ref.device)
    gap = 0.0
    for j in range(states.shape[0]):
        want = ref.plant(x, actions[j], dt, sub)
        got = low.plant(x.bfloat16(), actions[j].bfloat16(), dt,
                        sub).double()
        gap = max(gap, float(((got - want).abs()
                              / (1.0 + want.abs())).max()))
        x = states[j]
    return gap


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--kernel-dtype", default="float32",
                   choices=("float32", "bfloat16"))
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        ctx = harness.Context(ROOT, args.workload, seed, "cuda",
                              kernel_dtype=args.kernel_dtype)
        driver = ctx.driver()
        cell = driver.Cell(ctx)
        win = cell.window(args.seconds, {})
        out = cell.outputs()
        cell.free()
        del cell
        gc.collect()
        torch.cuda.empty_cache()
        ref = ctx.reference("cuda")
        t1 = time.perf_counter()
        checks = driver.judge(ctx, out, ref)
        line = {"workload": args.workload, "seed": seed,
                "kernel_dtype": args.kernel_dtype, "failed": win["failed"],
                "attempted": win["attempted"], "checks": checks,
                "reference_s": time.perf_counter() - t1,
                "run_s": time.perf_counter() - t0}
        if "states" in out:
            line["state_gap_bf16_plant"] = bf16_plant_gap(ref, out,
                                                          ctx.traffic)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
