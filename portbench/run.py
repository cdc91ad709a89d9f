"""The benchmark of the PyTorch and CUDA port (``mppi_tf_tpu_torch``).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout on a machine with the cell's NVIDIA GPUs.
It builds the cell (the port's kernels are built by ``nvcc`` into the
checkout's ``mppi_tf_tpu_torch/_build/`` on a checkout's first run and
loaded afterwards), warms up the cell's own shapes, measures for
``--seconds``, judges the window's outputs against the plain reference,
and prints one JSON line: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device`` and, traced, ``breakdown``; last, under
``checks``, each number the judge compared beside its limit, which also
close standard error. Without a CUDA device, or with fewer than the cell
asks for, it prints no result and exits 2; if JAX or the JAX package is
loaded once the window has closed, it exits 3.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # caches of the run stay inside the checkout, at fixed paths
    cache = ROOT / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    ctx = harness.Context(ROOT, args.workload, args.seed, "cuda", t0=T0)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: nothing measured", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(ctx.cell["chips"]):
        print(f"the cell asks for {ctx.cell['chips']} GPUs, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = harness.run(ctx, args.seconds, bool(args.trace))
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in the run: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
