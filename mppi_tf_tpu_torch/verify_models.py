"""Model verification: roll recorded action sequences through one or more
models and compare them with the ground truth.

Reference: scripts/verify_models.py — load N model configs (or learner
logdirs, the latest ``weights_step*`` checkpoint of each), roll an action
sequence open loop (``run_model``), report the per-dimension MSE and plot
the trajectories (scripts/src/misc/test_models.py); the JAX package's
``mppi_tf_tpu/verify_models.py`` is the port's reference. It runs on the
card unless ``--cpu``.

Usage:
    python -m mppi_tf_tpu_torch.verify_models --models models/rexrov2 \\
        --seq seq.npz --gt gt.npz [--plot out.png]

``--seq`` is an npz with ``actions`` [tau, aDim] (or a .npy array);
``--gt`` an npz with ``traj`` [tau+1, sDim]. Prints one JSON line: a list
of {"model", "mse_per_dim", "mse"}.
"""

from __future__ import annotations

import argparse
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--models", nargs="+", required=True,
                   help="model configs (bundled names / YAML paths) or "
                        "learner logdirs containing weights_step*")
    p.add_argument("--labels", nargs="*", default=None)
    p.add_argument("--seq", required=True, help="npz with actions [tau, aDim]")
    p.add_argument("--gt", required=True, help="npz with traj [tau+1, sDim]")
    p.add_argument("--dt", type=float, default=0.1)
    p.add_argument("--plot", default=None, help="write a comparison PNG")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    return p.parse_args(argv)


def load_model(spec: str, dt: float, state_dim: int, action_dim: int,
               device=None):
    """A model from a config name / path, or from a learner logdir: its
    ``model.yaml`` (default an ``auv_nn`` model) with the parameters of
    its latest ``weights_step*`` checkpoint (verify_models.py:49-76)."""
    from .cfg import load_config, parse_config
    from .interop import from_jax_params
    from .learning.checkpoint import latest_checkpoint, load_checkpoint
    from .models import get_model

    if os.path.isdir(spec):
        ckpt = latest_checkpoint(spec)
        if ckpt is None:
            raise FileNotFoundError(f"no weights_step* checkpoint in {spec}")
        cfg_path = os.path.join(spec, "model.yaml")
        cfg = (parse_config(cfg_path) if os.path.exists(cfg_path)
               else {"type": "auv_nn"})
        model = get_model(cfg, dt=dt, state_dim=state_dim,
                          action_dim=action_dim, device=device)
        from_jax_params(load_checkpoint(ckpt), None, model)
        return model
    return get_model(load_config(spec), dt=dt, state_dim=state_dim,
                     action_dim=action_dim, device=device)


def _load_array(path, key):
    """A plain .npy array, or from an .npz the array ``key`` (else its
    only array)."""
    import numpy as np

    data = np.load(path)
    if isinstance(data, np.ndarray):
        return data
    if key in data:
        return data[key]
    if len(data.files) == 1:
        return data[data.files[0]]
    raise KeyError(f"{path}: expected array {key!r} (or a single-array "
                   f"archive); found keys {data.files}")


def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    import torch

    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("verify_models: no GPU is present; pass --cpu "
                           "for the CPU")
    seq = _load_array(args.seq, "actions")
    gt = _load_array(args.gt, "traj")
    seq = np.asarray(seq, np.float64).reshape(-1, seq.shape[-1])
    gt = np.asarray(gt, np.float64).reshape(-1, gt.shape[-1])
    adim, sdim = seq.shape[1], gt.shape[1]

    labels = args.labels or args.models
    results, trajs = [], {}
    for spec, label in zip(args.models, labels):
        model = load_model(spec, args.dt, sdim, adim, device=device)
        with torch.no_grad():
            traj = model.run_model(
                torch.as_tensor(gt[0], dtype=model.dtype, device=device),
                torch.as_tensor(seq, dtype=model.dtype, device=device))
        traj = traj.double().cpu().numpy()
        n = min(traj.shape[0], gt.shape[0])
        err = np.mean((traj[:n] - gt[:n]) ** 2, axis=0)
        results.append({"model": label,
                        "mse_per_dim": [round(float(e), 6) for e in err],
                        "mse": round(float(err.mean()), 6)})
        trajs[label] = traj
    if args.plot:
        _plot(trajs, gt, args.plot)
    print(json.dumps(results))
    return 0


def _plot(trajs, gt, path):
    """Trajectory comparison plot (test_models.py:110-127), drawn with
    matplotlib's Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    sdim = gt.shape[1]
    cols = min(sdim, 7)
    rows = (sdim + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 2.5 * rows),
                             squeeze=False)
    for d in range(sdim):
        ax = axes[d // cols][d % cols]
        ax.plot(gt[:, d], "k-", label="ground truth")
        for label, traj in trajs.items():
            n = min(traj.shape[0], gt.shape[0])
            ax.plot(traj[:n, d], "--", label=label)
        ax.set_title(f"dim {d}", fontsize=8)
    axes[0][0].legend(fontsize=6)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


if __name__ == "__main__":
    raise SystemExit(main())
