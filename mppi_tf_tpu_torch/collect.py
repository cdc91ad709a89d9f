"""Random-policy transition collection, and optional model training on
the collected data.

Reference: scripts/src/mujoco/save_rng_sim.py — drive the environment with
random actions, store (x, u, x') transitions in the replay buffer, save
them, and optionally train the NN dynamics model on them; the JAX
package's ``mppi_tf_tpu/collect.py`` is the port's reference. Actions are
uniform within the env config's ``max-a``, drawn from
``np.random.default_rng(seed)`` (the JAX package's stream, so both
collect the same transitions). Training (``--train``) runs on the card
unless ``--cpu``.

Usage:
    python -m mppi_tf_tpu_torch.collect --config envs/point_mass \\
        --model models/nn_model -n 2000 --out transitions.npz --train 50
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def collect_transitions(env, buffer, steps: int, a_dim: int, act_low,
                        act_high, seed: int = 0, control_dt: float = 0.1):
    """Step ``env`` with uniform random actions for ``steps`` control
    steps of ``control_dt`` (the runner's sim/control rate decoupling),
    adding each transition to ``buffer``; returns the buffer."""
    rng = np.random.default_rng(seed)
    x = env.getState()
    for _ in range(steps):
        u = rng.uniform(act_low, act_high, size=(a_dim,))
        prev = env.getTime()
        x_next = x
        while env.getTime() - prev < control_dt - 1e-12:
            x_next = env.step(np.reshape(u, (1, -1)), goal=env.getGoal())
        buffer.add(np.reshape(x, (-1, 1)), np.reshape(u, (-1, 1)),
                   np.reshape(x_next, (-1, 1)))
        x = x_next
    return buffer


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", required=True, help="env config name or path")
    p.add_argument("--model", default=None,
                   help="NN model config to train on the collected data")
    p.add_argument("-n", "--steps", type=int, default=1000)
    p.add_argument("--out", default="transitions.npz")
    p.add_argument("--train", type=int, default=0,
                   help="training epochs after collection (needs --model)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="train on the CPU instead of the card")
    args = p.parse_args(argv)

    from .cfg import load_config
    from .envs import get_env
    from .learning.replay import ReplayBuffer

    env_cfg = load_config(args.config)
    sdim = env_cfg.get("state-dim", 2)
    adim = env_cfg.get("action-dim", 1)
    dt = env_cfg.get("dt", 0.1)
    env = get_env(env_cfg, render=False)
    buf = ReplayBuffer(max(args.steps, 1), sdim, adim)
    max_u = np.broadcast_to(
        np.asarray(env_cfg.get("max-a", 1.0), np.float64).reshape(-1),
        (adim,))
    collect_transitions(env, buf, args.steps, adim, -max_u, max_u,
                        seed=args.seed, control_dt=dt)
    buf.save_transitions(args.out)

    summary = {"collected": len(buf), "out": args.out}
    if args.train and args.model:
        import torch

        from .learning import Learner
        from .models import get_model

        device = "cpu" if args.cpu else "cuda"
        if device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("collect --train: no GPU is present; pass "
                               "--cpu to train on the CPU")
        model = get_model(load_config(args.model), dt=dt, state_dim=sdim,
                          action_dim=adim, device=device)
        learner = Learner(model)
        data = buf.get_all_transitions()
        for x, u, xn in zip(data["obs"], data["act"], data["next_obs"]):
            learner.add_rb(x, u, xn)
        learner.stats()
        summary["final_loss"] = learner.train_all(epoch=args.train)
        summary["device"] = device
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
