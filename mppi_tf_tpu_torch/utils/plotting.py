"""Plot / GIF experiment artifacts.

The port of the JAX package's ``utils/plotting.py``: host numpy and
matplotlib, the same six functions. Reference: scripts/src/misc/utile.py,
the per-step path / weight / noise matplotlib dumps (:77-121), the
Savitzky-Golay filter sweep plot (:62-75) and the GIF assembly with
imageio (:124-133); the trajectory comparisons of
scripts/src/misc/test_models.py are ``verify_models``'s plots. Every
function runs on the host and imports matplotlib (Agg backend) and imageio
when called, so importing the module needs neither and headless jobs can
call them.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_trajectory(states, goal=None, path: str = "trajectory.png",
                    pos_dims: Sequence[int] = (0, 2), title: str = ""):
    """Closed-loop path in the plane of ``pos_dims`` with start/goal markers.

    Reference: utile.py:77-99 (plt_paths per-step scatter; here one figure
    for the whole run — per-step frames come from :func:`save_step_frames`).
    """
    plt = _plt()
    states = np.asarray(states)
    i, j = pos_dims
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.plot(states[:, i], states[:, j], "b.-", ms=3, lw=0.8, label="path")
    ax.plot(states[0, i], states[0, j], "go", label="start")
    if goal is not None:
        goal = np.asarray(goal)
        ax.plot(goal[i], goal[j], "r*", ms=12, label="goal")
    ax.set_xlabel(f"state[{i}]")
    ax.set_ylabel(f"state[{j}]")
    ax.set_title(title or "closed-loop trajectory")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path


def save_step_frames(states, frame_dir: str, goal=None,
                     pos_dims: Sequence[int] = (0, 2),
                     weights_per_step=None, noises_per_step=None):
    """Write one PNG per control step: the path so far plus (optionally)
    the sample-weight histogram and applied-noise histogram for that step.

    Reference: utile.py:77-121 (plt_paths: path scatter + weight plot +
    noise histogram per step, dumped to to_gif/). Returns the frame paths.
    """
    plt = _plt()
    os.makedirs(frame_dir, exist_ok=True)
    states = np.asarray(states)
    i, j = pos_dims
    n = len(states)
    paths = []
    have_w = weights_per_step is not None
    have_n = noises_per_step is not None
    ncols = 1 + int(have_w) + int(have_n)
    for t in range(1, n):
        fig, axes = plt.subplots(1, ncols, figsize=(4 * ncols, 3.5))
        axes = np.atleast_1d(axes)
        ax = axes[0]
        ax.plot(states[:t + 1, i], states[:t + 1, j], "b.-", ms=3, lw=0.8)
        ax.plot(states[t, i], states[t, j], "bo")
        if goal is not None:
            g = np.asarray(goal)
            ax.plot(g[i], g[j], "r*", ms=12)
        ax.set_xlim(states[:, i].min() - 0.2, states[:, i].max() + 0.2)
        ax.set_ylim(states[:, j].min() - 0.2, states[:, j].max() + 0.2)
        ax.set_title(f"step {t}")
        ax.grid(alpha=0.3)
        c = 1
        if have_w:
            w = np.asarray(weights_per_step[t - 1]).reshape(-1)
            axes[c].hist(w, bins=50)
            axes[c].set_title("sample weights")
            axes[c].set_yscale("log")
            c += 1
        if have_n:
            eps = np.asarray(noises_per_step[t - 1]).reshape(-1)
            axes[c].hist(eps, bins=50)
            axes[c].set_title("weighted noise")
        fig.tight_layout()
        p = os.path.join(frame_dir, f"frame_{t:05d}.png")
        fig.savefig(p, dpi=80)
        plt.close(fig)
        paths.append(p)
    return paths


def to_gif(frame_paths: Sequence[str], out_path: str = "run.gif",
           fps: int = 10) -> Optional[str]:
    """Assemble PNG frames into a GIF. Reference: utile.py:124-133.

    Returns out_path, or None if imageio is unavailable.
    """
    try:
        import imageio.v2 as imageio
    except ImportError:  # pragma: no cover
        return None
    frames = [imageio.imread(p) for p in frame_paths]
    imageio.mimsave(out_path, frames, fps=fps)
    return out_path


def plot_filter_sweep(seq, windows=(5, 9, 15, 21), polyorder: int = 3,
                      path: str = "filter_sweep.png"):
    """Savitzky-Golay smoothing sweep over an action sequence.

    Reference: utile.py:62-75 (plt_sgf_to_file): overlay the raw sequence
    with filtered versions for several window lengths to pick filter_window.
    """
    from scipy.signal import savgol_filter

    plt = _plt()
    seq = np.asarray(seq)
    if seq.ndim == 1:
        seq = seq[:, None]
    tau, adim = seq.shape
    fig, axes = plt.subplots(adim, 1, figsize=(6, 2.2 * adim), squeeze=False)
    for d in range(adim):
        ax = axes[d, 0]
        ax.plot(seq[:, d], "k-", lw=1.5, label="raw")
        for w in windows:
            if w >= tau or w <= polyorder:
                continue
            ax.plot(savgol_filter(seq[:, d], w, polyorder), "--",
                    label=f"window={w}")
        ax.set_ylabel(f"u[{d}]")
        ax.grid(alpha=0.3)
        if d == 0:
            ax.legend(ncol=2, fontsize=8)
    axes[-1, 0].set_xlabel("t")
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path


def plot_trajectory_3d(states, goal=None, path: str = "trajectory3d.png",
                       pos_dims: Sequence[int] = (0, 1, 2),
                       heading_quat_dims: Optional[Sequence[int]] = None,
                       title: str = ""):
    """3D path with start/goal markers and optional heading arrows.

    Reference: utile.py:19-29 (Arrow3D) + the 3D branches of plt_paths —
    used for AUV / ellipse-3D tasks. ``heading_quat_dims``: indices of the
    xyzw quaternion block (e.g. (3, 4, 5, 6) for the AUV state) to draw
    body-x heading arrows every few steps.
    """
    plt = _plt()
    states = np.asarray(states)
    i, j, k = pos_dims
    fig = plt.figure(figsize=(6, 5))
    ax = fig.add_subplot(111, projection="3d")
    ax.plot(states[:, i], states[:, j], states[:, k], "b.-", ms=3, lw=0.8,
            label="path")
    ax.scatter(*states[0, [i, j, k]], color="g", s=40, label="start")
    if goal is not None:
        g = np.asarray(goal)
        ax.scatter(g[i], g[j], g[k], color="r", marker="*", s=120,
                   label="goal")
    if heading_quat_dims is not None:
        qi = list(heading_quat_dims)
        stride = max(len(states) // 12, 1)
        for t in range(0, len(states), stride):
            qx, qy, qz, qw = states[t, qi]
            # body-x axis in world frame (first column of R(q))
            hx = 1 - 2 * (qy * qy + qz * qz)
            hy = 2 * (qx * qy + qz * qw)
            hz = 2 * (qx * qz - qy * qw)
            s = 0.15 * max(np.ptp(states[:, [i, j, k]], axis=0).max(), 1e-6)
            ax.quiver(states[t, i], states[t, j], states[t, k],
                      s * hx, s * hy, s * hz, color="m", lw=1.2)
    ax.set_xlabel(f"state[{i}]")
    ax.set_ylabel(f"state[{j}]")
    ax.set_zlabel(f"state[{k}]")
    ax.set_title(title or "3D trajectory")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path


def run_to_gif(states, out_path: str = "run.gif", goal=None,
               pos_dims: Sequence[int] = (0, 2), fps: int = 10,
               weights_per_step=None, noises_per_step=None):
    """One-call helper: frames + gif for a finished closed-loop run
    (the reference's --gif flag flow, main.py gif handling)."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        frames = save_step_frames(states, d, goal=goal, pos_dims=pos_dims,
                                  weights_per_step=weights_per_step,
                                  noises_per_step=noises_per_step)
        return to_gif(frames, out_path, fps=fps)
