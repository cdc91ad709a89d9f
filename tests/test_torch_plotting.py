"""The port's plot / GIF utilities (``mppi_tf_tpu_torch/utils/
plotting.py``): the cases of tests/test_plotting.py, the port's figures
beside the JAX package's (the same plots from the same data), and the
CLI's ``-g`` on the CPU in both packages."""

import json
import os

import numpy as np
import pytest

from mppi_tf_tpu import cli as jcli
from mppi_tf_tpu.utils import plotting as jplotting
from mppi_tf_tpu_torch import cli
from mppi_tf_tpu_torch.cfg import config
from mppi_tf_tpu_torch.utils import plotting


def _fake_run(n=6):
    t = np.linspace(0, 1, n)
    return np.stack([t, np.zeros(n), t ** 2, np.zeros(n), -t, np.zeros(n)],
                    axis=1)


def test_plot_trajectory(tmp_path):
    p = plotting.plot_trajectory(_fake_run(), goal=[1, 0, 1, 0, -1, 0],
                                 path=str(tmp_path / "traj.png"))
    assert os.path.exists(p) and os.path.getsize(p) > 1000


def test_step_frames_and_gif(tmp_path):
    states = _fake_run()
    rng = np.random.default_rng(0)
    w = [rng.random(32) for _ in range(len(states) - 1)]
    eps = [rng.standard_normal((10, 3)) for _ in range(len(states) - 1)]
    frames = plotting.save_step_frames(states, str(tmp_path / "frames"),
                                       goal=[1, 0, 1, 0, -1, 0],
                                       weights_per_step=w,
                                       noises_per_step=eps)
    assert len(frames) == len(states) - 1
    gif = plotting.to_gif(frames, str(tmp_path / "run.gif"), fps=5)
    assert gif is not None and os.path.getsize(gif) > 1000


def test_run_to_gif(tmp_path):
    gif = plotting.run_to_gif(_fake_run(), str(tmp_path / "r.gif"),
                              goal=[1, 0, 1, 0, -1, 0])
    assert gif is not None and os.path.exists(gif)


def test_filter_sweep(tmp_path):
    seq = np.cumsum(np.random.default_rng(1).standard_normal((30, 2)),
                    axis=0)
    p = plotting.plot_filter_sweep(seq, path=str(tmp_path / "sgf.png"))
    assert os.path.exists(p) and os.path.getsize(p) > 1000


def test_plot_trajectory_3d(tmp_path):
    n = 8
    t = np.linspace(0, 1, n)
    states = np.zeros((n, 13))
    states[:, 0], states[:, 1], states[:, 2] = t, t ** 2, -t
    states[:, 6] = 1.0
    p = plotting.plot_trajectory_3d(
        states, goal=[1, 1, -1] + [0] * 10, path=str(tmp_path / "t3.png"),
        heading_quat_dims=(3, 4, 5, 6))
    assert os.path.exists(p) and os.path.getsize(p) > 1000


@pytest.mark.parametrize("name,args", [
    ("plot_trajectory", lambda: (_fake_run(),)),
    ("plot_filter_sweep", lambda: (np.cumsum(np.linspace(-1, 1, 40).reshape(
        20, 2), axis=0),))])
def test_figures_equal_the_jax_packages(tmp_path, name, args):
    """The same function on the same data draws the same image in both
    packages (identical PNG bytes: matplotlib's Agg output is
    deterministic)."""
    paths = []
    for mod, side in ((plotting, "port"), (jplotting, "jax")):
        paths.append(getattr(mod, name)(*args(),
                                        path=str(tmp_path / f"{side}.png")))
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()


def test_cli_gif_in_both_packages(tmp_path, monkeypatch, capsys):
    """-g on the CPU: both CLIs write run.gif (working directory without
    -l) and report it under the same key."""
    env = config.write_config(dict(config.default_config("envs/point_mass"),
                                   samples=64, horizon=10),
                              str(tmp_path / "env.yaml"))
    argv = ["--config", env, "--task", "tasks/static_cost", "--model",
            "models/point_mass_model", "-s", "3", "--cpu", "-g"]
    outs = {}
    for side, main in (("port", cli.main), ("jax", jcli.main)):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        assert main(argv) == 0
        outs[side] = json.loads(capsys.readouterr().out.strip()
                                .splitlines()[-1])
        gif = tmp_path / side / "run.gif"
        assert gif.stat().st_size > 1000
        assert os.path.abspath(outs[side]["gif"]) == str(gif)
    assert set(outs["jax"]) <= set(outs["port"])
