"""The port's config-driven closed loop (cfg/, envs/get_env,
envs/runner.py, cli.py) against the JAX package's: the bundled YAML
families, the model and cost a config builds, the env refusals, and the CLI
end to end on the CPU."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_tf_tpu import cli as jcli
from mppi_tf_tpu.cfg import config as jconfig
from mppi_tf_tpu.envs.runner import build_model_and_cost as jbuild
from mppi_tf_tpu_torch import cli
from mppi_tf_tpu_torch.cfg import config
from mppi_tf_tpu_torch.envs import (AUVEnv, PointMassEnv, get_env,
                                    run_experiment)
from mppi_tf_tpu_torch.envs.runner import build_model_and_cost
from mppi_tf_tpu_torch.interop import to_jax_params

PORT_DEFAULTS = Path(config._DEFAULTS_DIR)
JAX_DEFAULTS = Path(jconfig._DEFAULTS_DIR)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _names(root):
    return sorted(p.relative_to(root).with_suffix("").as_posix()
                  for p in root.rglob("*.yaml"))


def test_defaults_are_a_copy():
    assert _names(PORT_DEFAULTS) == _names(JAX_DEFAULTS)
    assert len(_names(PORT_DEFAULTS)) >= 19


@pytest.mark.parametrize("name", _names(JAX_DEFAULTS))
def test_default_config_parses_equal(name):
    assert config.default_config(name) == jconfig.default_config(name)


def test_config_helpers_match_jax(tmp_path):
    with pytest.raises(FileNotFoundError, match="available"):
        config.default_config("envs/nope")
    assert config.load_config(None) is None
    env = config.default_config("envs/point_mass")
    for over in ({"noise": 2.0, "lambda": 0.3}, {"init_act": [1, 2, 3]},
                 {"samples": None}):
        assert config.patch_config(env, **over) == jconfig.patch_config(
            env, **over)
    with pytest.raises(ValueError, match="noise"):
        config.patch_config({"samples": 10}, noise=0.5)
    path = config.write_config(env, str(tmp_path / "a" / "config.yaml"))
    assert config.load_config(path) == env == config.parse_config(path)
    config.write_config({"type": "static"}, str(tmp_path / "a" / "task.yaml"))
    cfg, task, model = config.parse_dir(str(tmp_path / "a"))
    assert (cfg, task, model) == (env, {"type": "static"}, None)
    assert (cfg, task, model) == jconfig.parse_dir(str(tmp_path / "a"))


@pytest.mark.parametrize("env,task,model", [
    ("envs/point_mass", "tasks/static_cost", "models/point_mass_model"),
    ("envs/uuv_sim", "tasks/static_cost_auv", "models/rexrov2"),
    ("envs/bluerov", "tasks/static_cost_auv", "models/bluerov"),
    ("envs/uuv_sim", "tasks/static_cost_auv", "models/auv_nn_model_quat"),
    ("envs/uuv_sim", "tasks/static_cost_auv", "models/auv_nn_model_euler")])
def test_build_model_and_cost_matches_jax(env, task, model):
    cfgs = [config.default_config(n) for n in (env, task, model)]
    pm, pc, sigma = build_model_and_cost(*cfgs, dtype=torch.float64,
                                         device="cpu")
    jm, jc, jsigma = jbuild(*cfgs, dtype=jnp.float64)
    np.testing.assert_array_equal(sigma, jsigma)
    assert type(pm).__name__ == type(jm).__name__
    assert (pm.get_state_dim(), pm.get_action_dim(), pm.dt) == (
        jm.get_state_dim(), jm.get_action_dim(), jm.dt)
    np.testing.assert_array_equal(pm.max_act().numpy(), jm.max_act())
    np.testing.assert_array_equal(pm.min_act().numpy(), jm.min_act())
    mp, cp = to_jax_params(pm, pc)
    jmp = jm.init_params()
    if "nn" in model:   # the weights differ by seed stream; the shapes not
        assert jax.tree.structure(mp) == jax.tree.structure(jmp)
        for a, b in zip(jax.tree.leaves(mp), jax.tree.leaves(jmp)):
            assert a.shape == b.shape
    else:
        for key in jmp:
            np.testing.assert_allclose(mp[key], np.asarray(jmp[key]),
                                       rtol=1e-12)
    jcp = jc.init_params()
    assert sorted(cp) == sorted(jcp)
    for key in cp:
        np.testing.assert_array_equal(cp[key], np.asarray(jcp[key]))
    np.testing.assert_array_equal(pc.Q.numpy(), np.asarray(jc.Q))
    assert (pc.lam, pc.gamma, pc.upsilon) == (jc.lam, jc.gamma, jc.upsilon)


def test_get_env_builds_and_refuses():
    env = get_env(config.default_config("envs/point_mass"))
    assert isinstance(env, PointMassEnv) and env.n_dof == 3
    rexrov2 = config.default_config("models/rexrov2")
    uuv = config.default_config("envs/uuv_sim")
    assert isinstance(get_env(uuv, model_cfg=rexrov2), AUVEnv)
    nn_cfg = config.default_config("models/auv_nn_model_quat")
    assert isinstance(get_env(dict(uuv, plant=rexrov2), model_cfg=nn_cfg),
                      AUVEnv)
    with pytest.raises(ValueError, match="learned"):
        get_env(uuv, model_cfg=nn_cfg)
    with pytest.raises(ValueError, match="vehicle parameters"):
        get_env(uuv)
    with pytest.raises(NotImplementedError, match="item 15"):
        get_env({"env": "../envs/point_mass3d.xml"})
    with pytest.raises(NotImplementedError, match="item 13"):
        get_env({"env": "jax:point_mass"})
    with pytest.raises(ValueError, match="mjx"):
        get_env({"env": "mjx:point_mass"})


def _small_point_mass(tmp_path, k=256, tau=20):
    env = dict(config.default_config("envs/point_mass"), samples=k,
               horizon=tau)
    return config.write_config(env, str(tmp_path / "env.yaml"))


def _run(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_point_mass_reaches_goal_in_both(tmp_path, capsys):
    """ROADMAP item 6's test: envs/point_mass + tasks/static_cost +
    models/point_mass_model (K=256, H=20) reaches the goal in both
    packages."""
    env = _small_point_mass(tmp_path)
    argv = ["--config", env, "--task", "tasks/static_cost", "--model",
            "models/point_mass_model", "-s", "100", "--cpu"]
    goal = np.asarray(config.default_config("tasks/static_cost")["goal"])
    port = _run(cli.main, argv, capsys)
    ref = _run(jcli.main, argv, capsys)
    assert port["kernel_path"] == "torch" and port["steps"] == 100
    assert set(ref) <= set(port)
    for out in (port, ref):
        err = np.linalg.norm(np.asarray(out["final_state"]) - goal)
        assert err < 0.1, out


def test_cli_f64_and_filter(tmp_path, capsys, monkeypatch):
    from mppi_tf_tpu_torch.controller import mppi as mppi_mod

    built = []
    orig = mppi_mod.MPPI.__init__

    def spy(self, *a, **kw):
        orig(self, *a, **kw)
        built.append(self)

    monkeypatch.setattr(mppi_mod.MPPI, "__init__", spy)
    out = _run(cli.main, ["--config", _small_point_mass(tmp_path, 64, 10),
                          "--task", "tasks/static_cost", "--model",
                          "models/point_mass_model", "-s", "3", "--f64",
                          "-f"], capsys)
    assert len(out["final_state"]) == 6
    assert built[-1]._dtype == torch.float64 and built[-1]._S is not None
    assert built[-1]._device.type == "cpu"


def test_cli_rexrov2_combo_keeps_unit_quaternion(tmp_path, capsys):
    env = dict(config.default_config("envs/uuv_sim"), samples=128,
               horizon=6)
    path = config.write_config(env, str(tmp_path / "uuv.yaml"))
    out = _run(cli.main, ["--config", path, "--task",
                          "tasks/static_cost_auv", "--model",
                          "models/rexrov2", "-s", "4", "--cpu"], capsys)
    x = np.asarray(out["final_state"])
    assert x.shape == (13,) and np.all(np.isfinite(x))
    assert abs(np.linalg.norm(x[3:7]) - 1.0) < 1e-3


def test_cli_nn_model_with_plant(tmp_path, capsys):
    """The learned model's config with a rexrov2 plant sub-dict: the NN
    controls the analytic vehicle (kernel 'auto' keeps it on the plain
    path)."""
    env = dict(config.default_config("envs/uuv_sim"), samples=64,
               horizon=5, plant=config.default_config("models/rexrov2"))
    path = config.write_config(env, str(tmp_path / "nn.yaml"))
    out = _run(cli.main, ["--config", path, "--task",
                          "tasks/static_cost_auv", "--model",
                          "models/auv_nn_model_quat", "-s", "3", "--cpu"],
               capsys)
    x = np.asarray(out["final_state"])
    assert out["kernel_path"] == "torch" and np.all(np.isfinite(x))


def test_cli_replay(tmp_path, capsys):
    logdir = tmp_path / "run"
    config.write_config(dict(config.default_config("envs/point_mass"),
                             samples=64, horizon=10),
                        str(logdir / "config.yaml"))
    config.write_config(config.default_config("tasks/static_cost"),
                        str(logdir / "task.yaml"))
    config.write_config(config.default_config("models/point_mass_model"),
                        str(logdir / "model.yaml"))
    out = _run(cli.main, ["--replay", "--log-dir", str(logdir), "-s", "2",
                          "--cpu"], capsys)
    assert out["steps"] == 2 and len(out["final_state"]) == 6


def test_cli_requires_the_three_configs(capsys):
    assert cli.main(["--config", "envs/point_mass", "--cpu"]) == 2


@pytest.mark.parametrize("flag,item", [
    (["-l"], "item 7"), (["-g"], "item 15"), (["-t", "5"], "item 11"),
    (["--on-device"], "item 13")])
def test_cli_unported_flags_raise(flag, item):
    with pytest.raises(NotImplementedError, match=item):
        cli.main(["--config", "envs/point_mass", "--task",
                  "tasks/static_cost", "--model", "models/point_mass_model",
                  "--cpu", *flag])


@pytest.mark.parametrize("kw,item", [
    ({"train_every": 5}, "item 11"), ({"on_device": True}, "item 13"),
    ({"log": True}, "item 7")])
def test_run_experiment_unported_options(kw, item):
    cfgs = [config.default_config(n) for n in (
        "envs/point_mass", "tasks/static_cost", "models/point_mass_model")]
    with pytest.raises(NotImplementedError, match=item):
        run_experiment(*cfgs, steps=1, device="cpu", **kw)


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """With no GPU, run_experiment without a device raises as MPPI does,
    and so does the CLI without --cpu."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfgs = [config.default_config(n) for n in (
        "envs/point_mass", "tasks/static_cost", "models/point_mass_model")]
    with pytest.raises(RuntimeError, match="no GPU"):
        run_experiment(*cfgs, steps=1)
    with pytest.raises(RuntimeError, match="no GPU"):
        cli.main(["--config", _small_point_mass(tmp_path, 16, 4), "--task",
                  "tasks/static_cost", "--model", "models/point_mass_model",
                  "-s", "1"])


def test_run_experiment_on_cpu_returns_histories():
    cfgs = [config.default_config(n) for n in (
        "envs/point_mass", "tasks/static_cost", "models/point_mass_model")]
    cfgs[0] = dict(cfgs[0], samples=32, horizon=5)
    out = run_experiment(*cfgs, steps=3, device="cpu", seed=2)
    assert out["states"].shape == (4, 6) and out["actions"].shape == (3, 3)
    assert out["controller"].timing["calls"] == 3
    assert out["observer"] is None and out["learner"] is None


#: the four tracking tasks of the bundled configs: env, task, model and the
#: env patch the combination needs (the ellipse is 2D: a 2-DoF point mass)
TRACKING = [
    ("envs/point_mass", "tasks/waypoints_task", "models/point_mass_model",
     {}),
    ("envs/point_mass", "tasks/elipse_task", "models/point_mass_model",
     {"state-dim": 4, "action-dim": 2, "init-act": [0.0, 0.0],
      "max-a": [1.0, 1.0], "noise": [[0.25, 0.0], [0.0, 0.25]]}),
    ("envs/uuv_sim", "tasks/waypoints_quat_task", "models/rexrov2", {}),
    ("envs/bluerov", "tasks/elipse3d_task", "models/rexrov2", {}),
]


@pytest.mark.parametrize("env,task,model,patch", TRACKING,
                         ids=[t[1].split("/")[1] for t in TRACKING])
def test_cli_tracking_tasks_run_on_cpu(tmp_path, capsys, env, task, model,
                                       patch):
    """Each tracking task runs through the port's CLI (``--cpu``, K=64,
    H=8, 5 steps): finite states of the env's size, a unit quaternion for
    the AUV; the model and cost the config builds are the JAX package's."""
    env_cfg = dict(config.default_config(env), samples=64, horizon=8,
                   **patch)
    path = config.write_config(env_cfg, str(tmp_path / "env.yaml"))
    out = _run(cli.main, ["--config", path, "--task", task, "--model", model,
                          "-s", "5", "--cpu"], capsys)
    x = np.asarray(out["final_state"])
    assert out["kernel_path"] == "torch" and out["steps"] == 5
    assert x.shape == (env_cfg["state-dim"],) and np.all(np.isfinite(x))
    if x.shape == (13,):
        assert abs(np.linalg.norm(x[3:7]) - 1.0) < 1e-3
    cfgs = [env_cfg] + [config.default_config(n) for n in (task, model)]
    _, pc, _ = build_model_and_cost(*cfgs, dtype=torch.float64, device="cpu")
    _, jc, _ = jbuild(*cfgs, dtype=jnp.float64)
    assert type(pc).__name__ == type(jc).__name__
    cp = {n: b.numpy() for n, b in pc.params().items()}
    jcp = jc.init_params()
    assert sorted(cp) == sorted(jcp)
    for key in cp:
        np.testing.assert_array_equal(cp[key], np.asarray(jcp[key]))
