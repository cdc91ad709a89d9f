"""The port's model-based RL loop (collect.py, the runner's learner hook,
run_experiment(train_every=), the CLI's -t, verify_models.py) against the
JAX package's on the CPU, and chip_smoke.py's mbrl phase at K=1,024 in
both packages: the readings of its dives set that phase's gate."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (AUV_GAMMA, AUV_LAM, AUV_UPSILON, COST_RTOL,
                        MBRL_BUFFER,
                        MBRL_EPOCHS, MBRL_LOOP_TOL, MBRL_LR, MBRL_MSE_SHARE,
                        MBRL_SEED, MBRL_TRAIN_EVERY, NN_H, NN_LOOP_SIGMA,
                        NN_LOOP_STEPS, KnownPlant, known_plant_task,
                        mbrl_collect)
from mppi_tf_tpu import cli as jcli
from mppi_tf_tpu import verify_models as jverify
from mppi_tf_tpu.collect import collect_transitions as jcollect
from mppi_tf_tpu.controller.mppi import MPPI as JMPPI
from mppi_tf_tpu.costs import get_cost as jget_cost
from mppi_tf_tpu.envs import get_env as jget_env
from mppi_tf_tpu.envs.runner import ClosedLoopRunner as JRunner
from mppi_tf_tpu.learning import Learner as JLearner
from mppi_tf_tpu.learning.checkpoint import save_checkpoint as jsave
from mppi_tf_tpu.learning.replay import ReplayBuffer as JReplayBuffer
from mppi_tf_tpu.models.nn import NNAUVModel as JNNAUVModel
from mppi_tf_tpu.models.nn import NNModel as JNNModel
from mppi_tf_tpu_torch import cli, collect, verify_models
from mppi_tf_tpu_torch.cfg import config
from mppi_tf_tpu_torch.controller import MPPI
from mppi_tf_tpu_torch.costs import get_cost
from mppi_tf_tpu_torch.envs import get_env, run_experiment
from mppi_tf_tpu_torch.envs.runner import ClosedLoopRunner
from mppi_tf_tpu_torch.interop import (_flatten, from_jax_params,
                                       to_jax_params)
from mppi_tf_tpu_torch.learning import Learner, ReplayBuffer
from mppi_tf_tpu_torch.learning.checkpoint import save_checkpoint
from mppi_tf_tpu_torch.models.nn import NNAUVModel, NNModel
from tests.test_torch_learner import _assert_params, _inject_augmentation

PM_ENV = {"env": "analytic:point_mass", "state-dim": 2, "action-dim": 1,
          "dt": 0.1, "max-a": [1.0], "samples": 64, "horizon": 10,
          "lambda": 0.6, "upsilon": 1.0, "noise": [[0.4]]}
PM_TASK = {"type": "static", "diag": True, "goal": [1.0, 0.0],
           "Q": [8.0, 1.5], "lambda": 0.6, "gamma": 0.2, "upsilon": 1.0}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_collect_transitions_matches_jax():
    """The same env config and seed: the same transitions (both draw
    np.random.default_rng), chained, within the action bounds."""
    env_cfg = {"env": "analytic:point_mass", "state-dim": 6,
               "action-dim": 3, "dt": 0.1, "max-a": [1.0, 1.0, 1.0]}
    buf, jbuf = ReplayBuffer(64, 6, 3), JReplayBuffer(64, 6, 3)
    collect.collect_transitions(get_env(env_cfg), buf, 20, 3, -1.0, 1.0,
                                seed=1, control_dt=0.1)
    jcollect(jget_env(env_cfg, render=False), jbuf, 20, 3, -1.0, 1.0,
             seed=1, control_dt=0.1)
    data, jdata = buf.get_all_transitions(), jbuf.get_all_transitions()
    assert len(buf) == 20 and data["obs"].shape == (20, 6)
    assert np.all(np.abs(data["act"]) <= 1.0)
    np.testing.assert_allclose(data["next_obs"][:-1], data["obs"][1:])
    for key in data:
        np.testing.assert_allclose(data[key], jdata[key], rtol=1e-12,
                                   atol=1e-14)


def test_collect_cli_trains_on_the_cpu(tmp_path, capsys):
    out = str(tmp_path / "tr.npz")
    assert collect.main(["--config", "envs/point_mass", "--model",
                         "models/nn_model", "-n", "40", "--out", out,
                         "--train", "5", "--cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["collected"] == 40 and summary["device"] == "cpu"
    assert np.isfinite(summary["final_loss"])
    with np.load(out) as data:
        assert data["obs"].shape == (40, 6)


class _Scripted:
    """A controller stand-in that plays a fixed action sequence and keeps
    what the runner writes to ``model_params``."""

    def __init__(self, actions):
        self._actions = iter(actions)
        self.writes = []

    def next(self, x):
        return next(self._actions)

    @property
    def model_params(self):
        return self.writes[-1]

    @model_params.setter
    def model_params(self, params):
        self.writes.append(params)


def test_runner_hook_matches_jax():
    """The runner's learner hook over the same plant and actions (augment-
    ation injected): 3 refits, each written to the controller, the learned
    params equal to the JAX runner's at every write."""
    actions = np.random.default_rng(9).uniform(-1, 1, size=(15, 1))
    jm = JNNModel(state_dim=2, action_dim=1, hidden=(16, 16),
                  dtype=jnp.float64)
    model = NNModel(state_dim=2, action_dim=1, hidden=(16, 16),
                    dtype=torch.float64)
    from_jax_params(jax.tree.map(np.asarray, jm.init_params()), None, model)
    args = dict(num_epochs=30, learning_rate=1e-2)
    jl, pl = JLearner(jm, **args), Learner(model, device="cpu", **args)
    _inject_augmentation(jl, pl)
    jc, pc = _Scripted(list(actions)), _Scripted(list(actions))
    JRunner(jget_env(PM_ENV, render=False), jc, 0.1, learner=jl,
            train_every=5).run(15)
    ClosedLoopRunner(get_env(PM_ENV), pc, 0.1, learner=pl,
                     train_every=5).run(15)
    assert len(pl.rb) == len(jl.rb) == 15
    assert len(pc.writes) == len(jc.writes) == 3
    for ours, theirs in zip(pc.writes, jc.writes):
        _assert_params(theirs, ours)
    _assert_params(jl.params, pl.params)


def test_run_experiment_train_every_analytic_model():
    """tests/test_mbrl_e2e.py:77-99 on the port: the learner fits the
    point mass's mass online and the controller rolls out with it."""
    out = run_experiment(PM_ENV, PM_TASK, {"type": "point_mass",
                                           "mass": 1.0},
                         steps=12, train_every=5, device="cpu")
    learner, ctrl = out["learner"], out["controller"]
    assert learner is not None and len(learner.rb) >= 12
    assert learner.model is not ctrl._model
    assert np.all(np.isfinite(out["states"]))
    assert float(ctrl.model_params["mass"]) == float(learner.params["mass"])
    assert float(learner.params["mass"]) != 1.0


def test_cli_train_flag_logs_training(tmp_path, capsys):
    """-t 5 with -l: two refits through the CLI, each logging its epochs
    (Train/loss_norm) into the experiment's JSONL."""
    env = str(tmp_path / "pm.yaml")
    config.write_config(dict(config.default_config("envs/point_mass"),
                             samples=64, horizon=10), env)
    assert cli.main(["--config", env, "--task", "tasks/static_cost",
                     "--model", "models/point_mass_model", "-s", "10",
                     "-t", "5", "-l", "--log-dir", str(tmp_path / "logs"),
                     "--cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["steps"] == 10
    with open(f"{summary['logdir']}/metrics.jsonl") as f:
        tags = [k for line in f for k in json.loads(line) if k != "step"]
    assert tags.count("Train/loss_norm") == 2 * 100


def _seq_and_gt(tmp_path):
    """A [10, 6] action sequence and the f64 trajectory of the mass-5
    point mass under it (the bundled point_mass_model)."""
    from mppi_tf_tpu.models import get_model as jget_model

    rng = np.random.default_rng(0)
    seq = rng.normal(size=(10, 3))
    m = jget_model({"type": "point_mass", "mass": 5.0}, dt=0.1,
                   state_dim=6, action_dim=3, dtype=jnp.float64)
    traj = np.asarray(m.run_model(m.init_params(), jnp.zeros(6),
                                  jnp.asarray(seq)))
    traj = traj + 0.01 * rng.normal(size=traj.shape)
    np.save(tmp_path / "seq.npy", seq)
    np.savez(tmp_path / "gt.npz", traj=traj)
    return str(tmp_path / "seq.npy"), str(tmp_path / "gt.npz")


def _mse(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_verify_models_config_matches_jax(tmp_path, capsys):
    seq, gt = _seq_and_gt(tmp_path)
    plot = tmp_path / "cmp.png"
    argv = ["--cpu", "--models", "models/point_mass_model", "--seq", seq,
            "--gt", gt]
    ours = _mse(verify_models.main, argv + ["--plot", str(plot)], capsys)
    theirs = _mse(jverify.main, argv, capsys)
    assert plot.exists()
    assert ours[0]["model"] == "models/point_mass_model"
    np.testing.assert_allclose(ours[0]["mse_per_dim"],
                               theirs[0]["mse_per_dim"], rtol=1e-4,
                               atol=2e-6)


def test_verify_models_logdir_matches_jax(tmp_path, capsys):
    """Learner logdirs holding the same NN weights (the port's npz, the
    JAX package's own checkpoint) give the same MSE: the latest
    weights_step wins in both."""
    seq, gt = _seq_and_gt(tmp_path)
    jm = JNNModel(state_dim=6, action_dim=3, hidden=(32, 32, 32),
                  dtype=jnp.float64)
    params = jax.tree.map(np.asarray, jm.init_params())
    params["y_std"] = np.full(6, 0.05)
    stale = jax.tree.map(lambda a: a * 0.0, params)
    for pkg, save in (("port", save_checkpoint), ("jax", jsave)):
        d = tmp_path / pkg
        d.mkdir()
        save(str(d / "weights_step5"), stale)
        save(str(d / "weights_step20"), params)
        (d / "model.yaml").write_text("type: neural_net\n")
    ours = _mse(verify_models.main, ["--cpu", "--models",
                                     str(tmp_path / "port"), "--seq", seq,
                                     "--gt", gt], capsys)
    theirs = _mse(jverify.main, ["--cpu", "--models", str(tmp_path / "jax"),
                                 "--seq", seq, "--gt", gt], capsys)
    np.testing.assert_allclose(ours[0]["mse_per_dim"],
                               theirs[0]["mse_per_dim"], rtol=1e-4,
                               atol=2e-6)
    assert ours[0]["mse"] > 0.0


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        collect.main(["--config", "envs/point_mass", "--model",
                      "models/nn_model", "-n", "4", "--out",
                      str(tmp_path / "t.npz"), "--train", "1"])
    seq, gt = _seq_and_gt(tmp_path)
    with pytest.raises(RuntimeError, match="no GPU"):
        verify_models.main(["--models", "models/point_mass_model", "--seq",
                            seq, "--gt", gt])


# ---------------------------------------------------------------------------
# chip_smoke.py's mbrl phase at K=1,024 in both packages
# ---------------------------------------------------------------------------
def _one_step(predict, data) -> tuple:
    """(one-step MSE of ``predict`` on the buffer, the stay-put MSE)."""
    pred = predict(data["obs"], data["act"])
    return (float(np.mean((pred - data["next_obs"]) ** 2)),
            float(np.mean((data["obs"] - data["next_obs"]) ** 2)))


def _port_dives(plant):
    model = NNAUVModel(hidden=(32, 32, 32), seed=MBRL_SEED)
    learner = Learner(model)
    # copies: to_jax_params's arrays share the tensors' memory, which
    # the training below updates in place
    init = jax.tree.map(np.copy, to_jax_params(learner.model)[0])
    mbrl_collect(collect.collect_transitions, plant, learner.rb)
    data = learner.rb_trans()
    learner.stats()
    learner.train_all(epoch=MBRL_EPOCHS, learning_rate=MBRL_LR)

    def predict(x, u):
        with torch.no_grad():
            return learner.model.step(torch.tensor(x, dtype=torch.float32),
                                      torch.tensor(u, dtype=torch.float32)
                                      ).double().numpy()

    fit = _one_step(predict, data)
    cost = get_cost(known_plant_task(), lam=AUV_LAM, gamma=AUV_GAMMA,
                    upsilon=AUV_UPSILON, sigma=NN_LOOP_SIGMA)
    errs = []
    for normalize in (False, True):
        ctrl = MPPI(NNAUVModel(), cost, k=1024, tau=NN_H, lam=AUV_LAM,
                    upsilon=AUV_UPSILON, sigma=NN_LOOP_SIGMA, seed=3,
                    normalize_cost=normalize, device="cpu")
        ctrl.model_params = learner.params
        plant.reset()
        states, _ = ClosedLoopRunner(
            plant, ctrl, plant.dt, learner=learner,
            train_every=MBRL_TRAIN_EVERY).run(NN_LOOP_STEPS)
        errs.append((states, ctrl))
    return init, data, fit, errs


def _jax_dives(plant, init, data):
    jm = JNNAUVModel(hidden=(32, 32, 32), dtype=jnp.float32)
    learner = JLearner(jm)
    learner.params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                                  init)
    mbrl_collect(jcollect, plant, learner.rb)
    jdata = learner.rb_trans()
    for key in data:
        np.testing.assert_array_equal(jdata[key], data[key])
    learner.stats()
    learner.train_all(epoch=MBRL_EPOCHS, learning_rate=MBRL_LR)

    def predict(x, u):
        return np.asarray(jm.step(learner.params, jnp.asarray(x, jnp.float32),
                                  jnp.asarray(u, jnp.float32)), np.float64)

    fit = _one_step(predict, jdata)
    cost = jget_cost(known_plant_task(), lam=AUV_LAM, gamma=AUV_GAMMA,
                     upsilon=AUV_UPSILON, sigma=NN_LOOP_SIGMA)
    errs = []
    for normalize in (False, True):
        ctrl = JMPPI(jm, cost, k=1024, tau=NN_H, lam=AUV_LAM,
                     upsilon=AUV_UPSILON, sigma=NN_LOOP_SIGMA, seed=3,
                     normalize_cost=normalize)
        ctrl.model_params = learner.params
        plant.reset()
        states, _ = JRunner(plant, ctrl, plant.dt, learner=learner,
                            train_every=MBRL_TRAIN_EVERY).run(NN_LOOP_STEPS)
        errs.append((states, ctrl))
    return fit, errs


def test_mbrl_dives_in_both_packages():
    """chip_smoke.py's mbrl phase at K=1,024 on the CPU (the port on its
    torch route, the JAX package on its XLA path), from the same init and
    the same 264 transitions: the learned model beats a tenth of the
    stay-put error, and each dive (unnormalized, then normalized, refits
    every 20 steps) ends within MBRL_LOOP_TOL of z = -1 with |q| = 1."""
    plant = KnownPlant()
    init, data, fit, dives = _port_dives(plant)
    assert len(data["obs"]) == MBRL_BUFFER
    jfit, jdives = _jax_dives(plant, init, data)
    readings = {}
    for pkg, (mse, base), runs in (("port", fit, dives),
                                   ("jax", jfit, jdives)):
        readings[pkg] = {"mse": mse, "stay_put": base, "z_err": [
            abs(float(s[-1, 2]) + 1.0) for s, _ in runs]}
    print("mbrl readings", readings)
    for pkg, r in readings.items():
        assert r["mse"] < MBRL_MSE_SHARE * r["stay_put"], (pkg, r)
        assert max(r["z_err"]) < MBRL_LOOP_TOL, (pkg, r)
    for states, _ in dives + jdives:
        assert np.all(np.isfinite(states))
        assert np.abs(np.linalg.norm(states[:, 3:7], axis=1) - 1).max() \
            < 1e-3


@pytest.mark.parametrize("episodes", [1, "chip_smoke"])
def test_fold_of_a_constant_feature(episodes):
    """The fused NN solve does not fold the normalisers into the first
    layer (W / x_std, b - (x_mean / x_std) W, as the JAX package's
    FusedNNMPPI.pack_dyn does): learned from one episode of the known
    plant, the quaternion features are constant, stats() sets their std
    to 1e-8, and the folded costs lost the first layer to cancellation
    (207% from the model's rollout). The kernels normalise the features in
    f32 instead, so their plain version (f32) agrees with the model's own
    rollout within COST_RTOL on one episode's weights as on chip_smoke's
    episodes at random attitudes (ROADMAP §3)."""
    from mppi_tf_tpu_torch.kernels import nn_mppi as nnk

    plant = KnownPlant()
    learner = Learner(NNAUVModel(seed=MBRL_SEED))
    if episodes == 1:
        lim = 10.0 * np.ones(6)
        collect.collect_transitions(plant, learner.rb, MBRL_BUFFER, 6, -lim,
                                    lim, seed=1, control_dt=plant.dt)
    else:
        mbrl_collect(collect.collect_transitions, plant, learner.rb)
    learner.stats()
    learner.train_all(epoch=MBRL_EPOCHS, learning_rate=MBRL_LR)
    cost = get_cost(known_plant_task(), lam=AUV_LAM, gamma=AUV_GAMMA,
                    upsilon=AUV_UPSILON, sigma=NN_LOOP_SIGMA)
    ctrl = MPPI(NNAUVModel(), cost, k=512, tau=NN_H, lam=AUV_LAM,
                upsilon=AUV_UPSILON, sigma=NN_LOOP_SIGMA, device="cpu")
    ctrl.model_params = learner.params
    fused = nnk.FusedNNMPPI(ctrl._model, cost, k=512, tau=NN_H, lam=AUV_LAM,
                            upsilon=AUV_UPSILON, sigma=NN_LOOP_SIGMA)
    rng = np.random.default_rng(3)
    z = torch.as_tensor(rng.standard_normal((NN_H, 6, 512)),
                        dtype=torch.float32)
    useq = torch.as_tensor(5.0 * rng.standard_normal((NN_H, 6)),
                           dtype=torch.float32)
    x0 = torch.as_tensor(KnownPlant().reset().ravel(), dtype=torch.float32)
    with torch.no_grad():
        kern = nnk.sample_costs_plain(fused.consts,
                                      fused.pack_dyn(x0, useq), z)
        own = ctrl._rollout(x0, useq, torch.einsum("ij,tjk->kti",
                                                   fused._scale, z))
    rel = ((kern - own).abs() / own.abs()).max().item()
    print(f"episodes {episodes}: min x_std "
          f"{learner.model.x_std.min().item():.3g}, the kernels' costs vs "
          f"the model's rollout: max relative error {rel:.3g}")
    if episodes == 1:
        assert learner.model.x_std[:4].max().item() < 1e-7
    assert rel < COST_RTOL
