"""Log mode of the port: its observer (mppi_tf_tpu_torch/observer) against
the JAX package's on the same inputs, ``MPPI(observer=...)`` with
``save``, ``run_experiment(log=True)`` and ``cli -l`` in both packages,
``dump_hlo`` and the warm-up state of ``trace`` and ``profile``."""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_tf_tpu import cli as jcli
from mppi_tf_tpu.controller.mppi import MPPI as JMPPI
from mppi_tf_tpu.costs import get_cost as jget_cost
from mppi_tf_tpu.envs.runner import run_experiment as jrun_experiment
from mppi_tf_tpu.models import get_model as jget_model
from mppi_tf_tpu.observer import Observer as JObserver
from mppi_tf_tpu_torch import cli
from mppi_tf_tpu_torch.cfg import config
from mppi_tf_tpu_torch.controller import MPPI
from mppi_tf_tpu_torch.costs import get_cost
from mppi_tf_tpu_torch.envs import run_experiment
from mppi_tf_tpu_torch.kernels import _launch
from mppi_tf_tpu_torch.kernels import pm_mppi as pm
from mppi_tf_tpu_torch.models import get_model
from mppi_tf_tpu_torch.observer import Observer

SIGMA = np.diag([0.25, 0.3, 0.2])
SCHED = {"type": "exp", "start": 1.0, "end": 0.25}
#: the JAX observer's tag families (observer_base.py:101-187)
FAMILIES = ("Cost/", "Controller/", "Input/axis_", "State/state")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _records(logdir) -> list:
    with open(Path(logdir) / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _tags(logdir) -> set:
    return {key for rec in _records(logdir) for key in rec if key != "step"}


def _assert_same_records(port_dir, jax_dir, rtol=1e-6):
    port, ref = _records(port_dir), _records(jax_dir)
    assert [sorted(r) for r in port] == [sorted(r) for r in ref]
    for rp, rj in zip(port, ref):
        for key in rp:
            np.testing.assert_allclose(rp[key], rj[key], rtol=rtol,
                                       atol=1e-12, err_msg=key)


@pytest.mark.parametrize("sdim", [6, 13])
def test_observer_writes_the_jax_records(tmp_path, sdim):
    """The same info, action, state and transition give the same JSONL
    records (tags, steps, values) in both packages."""
    rng = np.random.default_rng(sdim)
    k, tau, adim = 50, 4, 3 if sdim == 6 else 6
    info = {"cost_min": 1.5, "cost_mean": 2.5, "cost_max": 7.0,
            "nabla": 12.3, "sample_costs": rng.uniform(1, 7, k),
            "weights": rng.dirichlet(np.ones(k)), "arg": -rng.random(k),
            "noise": rng.normal(size=(k, tau, adim)),
            "weighted_noise": rng.normal(size=(tau, adim))}
    state, action = rng.normal(size=sdim), rng.normal(size=adim)
    x_next, pred = rng.normal(size=sdim), rng.normal(size=sdim)
    goal = rng.normal(size=sdim)
    task = {"type": "static", "goal": goal.tolist(), "Q": [1.0] * sdim,
            "diag": True}
    if sdim == 13:
        goal[3:7] /= np.linalg.norm(goal[3:7])
        x_next[3:7] /= np.linalg.norm(x_next[3:7])
        pred[3:7] /= np.linalg.norm(pred[3:7])
        state[3:7] /= np.linalg.norm(state[3:7])
        task = {"type": "static_quat", "goal": goal.tolist(),
                "Q": [1.0] * 10, "diag": True}
    sig = np.eye(adim)
    port_cost = get_cost(task, lam=1.0, gamma=1.0, upsilon=1.0, sigma=sig,
                         dtype=torch.float64)
    jax_cost = jget_cost(task, lam=1.0, gamma=1.0, upsilon=1.0, sigma=sig,
                         dtype=jnp.float64)
    obs_p = Observer(str(tmp_path / "port"), use_tensorboard=False)
    obs_j = JObserver(str(tmp_path / "jax"), use_tensorboard=False)
    for step in range(2):
        obs_p.write_control(
            state=torch.as_tensor(state), action=action,
            info={key: torch.as_tensor(np.asarray(v)) for key, v in
                  info.items()})
        obs_j.write_control(state=jnp.asarray(state), action=action,
                            info={key: jnp.asarray(v) for key, v in
                                  info.items()})
        obs_p.write_predict(x=torch.as_tensor(state), x_next=x_next,
                            pred=torch.as_tensor(pred), cost=port_cost)
        obs_j.write_predict(x=state, x_next=x_next, pred=pred,
                            cost=jax_cost, cparams=jax_cost.init_params())
        obs_p.advance()
        obs_j.advance()
        state = state + 0.1
    obs_p.close()
    obs_j.close()
    _assert_same_records(obs_p.get_logdir(), obs_j.get_logdir())
    tags = _tags(obs_p.get_logdir())
    assert all(any(t.startswith(f) for t in tags) for f in FAMILIES)
    assert "Predict/step_cost" in tags


def _pm_pair(**kw):
    task = {"type": "static", "goal": [1.0, 0.0, 0.0, 0.0, 0.0, 0.0],
            "Q": np.eye(6).tolist()}
    model = get_model({"type": "point_mass", "mass": 1.5}, dt=0.1,
                      state_dim=6, action_dim=3)
    cost = get_cost(task, lam=1.2, gamma=1.1, upsilon=2.0, sigma=SIGMA)
    jmodel = jget_model({"type": "point_mass", "mass": 1.5}, dt=0.1,
                        state_dim=6, action_dim=3, dtype=jnp.float32)
    jcost = jget_cost(task, lam=1.2, gamma=1.1, upsilon=2.0, sigma=SIGMA,
                      dtype=jnp.float32)
    return (model, cost), (jmodel, jcost)


@pytest.mark.parametrize("kernel_path", ["torch", "cuda"])
def test_mppi_observer_hook_writes_the_jax_tag_set(tmp_path, kernel_path):
    """MPPI(observer=...) with save(x, u, x_next): the JSONL tag set of the
    JAX controller's, on the plain path and on the kernel path's glue
    (its solve object on the CPU: scheduled, antithetic)."""
    (m, c), (jm, jc) = _pm_pair()
    kw = dict(k=64, tau=5, lam=1.2, upsilon=2.0, sigma=SIGMA, log=True,
              noise_schedule=SCHED, antithetic=True)
    obs_p = Observer(str(tmp_path / "port"), use_tensorboard=False)
    obs_j = JObserver(str(tmp_path / "jax"), use_tensorboard=False)
    port = MPPI(m, c, observer=obs_p, device="cpu", **kw)
    if kernel_path == "cuda":
        port._fused = pm.FusedPointMassMPPI(
            m, c, k=64, tau=5, lam=1.2, upsilon=2.0, sigma=SIGMA,
            antithetic=True, schedule=SCHED)
    ref = JMPPI(jm, jc, observer=obs_j, **kw)
    for ctrl, mod in ((port, m), (ref, None)):
        x = np.full(6, 0.3)
        for _ in range(3):
            u = ctrl.next(x)
            x_next = x + 0.01 * np.concatenate([u, u])
            ctrl.save(x, u, x_next)
            x = x_next
    obs_p.close()
    obs_j.close()
    assert _tags(obs_p.get_logdir()) == _tags(obs_j.get_logdir())
    assert obs_p.step == obs_j.step == 3
    steps = sorted({r["step"] for r in _records(obs_p.get_logdir())})
    assert steps == [0, 1, 2]


def _small_cfgs(k=32, tau=5):
    cfgs = [config.default_config(n) for n in (
        "envs/point_mass", "tasks/static_cost", "models/point_mass_model")]
    cfgs[0] = dict(cfgs[0], samples=k, horizon=tau)
    return cfgs


def test_run_experiment_log_in_both_packages(tmp_path):
    """run_experiment(log=True, log_path=...) in both packages: config
    snapshots, the same JSONL tag set, the step counter advanced by the
    runner's save hook."""
    cfgs = _small_cfgs()
    port = run_experiment(*cfgs, steps=3, log=True,
                          log_path=str(tmp_path / "port"), device="cpu")
    ref = jrun_experiment(*cfgs, steps=3, log=True,
                          log_path=str(tmp_path / "jax"))
    for out in (port, ref):
        out["observer"].close()
        logdir = Path(out["observer"].get_logdir())
        for name in ("config", "task", "model"):
            assert (logdir / f"{name}.yaml").exists()
        assert out["observer"].step == 3
    assert config.parse_dir(port["observer"].get_logdir()) == \
        tuple(cfgs)
    assert _tags(port["observer"].get_logdir()) == \
        _tags(ref["observer"].get_logdir())
    assert {"Predict/error", "Predict/step_cost", "Predict/dist"} <= \
        _tags(port["observer"].get_logdir())


def test_cli_log_in_both_packages(tmp_path, capsys):
    env = config.write_config(dict(config.default_config("envs/point_mass"),
                                   samples=32, horizon=5),
                              str(tmp_path / "env.yaml"))
    outs = {}
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        argv = ["--config", env, "--task", "tasks/static_cost", "--model",
                "models/point_mass_model", "-s", "3", "-l", "--log-dir",
                str(tmp_path / name), "--cpu"]
        assert main(argv) == 0
        outs[name] = json.loads(
            capsys.readouterr().out.strip().splitlines()[-1])
    logdirs = {n: Path(o["logdir"]) for n, o in outs.items()}
    assert logdirs["port"].parent == tmp_path / "port"
    assert _tags(logdirs["port"]) == _tags(logdirs["jax"])
    # the snapshots replay
    assert cli.main(["--replay", "--log-dir", str(logdirs["port"]), "-s",
                     "1", "--cpu"]) == 0


def test_dump_hlo_and_save_graph(tmp_path):
    (m, c), _ = _pm_pair()
    ctrl = MPPI(m, c, k=40, tau=4, lam=1.2, upsilon=2.0, sigma=SIGMA,
                device="cpu", seed=2)
    useq, gen = ctrl.useq.clone(), ctrl._gen.get_state()
    text = ctrl.dump_hlo()
    assert "aten::" in text
    assert torch.equal(ctrl.useq, useq)
    assert torch.equal(ctrl._gen.get_state(), gen)
    obs = Observer(str(tmp_path), use_tensorboard=False)
    obs.save_graph(text)
    obs.close()
    assert (Path(obs.get_logdir()) / "solve_hlo.txt").read_text() == text
    # the kernel path's header (its glue on the CPU launches nothing)
    ctrl._fused = pm.FusedPointMassMPPI(m, c, k=40, tau=4, lam=1.2,
                                        upsilon=2.0, sigma=SIGMA,
                                        antithetic=True, schedule=SCHED)
    head = ctrl.dump_hlo()
    assert "FusedPointMassMPPI" in head and "scheduled=True" in head


def test_kernel_symbol_names_the_instantiation():
    """The mangled-name part ptxas reports for a template instantiation
    (Itanium ABI: integer template arguments as Li<n>E)."""
    assert _launch.kernel_symbol("pm_fused_costs", (6, 3, 1, 0)) == \
        "pm_fused_solve_kernelILi6ELi3ELi1ELi0E"
    assert _launch.kernel_symbol("pm_merge") == "pm_merge_kernel"
    assert _launch.kernel_symbols("pm_merge") == (
        "pm_merge_kernel", "pm_merge_stats_kernel")
    assert _launch.kernel_symbols("pm_fused_costs", (6, 3, 1, 0)) == (
        "pm_fused_solve_kernelILi6ELi3ELi1ELi0E",)
    mangled = ("_ZN12_GLOBAL__N_121pm_fused_solve_kernelILi6ELi3ELi1ELi0EEE"
               "vNS_6ConstsIXT_EXT0_EEEPKfiiS4_PfS5_ii5Seeds")
    assert _launch.kernel_symbol("pm_fused_costs", (6, 3, 1, 0)) in mangled
    assert _launch.kernel_symbol("pm_fused_solve", (6, 3, 0, 0)) \
        not in mangled
    assert set(_launch.KERNELS) == set(_launch.launch_counts)


def _auv_pair():
    from mppi_tf_tpu import flagship as jflagship
    from mppi_tf_tpu_torch import flagship

    sigma = np.diag([40.0] * 3 + [5.0] * 3)
    kw = dict(k=32, tau=4, lam=0.5, upsilon=1.0, sigma=sigma)
    port = MPPI(get_model(flagship.auv_params(), dt=0.1),
                get_cost(flagship.auv_task(), lam=0.5, gamma=0.2,
                         upsilon=1.0, sigma=sigma), device="cpu", **kw)
    ref = JMPPI(jget_model(jflagship.auv_params(), dt=0.1,
                           dtype=jnp.float32),
                jget_cost(jflagship.auv_task(), lam=0.5, gamma=0.2,
                          upsilon=1.0, sigma=sigma, dtype=jnp.float32), **kw)
    return port, ref


@pytest.mark.parametrize("method", ["trace", "profile"])
def test_warm_up_state_is_the_jax_fake_state(method):
    """trace() and profile() of an AUV controller start their solve from
    the state the JAX package uses: zeros with a unit quaternion."""
    port, ref = _auv_pair()
    seen = {}
    solve_p, solve_j = port._solve, ref._solve_jit

    def rec_p(state, useq, sched=None):
        seen["port"] = state.detach().cpu().numpy().copy()
        return solve_p(state, useq, sched)

    def rec_j(key, state, *args):
        seen["jax"] = np.asarray(state).copy()
        return solve_j(key, state, *args)

    port._solve, ref._solve_jit = rec_p, rec_j
    getattr(port, method)()
    getattr(ref, method)()
    want = np.zeros(13)
    want[6] = 1.0
    np.testing.assert_array_equal(seen["port"], seen["jax"])
    np.testing.assert_array_equal(seen["port"], want)
