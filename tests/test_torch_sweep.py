"""The port's sweep driver (``mppi_tf_tpu_torch/sweep.py``) against the
JAX package's (``mppi_tf_tpu/sweep.py``): the grid parsing, the patched
YAMLs of ``--dump-dir``, and a ``--cpu`` run of two combos whose records
have JAX's keys and whose final states equal JAX's within 1e-10 at f64 on
the same injected noise."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mppi_tf_tpu import sweep as jsweep
from mppi_tf_tpu.controller import mppi as jmppi
from mppi_tf_tpu.envs import runner as jrunner
from mppi_tf_tpu_torch import sweep
from mppi_tf_tpu_torch.cfg import config
from mppi_tf_tpu_torch.envs import runner
from mppi_tf_tpu_torch.ops import noise as noise_ops

SPECS = [["0.5,1.0"], ["[1,2],[3,4]"], ['{"a":1},2'], ["a,,b"],
         ["x"], ["[1,[2,3]],4"]]
GRIDS = [["lambda=0.5,1.0", "task.Q=[1,2]", "model.mass=2.0"],
         ["upsilon=1.0,1.2", "noise=[[0.1,0.0],[0.0,0.1]],[[1,0],[0,1]]"],
         ["task.goal=[1,0,0,0,0,0]", "lambda=0.3,0.6,0.9",
          "model.mass=1,2"],
         ["samples=64"]]


@pytest.mark.parametrize("spec", SPECS)
def test_split_values_equals_jax(spec):
    assert sweep._split_values(spec[0]) == jsweep._split_values(spec[0])
    assert [sweep._parse_value(v) for v in sweep._split_values(spec[0])] \
        == [jsweep._parse_value(v) for v in jsweep._split_values(spec[0])]


@pytest.mark.parametrize("grid", GRIDS)
def test_expand_grid_equals_jax(grid):
    assert list(sweep.expand_grid(grid)) == list(jsweep.expand_grid(grid))


def test_expand_grid_refuses_an_axis_without_values():
    with pytest.raises(ValueError, match="KEY=V1"):
        list(sweep.expand_grid(["lambda"]))


def test_set_dotted_equals_jax():
    a, b = {"x": {"y": 1}}, {"x": {"y": 1}}
    for cfg, fn in ((a, sweep._set_dotted), (b, jsweep._set_dotted)):
        fn(cfg, "x.z.w", 3)
        fn(cfg, "x.y", [1, 2])
    assert a == b == {"x": {"y": [1, 2], "z": {"w": 3}}}


def test_dump_dir_writes_the_same_overrides(tmp_path):
    argv = ["--config", "envs/point_mass", "--task", "tasks/static_cost",
            "--model", "models/point_mass_model", "--set", "lambda=0.7,0.9",
            "--set", "task.Q=[1,1,1,1,1,1]"]
    assert sweep.main(argv + ["--dump-dir", str(tmp_path / "port")]) == 0
    assert jsweep.main(argv + ["--dump-dir", str(tmp_path / "jax")]) == 0
    for i in range(2):
        port, ref = (tmp_path / side / f"combo_{i:04d}"
                     for side in ("port", "jax"))
        assert json.loads((port / "overrides.json").read_text()) == \
            json.loads((ref / "overrides.json").read_text())
        for name in ("env", "task", "model"):
            assert yaml.safe_load((port / f"{name}.yaml").read_text()) == \
                yaml.safe_load((ref / f"{name}.yaml").read_text())
    assert json.loads((tmp_path / "port" / "combo_0001" /
                       "overrides.json").read_text()) == {
        "env.lambda": 0.9, "task.Q": [1, 1, 1, 1, 1, 1]}


def test_cpu_run_matches_jax_on_injected_noise(tmp_path, monkeypatch):
    """Two combos, 5 steps each at K=64, H=10: both packages' experiments
    at f64 on the same per-step noise; the records' keys are
    JAX's, the final states agree within 1e-10 and the costs within
    1e-10 relative."""
    k, tau, steps = 64, 10, 5
    env = config.write_config(
        dict(config.default_config("envs/point_mass"), samples=k,
             horizon=tau), str(tmp_path / "env.yaml"))
    sigma = np.asarray(config.load_config(env)["noise"], np.float64)
    eps = np.random.default_rng(0).standard_normal(
        (2 * steps, k, tau, 3)) @ sigma.T
    draws = iter(torch.as_tensor(eps))
    monkeypatch.setattr(noise_ops, "sample_noise",
                        lambda *a, **kw: next(draws))
    solves = iter(range(2 * steps))
    real_init = jmppi.MPPI.__init__

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        self._solve_jit = lambda key, state, useq, mp, cp, sched=None: \
            self._solve_with_noise_jit(jnp.asarray(eps[next(solves)]),
                                       state, useq, mp, cp)

    monkeypatch.setattr(jmppi.MPPI, "__init__", init)
    for module, f64 in ((jrunner, jnp.float64), (runner, torch.float64)):
        monkeypatch.setattr(
            module, "run_experiment",
            lambda *a, _run=module.run_experiment, _f64=f64, **kw:
            _run(*a, **{**kw, "dtype": _f64}))
    argv = ["--config", env, "--task", "tasks/static_cost", "--model",
            "models/point_mass_model", "--set", "lambda=0.5,1.0", "-s",
            str(steps), "--cpu"]
    assert sweep.main(argv + ["--out", str(tmp_path / "port.jsonl")]) == 0
    assert jsweep.main(argv + ["--out", str(tmp_path / "jax.jsonl")]) == 0
    port, ref = ([json.loads(line) for line in
                  (tmp_path / f"{side}.jsonl").read_text().splitlines()]
                 for side in ("port", "jax"))
    assert len(port) == len(ref) == 2
    for p, r in zip(port, ref):
        assert set(p) == set(r)
        assert p["combo"] == r["combo"] and p["overrides"] == r["overrides"]
        np.testing.assert_allclose(p["final_state"], r["final_state"],
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose([p["final_cost"], p["mean_cost"]],
                                   [r["final_cost"], r["mean_cost"]],
                                   rtol=1e-10)
    assert port[0]["final_state"] != port[1]["final_state"]


def test_run_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no GPU"):
        sweep.main(["--config", "envs/point_mass", "--task",
                    "tasks/static_cost", "--model", "models/point_mass_model",
                    "-s", "1", "--out", str(tmp_path / "r.jsonl")])
