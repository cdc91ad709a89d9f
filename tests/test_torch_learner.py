"""The port's learner (learning/learner.py, checkpoint.py, datastore.py,
replay.py) against the JAX package's on the same numpy-made transitions
and the same initial weights, at f64 on the CPU: the replay ring and its
native datastore, ``stats``, ``train`` / ``train_all`` (augmentation
injected into both packages), k-fold, validation, the grid search,
checkpoints, and the physical-parameter fits of the analytic models (the
cases of tests/test_learning.py, each against the JAX learner).

Adam: ``torch.optim.Adam`` and ``optax.adam`` from the same init stay
within ~4e-15 over hundreds of full-batch epochs at f64, so the weights
are held to TOL = 1e-10 and ``stats`` to 1e-12."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_tf_tpu.learning.learner import Learner as JLearner
from mppi_tf_tpu.learning.replay import ReplayBuffer as JReplayBuffer
from mppi_tf_tpu.models import get_model as jget_model
from mppi_tf_tpu.models.nn import NNModel as JNNModel
from mppi_tf_tpu.models.point_mass import PointMassModel as JPointMassModel
from mppi_tf_tpu_torch.interop import _flatten, _unflatten, from_jax_params
from mppi_tf_tpu_torch.learning import Learner, ReplayBuffer, get_learner
from mppi_tf_tpu_torch.learning import checkpoint, datastore
from mppi_tf_tpu_torch.models import get_model
from mppi_tf_tpu_torch.models.nn import NNModel
from mppi_tf_tpu_torch.models.point_mass import PointMassModel

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-10
F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(tree) -> dict:
    """A params tree of either package as {flat name: f64 array}."""
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)).astype(np.float64)
            for k, v in _flatten(tree).items()}


def _assert_params(a, b, tol=TOL):
    fa, fb = _np(a), _np(b)
    assert set(fa) == set(fb)
    for k in fa:
        np.testing.assert_allclose(fa[k], fb[k], rtol=tol, atol=tol,
                                   err_msg=k)


def _transitions(n, seed):
    """(x, u, x') of a point mass with mass 2 (dt 0.1) from numpy."""
    rng = np.random.default_rng(seed)
    a = np.array([[1.0, 0.1], [0.0, 1.0]])
    b = np.array([0.005, 0.1]) / 2.0
    rows = []
    for _ in range(n):
        x, u = rng.normal(size=2), rng.normal(size=1)
        rows.append((x, u, a @ x + b * u[0]))
    return rows


def _pair(n=64, seed=40, hidden=(32, 32), **kw):
    """A JAX and a port learner over the same NNModel init (the JAX seed's
    weights loaded into the port's model), filled with the same
    transitions."""
    jm = JNNModel(state_dim=2, action_dim=1, hidden=hidden,
                  dtype=jnp.float64)
    model = NNModel(state_dim=2, action_dim=1, hidden=hidden, dtype=F64)
    from_jax_params(jax.tree.map(np.asarray, jm.init_params()), None, model)
    args = dict(buffer_size=256, num_epochs=60, learning_rate=5e-3, **kw)
    jl, pl = JLearner(jm, **args), Learner(model, device="cpu", **args)
    for x, u, x1 in _transitions(n, seed):
        jl.add_rb(x, u, x1)
        pl.add_rb(x, u, x1)
    return jl, pl


def _inject_augmentation(jl, pl, seed=7):
    """Both learners' augment_data draw the same normals: one numpy
    stream a package, from the same seed."""
    rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)

    def jaug(key, X, Y, samples=5, sigma=0.001):
        Xa = jnp.repeat(X, samples, axis=0)
        return Xa + sigma * rj.standard_normal(Xa.shape), \
            jnp.repeat(Y, samples, axis=0)

    def paug(X, Y, samples=5, sigma=0.001):
        Xa = X.repeat_interleave(samples, dim=0)
        noise = torch.as_tensor(rp.standard_normal(tuple(Xa.shape)))
        return Xa + sigma * noise, Y.repeat_interleave(samples, dim=0)

    jl.augment_data, pl.augment_data = jaug, paug


def _trajs(seed, k=3, tau=10):
    """Action sequences [k, tau, 1] and ground-truth trajectories [k, tau,
    2] of the mass-2 point mass from numpy."""
    rng = np.random.default_rng(seed)
    model = JPointMassModel(mass=2.0, dt=0.1, state_dim=2, action_dim=1,
                            dtype=jnp.float64)
    seqs = rng.normal(size=(k, tau, 1))
    trajs = np.asarray(model.run_model(
        model.init_params(), jnp.asarray(rng.normal(size=(k, 2))),
        jnp.asarray(seqs)))
    return seqs, trajs[:, :tau]


# ---------------------------------------------------------------------------
# the replay buffer and its native datastore
# ---------------------------------------------------------------------------
class TestReplayBuffer:
    @pytest.mark.parametrize("use_native", [False, True])
    def test_ring_semantics(self, use_native):
        rb = ReplayBuffer(4, 2, 1, use_native=use_native)
        jrb = JReplayBuffer(4, 2, 1, use_native=use_native)
        assert rb.backend == ("native" if use_native else "numpy")
        for i in range(6):
            for b in (rb, jrb):
                b.add([i, i], [i], [i + 1, i + 1])
        assert len(rb) == len(jrb) == 4 and rb.total_added == 6
        data, jdata = rb.get_all_transitions(), jrb.get_all_transitions()
        np.testing.assert_array_equal(data["obs"][:, 0], [2, 3, 4, 5])
        for key in data:
            np.testing.assert_array_equal(data[key], jdata[key])

    @pytest.mark.parametrize("use_native", [False, True])
    def test_csv_round_trip(self, tmp_path, use_native):
        rb = ReplayBuffer(8, 2, 1, use_native=use_native)
        rng = np.random.default_rng(41)
        for _ in range(5):
            rb.add(rng.normal(size=2), rng.normal(size=1),
                   rng.normal(size=2))
        path = str(tmp_path / "transitions.csv")
        rb.save_transitions(path)
        back = ReplayBuffer(8, 2, 1, use_native=use_native)
        jback = JReplayBuffer(8, 2, 1, use_native=False)
        back.load_transitions(path)
        jback.load_transitions(path)
        for k, v in rb.get_all_transitions().items():
            np.testing.assert_allclose(back.get_all_transitions()[k], v,
                                       rtol=1e-12)
            np.testing.assert_allclose(jback.get_all_transitions()[k], v,
                                       rtol=1e-12)

    def test_native_csv_equals_the_jax_native_csv(self, tmp_path):
        """The port's datastore and the JAX package's write the same CSV
        bytes for the same transitions, ring wrapped."""
        pytest.importorskip("mppi_tf_tpu.learning.datastore")
        from mppi_tf_tpu.learning.datastore import NativeDataStore as JNDS

        ds, jds = datastore.NativeDataStore(8, 2, 1), JNDS(8, 2, 1)
        rng = np.random.default_rng(42)
        for _ in range(11):
            row = (rng.normal(size=2), rng.normal(size=1), rng.normal(size=2))
            ds.add(*row)
            jds.add(*row)
        ours, theirs = tmp_path / "port.csv", tmp_path / "jax.csv"
        ds.to_csv(str(ours))
        jds.to_csv(str(theirs))
        assert ours.read_bytes() == theirs.read_bytes()
        loaded = np.loadtxt(ours, delimiter=",", skiprows=1, ndmin=2)
        np.testing.assert_array_equal(loaded[:, :2], ds.get_all()["obs"])

    def test_native_build_is_the_ports_own(self):
        """The library builds from the port's copy of datastore.cpp (its
        code the JAX package's after the header comment) into the port's
        ignored build directory."""
        ours = datastore.SOURCE.read_text()
        theirs = (REPO / "mppi_tf_tpu" / "native" / "src" /
                  "datastore.cpp").read_text()
        assert datastore.SOURCE.is_relative_to(REPO / "mppi_tf_tpu_torch")
        assert ours[ours.index("#include"):] == \
            theirs[theirs.index("#include"):]
        path = datastore.build()
        assert path.parent == REPO / "mppi_tf_tpu_torch" / "_build"
        assert path.exists() and path.name.startswith("libmppidata_")

    @pytest.mark.parametrize("use_native", [False, True])
    def test_sample(self, use_native):
        rb = ReplayBuffer(16, 2, 1, use_native=use_native)
        for i in range(10):
            rb.add([i, 0], [0], [0, 0])
        batch = rb.sample(32, rng=np.random.default_rng(0))
        assert batch["obs"].shape == (32, 2)
        assert batch["obs"][:, 0].max() <= 9

    @pytest.mark.parametrize("use_native", [False, True])
    def test_sample_indexes_the_ring_and_rejects_empty(self, use_native):
        rb = ReplayBuffer(4, 2, 1, use_native=use_native)
        with pytest.raises(ValueError, match="empty"):
            rb.sample(2)
        for i in range(6):
            rb.add([i, i], [i], [i + 1, i + 1])
        batch = rb.sample(64, rng=np.random.default_rng(0))
        assert set(batch["obs"][:, 0].astype(int)) <= {2, 3, 4, 5}
        np.testing.assert_allclose(batch["next_obs"][:, 0],
                                   batch["obs"][:, 0] + 1)


# ---------------------------------------------------------------------------
# the NN learner against the JAX learner
# ---------------------------------------------------------------------------
class TestLearner:
    def test_get_learner_trains_a_copy(self):
        model = NNModel(state_dim=2, action_dim=1, hidden=(8,), dtype=F64)
        before = _np({"net": [{"w": l.w, "b": l.b} for l in model.net]})
        learner = get_learner(model, device="cpu")
        for x, u, x1 in _transitions(16, 1):
            learner.add_rb(x, u, x1)
        learner.stats()
        learner.train_all(epoch=5)
        assert learner.model is not model
        after = _np({"net": [{"w": l.w, "b": l.b} for l in model.net]})
        for k in before:
            np.testing.assert_array_equal(before[k], after[k])
        assert not np.array_equal(
            _np(learner.params)["net.0.w"], before["net.0.w"])

    def test_stats_matches_jax(self):
        jl, pl = _pair()
        jl.stats()
        pl.stats()
        _assert_params(jl.params, pl.params, tol=1e-12)
        assert not np.allclose(_np(pl.params)["x_mean"], 0.0)
        assert np.all(_np(pl.params)["x_std"] > 0)

    def test_train_matches_jax(self):
        """100 epochs of ``train`` without augmentation: the weights and
        the last loss."""
        jl, pl = _pair(n=128)
        jl.stats()
        pl.stats()
        JX, JY = jl._prepare(jl.rb_trans())
        X, Y = pl._prepare(pl.rb_trans())
        np.testing.assert_allclose(X.numpy(), np.asarray(JX), rtol=1e-12)
        jloss = jl.train(JX, JY, epoch=100, learning_rate=5e-3)
        loss = pl.train(X, Y, epoch=100, learning_rate=5e-3)
        _assert_params(jl.params, pl.params)
        assert loss == pytest.approx(jloss, rel=TOL)

    def test_train_all_with_injected_augmentation_matches_jax(self):
        jl, pl = _pair(n=96)
        _inject_augmentation(jl, pl)
        jl.stats()
        pl.stats()
        jloss = jl.train_all(epoch=100)
        loss = pl.train_all(epoch=100)
        _assert_params(jl.params, pl.params)
        assert loss == pytest.approx(jloss, rel=TOL)
        # a second call starts a fresh Adam, as the JAX learner's does
        jl.stats()
        pl.stats()
        jl.train_all(epoch=20)
        pl.train_all(epoch=20)
        _assert_params(jl.params, pl.params)

    def test_training_reduces_loss(self):
        _jl, pl = _pair(n=128)
        pl.stats()
        X, Y = pl._prepare(pl.rb_trans())
        with torch.no_grad():
            l0 = float(pl._loss(X, Y))
        pl.train_all(epoch=200, augment=False)
        with torch.no_grad():
            l1 = float(pl._loss(X, Y))
        assert l1 < 0.2 * l0, f"loss did not drop enough: {l0} -> {l1}"

    def test_kfold_shared_init_matches_jax(self):
        jl, pl = _pair()
        jl.stats()
        pl.stats()
        jtr, jte = jl.k_fold_validation(k=4, epoch=20, fresh_init=False)
        tr, te = pl.k_fold_validation(k=4, epoch=20, fresh_init=False)
        assert tr.shape == te.shape == (4,)
        np.testing.assert_allclose(tr, jtr, rtol=TOL)
        np.testing.assert_allclose(te, jte, rtol=TOL)

    def test_kfold_injected_fresh_inits_match_jax(self):
        """fresh_init with the same k inits injected into both packages
        (the JAX stream of ``trainable_init`` cannot be drawn in torch)."""
        jl, pl = _pair()
        jl.stats()
        pl.stats()
        keys = jax.random.split(jax.random.PRNGKey(3), 4)
        inits = [jl.model.trainable_init(k) for k in keys]
        jit, pit = iter(inits), iter(inits)
        jl.model.trainable_init = lambda key: next(jit)
        pl.model.trainable_init = lambda gen: next(pit)
        jtr, jte = jl.k_fold_validation(k=4, epoch=10)
        tr, te = pl.k_fold_validation(k=4, epoch=10)
        np.testing.assert_allclose(tr, jtr, rtol=TOL)
        np.testing.assert_allclose(te, jte, rtol=TOL)
        assert len(set(te.tolist())) == 4

    def test_kfold_fresh_init_gives_distinct_folds(self):
        _jl, pl = _pair()
        pl.stats()
        gen = torch.Generator()
        gen.manual_seed(3)
        w0 = pl.model.trainable_init(gen)[0].w
        w1 = pl.model.trainable_init(gen)[0].w
        assert not torch.allclose(w0, w1)
        tr, te = pl.k_fold_validation(k=4, epoch=5, fresh_init=True)
        assert np.all(np.isfinite(tr)) and np.all(np.isfinite(te))
        tr2, te2 = pl.k_fold_validation(k=4, epoch=5, fresh_init=True)
        np.testing.assert_array_equal(te, te2)   # seeded: repeatable
        tr_s, _ = pl.k_fold_validation(k=4, epoch=5, fresh_init=False)
        assert np.all(np.isfinite(tr_s))

    def test_validate_matches_jax(self):
        """validate with transition, split and per_step, before and after
        300 epochs of training (the error falls)."""
        jl, pl = _pair()
        jl.stats()
        pl.stats()
        seqs, trajs = _trajs(43)
        flags = dict(transition=True, split=True, per_step=True)
        for epochs in (0, 300):
            if epochs:
                jl.train_all(epoch=epochs, augment=False)
                pl.train_all(epoch=epochs, augment=False)
            jout = jl.validate(seqs, trajs, **flags)
            out = pl.validate(seqs, trajs, **flags)
            assert len(out) == len(jout) == 5
            for a, b in zip(out, jout):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=TOL, atol=1e-14)
            if not epochs:
                before = float(out[0])
        assert float(pl.validate(seqs, trajs)) < before
        err, split = pl.validate(seqs, trajs, split=True)
        assert split.shape == (2,)

    def test_validation_logging_catalogue(self):
        """Training with a validation set logs the reference's catalogue
        (learner_base.py:339-357) under the JAX learner's names."""
        logged = {}

        class _Obs:
            def scalar(self, name, value, step):
                logged.setdefault("scalars", []).append(name)
                assert np.isfinite(value), name

            def histogram(self, name, values, step):
                logged.setdefault("hists", []).append(name)

            def get_logdir(self):
                return "logs"

        _jl, pl = _pair(hidden=(32, 32, 32))
        pl.observer = _Obs()
        pl.stats()
        seqs, trajs = _trajs(43)
        pl.train_all(epoch=11, augment=False, val=(trajs, seqs))
        names = set(logged["scalars"])
        assert {"Train/loss_norm", "Val/rollout_mse", "Val/train_set",
                "Val/transition", "Val/split-d0", "Val/split-d1",
                "Val/transition_split-d0"} <= names
        hists = set(logged["hists"])
        assert "Val/step_mse" in hists
        assert {"grad[0]['w']", "weights[0]['b']",
                "weights[3]['w']"} <= hists
        logged.clear()
        pl._log_split("Val/split", np.arange(13.0), 0)
        assert {"Val/split-qw", "Val/split-r"} <= set(logged["scalars"])

    def test_augment_data_shapes(self):
        """x5 rows, noise applied, drawn from the learner's generator."""
        _jl, pl = _pair()
        X, Y = torch.ones(4, 3, dtype=F64), torch.ones(4, 2, dtype=F64)
        Xa, Ya = pl.augment_data(X, Y, samples=5, sigma=0.01)
        assert Xa.shape == (20, 3) and Ya.shape == (20, 2)
        assert not torch.allclose(Xa[:5], torch.ones(5, 3, dtype=F64))
        draws = []
        for _ in range(2):
            gen = torch.Generator()
            gen.manual_seed(5)
            learner = Learner(pl.model, device="cpu", generator=gen)
            draws.append(learner.augment_data(X, Y)[0])
        torch.testing.assert_close(draws[0], draws[1], rtol=0, atol=0)

    def test_grid_search_picks_the_jax_setting(self):
        """The same combos, val errors within TOL and the same best
        setting (augmentation and the k-fold inits injected)."""
        jl, pl = _pair(n=48)
        _inject_augmentation(jl, pl)
        net0 = jl.model.trainable(jl.params)
        jl.model.trainable_init = lambda key: net0
        pl.model.trainable_init = lambda gen: net0
        seqs, trajs = _trajs(44, k=2, tau=6)
        kw = dict(learning_rates=[1e-3, 1e-2], sigmas=[0.001, 0.01],
                  epochs=(10,), k=2)
        jbest, jres = jl.grid_search(trajs, seqs, **kw)
        best, res = pl.grid_search(trajs, seqs, **kw)
        assert len(res) == len(jres) == 4
        for r, jr in zip(res, jres):
            assert (r["lr"], r["sigma"], r["epochs"]) == (
                jr["lr"], jr["sigma"], jr["epochs"])
            assert r["val_error"] == pytest.approx(jr["val_error"], rel=TOL)
            assert r["kfold_test_loss"] == pytest.approx(
                jr["kfold_test_loss"], rel=TOL)
        assert (best["lr"], best["sigma"]) == (jbest["lr"], jbest["sigma"])
        assert best["val_error"] == min(r["val_error"] for r in res)

    def test_grid_search_restores_sigma_and_params(self):
        _jl, pl = _pair(n=48)
        pl.stats()
        sigma0, params0 = pl.sigma, pl.params
        seqs, trajs = _trajs(45, k=2, tau=6)
        _best, results = pl.grid_search(trajs, seqs, learning_rates=[1e-3],
                                        sigmas=[0.5, 0.25], epochs=(3,), k=2)
        assert pl.sigma == sigma0
        _assert_params(params0, pl.params, tol=0.0)
        assert all(np.isfinite(r["kfold_test_loss"]) for r in results)

    def test_checkpoint_round_trip(self, tmp_path):
        _jl, pl = _pair(n=32, log_path=str(tmp_path))
        pl.stats()
        path = pl.save_params(7)
        assert path == str(tmp_path / "weights_step7.npz")
        with np.load(path) as data:
            assert set(data.files) == set(_flatten(pl.params))
        before = pl.params
        pl.params = _unflatten({k: v + 1.0
                                for k, v in _flatten(before).items()})
        pl.load_params(path)
        _assert_params(before, pl.params, tol=0.0)
        pl.save_params(12)
        assert checkpoint.latest_checkpoint(str(tmp_path)).endswith(
            "weights_step12.npz")
        assert checkpoint.latest_checkpoint(str(tmp_path / "none")) is None
        raw = checkpoint.load_checkpoint(str(tmp_path / "weights_step7"))
        _assert_params(before, raw, tol=0.0)

    def test_checkpoint_carries_jax_params(self, tmp_path):
        """A checkpoint of the JAX package's params tree loads into the
        port's model through interop: the same weights."""
        jm = JNNModel(state_dim=2, action_dim=1, hidden=(8,),
                      dtype=jnp.float64)
        jp = jax.tree.map(np.asarray, jm.init_params())
        path = checkpoint.save_checkpoint(str(tmp_path / "weights_step3"),
                                          jp)
        model = NNModel(state_dim=2, action_dim=1, hidden=(8,), dtype=F64)
        from_jax_params(checkpoint.load_checkpoint(path), None, model)
        _assert_params(jp, Learner(model, device="cpu").params, tol=0.0)


# ---------------------------------------------------------------------------
# analytic models: the physical parameters by gradient, in both packages
# ---------------------------------------------------------------------------
class TestPhysicalParamLearning:
    def test_trainable_surface_of_the_analytic_models(self):
        from tests.test_auv_kernel import _auv_cfg

        pm = PointMassModel(mass=0.7, dtype=F64)
        assert set(pm.trainable()) == {"mass"}
        pm.with_trainable({"mass": 3.0})
        assert pm.mass.item() == 3.0
        assert float(pm.trainable_init()["mass"]) == 0.7
        auv = get_model(_auv_cfg(), dt=0.1, action_dim=6, dtype=F64)
        assert set(auv.trainable()) == {"mass", "inertial"}
        init = auv.trainable_init()
        jinit = jget_model(_auv_cfg(), dt=0.1, action_dim=6,
                           dtype=jnp.float64).trainable_init(None)
        _assert_params(jinit, init, tol=0.0)

    def test_pointmass_mass_recovery_in_both(self):
        true = JPointMassModel(mass=2.0, dt=0.1, state_dim=2, action_dim=1,
                               dtype=jnp.float64)
        tp = true.init_params()
        args = dict(buffer_size=256, num_epochs=50, learning_rate=5e-2)
        jl = JLearner(JPointMassModel(mass=0.7, dt=0.1, state_dim=2,
                                      action_dim=1, dtype=jnp.float64),
                      **args)
        pl = Learner(PointMassModel(mass=0.7, dtype=F64), device="cpu",
                     **args)
        rng = np.random.default_rng(46)
        for _ in range(128):
            x, u = rng.normal(size=2), rng.normal(size=1) * 2.0
            x1 = np.asarray(true.predict(tp, jnp.asarray(x), jnp.asarray(u)))
            jl.add_rb(x, u, x1)
            pl.add_rb(x, u, x1)
        for learner in (jl, pl):
            learner.stats()
            learner.train_all(epoch=400, augment=False)
        mass = float(pl.params["mass"])
        assert abs(mass - 2.0) / 2.0 < 0.01, mass
        assert mass == pytest.approx(float(jl.params["mass"]), rel=TOL)

    def test_auv_mass_recovery_in_both(self):
        from tests.test_auv_kernel import _auv_cfg

        cfg = _auv_cfg()
        true = jget_model(cfg, dt=0.1, action_dim=6, dtype=jnp.float64)
        tp = true.init_params()
        bad = dict(cfg, mass=cfg["mass"] * 0.8)
        args = dict(buffer_size=512, num_epochs=50, learning_rate=10.0)
        jl = JLearner(jget_model(bad, dt=0.1, action_dim=6,
                                 dtype=jnp.float64), **args)
        pl = Learner(get_model(bad, dt=0.1, action_dim=6, dtype=F64),
                     device="cpu", **args)
        rng = np.random.default_rng(47)
        x = np.zeros(13)
        x[6] = 1.0
        for _ in range(128):
            x0 = x.copy()
            x0[7:13] = rng.normal(size=6) * 0.5
            u = rng.normal(size=6) * 200.0
            x1 = np.asarray(true.predict(tp, jnp.asarray(x0),
                                         jnp.asarray(u)))
            jl.add_rb(x0, u, x1)
            pl.add_rb(x0, u, x1)
        jl.train_all(epoch=300, augment=False)
        pl.train_all(epoch=300, augment=False)
        mass, jmass = float(pl.params["mass"]), float(jl.params["mass"])
        assert abs(mass - cfg["mass"]) / cfg["mass"] < 0.05, mass
        assert abs(jmass - cfg["mass"]) / cfg["mass"] < 0.05, jmass
        assert mass == pytest.approx(jmass, rel=TOL)
        _assert_params(jl.params, pl.params)

    def test_validate_transition_analytic(self):
        model = PointMassModel(mass=1.5, dtype=F64)
        learner = Learner(model, buffer_size=64, device="cpu")
        jm = JPointMassModel(mass=1.5, dt=0.1, state_dim=2, action_dim=1,
                             dtype=jnp.float64)
        rng = np.random.default_rng(48)
        seqs = rng.normal(size=(2, 6, 1))
        trajs = np.asarray(jm.run_model(
            jm.init_params(), jnp.asarray(rng.normal(size=(2, 2))),
            jnp.asarray(seqs)))
        err, terr = learner.validate(seqs, trajs[:, :6], transition=True)
        assert float(err) < 1e-12 and float(terr) < 1e-12
