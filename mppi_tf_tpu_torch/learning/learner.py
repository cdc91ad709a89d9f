"""Model-learning loop: replay buffer -> normalisation -> Adam training,
with k-fold cross-validation, a hyperparameter grid search and open-loop
rollout validation.

Reference: scripts/src/learners/learner_base.py — add_rb/stats/train_all/
train/_train_step (:57-81, 146-153, 324-358, 469-496), k_fold_validation
(:155-209), grid_search (:83-144), validate (:218-322), augment_data
(:450-467), per-layer gradient/weight logging (:510-552); the JAX
package's ``mppi_tf_tpu/learning/learner.py`` is the port's reference.

The learner trains its own copy of the model (``copy.deepcopy``) on
``device`` (default the model's), so a controller rolling the model out
never sees half-trained weights: ``Learner.params`` is that copy's state
in the JAX package's layout (``interop``), and a controller takes it with
``controller.model_params = learner.params``. Adam is
``torch.optim.Adam`` with optax's defaults (b1 0.9, b2 0.999, eps 1e-8),
a fresh optimizer every ``train`` call as in the JAX package; gradients
flow through ``trainable()`` (the network of an NN model, the physical
parameters of an analytic one). Augmentation draws from ``generator``
(default one seeded with ``seed`` on ``device``); k-fold's fresh inits
from a CPU generator seeded with its ``seed``. The folds train one after
another. The loss stays on the device: ``train`` reads it once, at its
end, unless an observer takes it every epoch.
"""

from __future__ import annotations

import copy
import os
from typing import Optional

import numpy as np
import torch

from ..interop import _flatten, _model_tensors, _unflatten
from ..ops.rollout import rollout_trajectory
from .replay import ReplayBuffer


class Learner:
    """Trains a learned dynamics model from stored transitions."""

    def __init__(self, model, filename: Optional[str] = None,
                 buffer_size: int = 264, num_epochs: int = 100,
                 batch_size: int = -1, learning_rate: float = 1e-3,
                 augment_sigma: float = 0.001, log: bool = False,
                 log_path: Optional[str] = None, observer=None,
                 seed: int = 0, device=None,
                 generator: Optional[torch.Generator] = None):
        self.device = torch.device(device if device is not None
                                   else model.device)
        self.model = copy.deepcopy(model).to(self.device)
        self.s_dim = model.get_state_dim()
        self.a_dim = model.get_action_dim()
        # NN models train their weights against normalised delta targets;
        # analytic models (point mass, AUV, DMD) their physical parameters
        # against the raw next state (model_base.py:30-39)
        self._is_nn = hasattr(model, "predict_nn")
        self.rb = ReplayBuffer(buffer_size, self.s_dim, self.a_dim)
        self.num_epochs = int(num_epochs)
        self.batch_size = int(batch_size)
        self.learning_rate = float(learning_rate)
        self.sigma = float(augment_sigma)
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(int(seed))
        self.generator = generator
        self.log = log
        self.observer = observer
        if log and observer is None:
            from ..observer import Observer

            self.observer = Observer(log_path=log_path)
        self.logdir = (self.observer.get_logdir() if self.observer
                       else (log_path or "logs"))
        if filename is not None:
            self.load_rb(filename)

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    @property
    def params(self) -> dict:
        """The learner's model parameters in the JAX package's layout
        (``{"mass"}``, an NN's ``{"net": [{"w", "b"}, ...], "x_mean", ...}``)
        as detached copies on the learner's device."""
        return _unflatten({n: t.detach().clone()
                           for n, t in _model_tensors(self.model).items()})

    @params.setter
    def params(self, tree) -> None:
        """Write a tree of the getter's layout (tensors or arrays) into the
        learner's model in place."""
        flat, targets = _flatten(tree), _model_tensors(self.model)
        if set(flat) != set(targets):
            raise KeyError(f"params {sorted(flat)} != the model's "
                           f"{sorted(targets)}")
        with torch.no_grad():
            for name, t in targets.items():
                t.copy_(self._tensor(flat[name]).reshape(t.shape))

    def _tensor(self, a) -> torch.Tensor:
        """``a`` (tensor or array-like) in the model's dtype on the
        learner's device."""
        if isinstance(a, torch.Tensor):
            return a.detach().to(device=self.device, dtype=self.model.dtype)
        return torch.as_tensor(np.array(a, np.float64),
                               dtype=self.model.dtype, device=self.device)

    @staticmethod
    def _trainable(model) -> list:
        """(name, parameter) of what ``model`` trains, named as the JAX
        package's pytree paths (``[0]['w']``, ``['mass']``), in its
        flattening order."""
        tr = model.trainable()
        if isinstance(tr, dict):
            return [(f"['{n}']", tr[n]) for n in sorted(tr)]
        return [(f"[{i}]['{a}']", getattr(layer, a))
                for i, layer in enumerate(tr) for a in ("b", "w")]

    # ------------------------------------------------------------------
    # replay buffer surface (learner_base.py:54-64)
    # ------------------------------------------------------------------
    def add_rb(self, x, u, x_next):
        self.rb.add(x, u, x_next)

    def rb_trans(self):
        return self.rb.get_all_transitions()

    def load_rb(self, filename):
        self.rb.load_transitions(filename)

    def save_rb(self, filename):
        self.rb.save_transitions(filename)

    # ------------------------------------------------------------------
    # normalisation stats (learner_base.py:69-81)
    # ------------------------------------------------------------------
    def stats(self):
        """Set the model's X/Y normalisers from the whole buffer: the mean
        and the population std (``correction=0``, numpy's ``np.std``) plus
        1e-8. No-op for analytic models, which have no normalisers."""
        if not self._is_nn:
            return
        X, Y = self._prepare(self.rb_trans(), norm=False)
        eps = 1e-8
        self.model.set_normalization(
            x_mean=X.mean(dim=0), x_std=X.std(dim=0, correction=0) + eps,
            y_mean=Y.mean(dim=0), y_std=Y.std(dim=0, correction=0) + eps)

    def _prepare(self, data, norm: bool = True):
        """(X, Y) on the device: an NN model's features and delta targets
        (normalised with ``norm``), an analytic model's [state, action]
        and raw next state; the transitions go to the device in one
        copy."""
        s, a = self.s_dim, self.a_dim
        rows = self._tensor(np.concatenate(
            [data["obs"], data["next_obs"], data["act"]], axis=1))
        obs, nxt, act = rows[:, :s], rows[:, s:2 * s], rows[:, 2 * s:]
        if not self._is_nn:
            return torch.cat([obs, act], dim=-1), nxt
        with torch.no_grad():
            return self.model.prepare_training_data(obs, nxt, act, norm=norm)

    # ------------------------------------------------------------------
    # training (learner_base.py:146-153, 324-358, 469-496)
    # ------------------------------------------------------------------
    def _loss(self, X, Y, model=None) -> torch.Tensor:
        """Mean squared error of ``model`` (default the learner's): an NN
        at full precision (``training=True``), an analytic model's step."""
        model = self.model if model is None else model
        if self._is_nn:
            pred = model.predict_nn(X, training=True)
        else:
            pred = model.step(X[..., :self.s_dim], X[..., self.s_dim:])
        return torch.mean((pred - Y) ** 2)

    def train_all(self, learning_rate: Optional[float] = None,
                  batch_size: Optional[int] = None,
                  epoch: Optional[int] = None, val=None, augment=True):
        """Full-buffer training (learner_base.py:146-153). ``batch_size``
        is accepted for the reference's signature and unused: it trains
        full-batch too (learner_base.py:92, 324-335). ``epoch=0`` trains
        no epoch."""
        lr = learning_rate if learning_rate is not None \
            else self.learning_rate
        epochs = epoch if epoch is not None else self.num_epochs
        X, Y = self._prepare(self.rb_trans())
        return self.train(X, Y, epoch=epochs, learning_rate=lr, val=val,
                          augment=augment)

    def train(self, X, Y, epoch=1, learning_rate=None, augment=False,
              val=None):
        """Epoch loop with optional Gaussian augmentation and, with an
        observer, rollout validation every 10 epochs against ``val`` =
        (trajectories, action sequences) (learner_base.py:324-358).
        Returns the last epoch's loss (before its update), or None."""
        lr = learning_rate if learning_rate is not None \
            else self.learning_rate
        X, Y = self._tensor(X), self._tensor(Y)
        items = self._trainable(self.model)
        opt = torch.optim.Adam([p for _, p in items], lr=lr,
                               betas=(0.9, 0.999), eps=1e-8)
        loss = None
        for e in range(epoch):
            if augment:
                Xe, Ye = self.augment_data(X, Y, sigma=self.sigma)
            else:
                Xe, Ye = X, Y
            opt.zero_grad()
            loss = self._loss(Xe, Ye)
            loss.backward()
            opt.step()
            loss = loss.detach()
            if self.observer:
                self.observer.scalar("Train/loss_norm", float(loss), e)
                self._log_grad_weights(items, e)
            if val is not None and e % 10 == 0 and self.observer:
                # the reference's validation catalogue
                # (learner_base.py:339-357): train-set loss, rollout
                # error, per-dimension and per-step splits, transition
                # error and its per-dimension split
                err, trans, err_split, trans_split, err_step = \
                    self.validate(val[1], val[0], transition=True,
                                  split=True, per_step=True)
                with torch.no_grad():
                    train_set = float(self._loss(X, Y))
                self.observer.scalar("Val/rollout_mse", float(err), e)
                self.observer.scalar("Val/train_set", train_set, e)
                self.observer.scalar("Val/transition", float(trans), e)
                self._log_split("Val/split", err_split, e)
                self._log_split("Val/transition_split", trans_split, e)
                self.observer.histogram("Val/step_mse", err_step, e)
        return None if loss is None else float(loss)

    def augment_data(self, X, Y, samples: int = 5, sigma: float = 0.001):
        """x5 Gaussian input-noise augmentation, the noise drawn from
        ``self.generator``. Reference: learner_base.py:450-467."""
        Xa = X.repeat_interleave(samples, dim=0)
        Ya = Y.repeat_interleave(samples, dim=0)
        g = self.generator
        noise = torch.randn(Xa.shape, generator=g, dtype=Xa.dtype,
                            device=g.device).to(Xa.device)
        return Xa + sigma * noise, Ya

    # ------------------------------------------------------------------
    # k-fold cross-validation (learner_base.py:155-209)
    # ------------------------------------------------------------------
    def k_fold_validation(self, k: int = 10, learning_rate=None,
                          epoch: Optional[int] = None, val=None, seed=0,
                          fresh_init: bool = True,
                          generator: Optional[torch.Generator] = None):
        """Train k fold models, one after another, each on a copy of the
        learner's model with its own Adam; returns the per-fold (train,
        test) losses of the last epoch as numpy arrays. The folds are the
        JAX package's (a permutation from ``np.random.default_rng(seed)``,
        each cut to the smallest fold). ``fresh_init`` gives each fold an
        independent init (``trainable_init`` from ``generator``, default a
        CPU generator seeded with ``seed``; the configured parameters of an
        analytic model); ``False`` starts every fold from the learner's
        current parameters. ``val`` is accepted for the reference's
        signature and unused."""
        del val
        lr = learning_rate if learning_rate is not None \
            else self.learning_rate
        epochs = epoch if epoch is not None else self.num_epochs
        X, Y = self._prepare(self.rb_trans())
        n = X.shape[0]
        if n < k:
            raise ValueError(f"need >= {k} transitions for {k}-fold, have {n}")
        rng = np.random.default_rng(seed)
        folds = np.array_split(rng.permutation(n), k)
        test_size = min(len(f) for f in folds)
        train_size = n - test_size
        if fresh_init:
            if generator is None:
                generator = torch.Generator()
                generator.manual_seed(int(seed))
            inits = [self.model.trainable_init(generator) for _ in range(k)]
        else:
            inits = [self.model.trainable()] * k
        losses = torch.zeros(2, k, epochs, dtype=X.dtype, device=X.device)
        for i, fold in enumerate(folds):
            te = torch.as_tensor(fold[:test_size], device=X.device)
            tr = torch.as_tensor(np.delete(np.arange(n), fold[:test_size])
                                 [:train_size], device=X.device)
            model = copy.deepcopy(self.model).with_trainable(inits[i])
            opt = torch.optim.Adam([p for _, p in self._trainable(model)],
                                   lr=lr, betas=(0.9, 0.999), eps=1e-8)
            for e in range(epochs):
                opt.zero_grad()
                loss = self._loss(X[tr], Y[tr], model)
                loss.backward()
                opt.step()
                with torch.no_grad():
                    losses[0, i, e] = loss
                    losses[1, i, e] = self._loss(X[te], Y[te], model)
        losses = losses.cpu().numpy()
        if self.observer:
            for e in range(epochs):
                self.observer.histogram("KFold/train", losses[0, :, e], e)
                self.observer.histogram("KFold/test", losses[1, :, e], e)
        if not epochs:
            return None, None
        return losses[0, :, -1], losses[1, :, -1]

    # ------------------------------------------------------------------
    # grid search (learner_base.py:83-144)
    # ------------------------------------------------------------------
    def grid_search(self, trajs, action_seqs, learning_rates=None,
                    sigmas=None, epochs=(100,), k: int = 2):
        """Sweep lr x sigma (augmentation noise): k-fold and a full
        training each, scored by rollout validation error; returns (the
        best setting, every setting). The sweep starts each setting from
        the parameters after ``stats()`` and restores them and sigma at its
        end."""
        learning_rates = learning_rates if learning_rates is not None \
            else np.linspace(1e-4, 1e-1, 5)
        sigmas = sigmas if sigmas is not None else np.linspace(0.01, 0.001, 3)
        init_sigma = self.sigma
        self.stats()
        base_params = self.params
        results = []
        try:
            for e in epochs:
                for lr in learning_rates:
                    for s in sigmas:
                        self.sigma = float(s)
                        self.params = base_params
                        _ftr, fte = self.k_fold_validation(
                            k=k, learning_rate=float(lr), epoch=int(e))
                        self.params = base_params
                        self.train_all(learning_rate=float(lr), epoch=int(e))
                        err = float(self.validate(action_seqs, trajs))
                        results.append({
                            "lr": float(lr), "sigma": float(s),
                            "epochs": int(e), "val_error": err,
                            "kfold_test_loss": float(
                                np.mean(np.asarray(fte)[..., -1])),
                        })
        finally:
            self.params = base_params
            self.sigma = init_sigma
        best = min(results, key=lambda r: r["val_error"])
        return best, results

    # ------------------------------------------------------------------
    # validation (learner_base.py:218-322)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def validate(self, action_seqs, gt_trajs, transition: bool = False,
                 split: bool = False, per_step: bool = False):
        """Open-loop rollout MSE against ground-truth trajectories.

        action_seqs: [k, tau, aDim]; gt_trajs: [k, tau, sDim]. Returns the
        error (a 0-dim tensor), and with the flags the transition error,
        the per-dimension splits and (``per_step``, last) the [tau]
        per-step rollout error, as learner_base.py:298-322 combines them.
        """
        action_seqs = self._tensor(action_seqs)
        gt = self._tensor(gt_trajs)
        traj = rollout_trajectory(self.model.step, gt[:, 0],
                                  action_seqs[:, :-1])
        err_split = torch.mean((traj - gt) ** 2, dim=(0, 1))
        outs = [torch.mean(err_split)]
        if transition:
            states = gt[:, :-1].reshape(-1, self.s_dim)
            nexts = gt[:, 1:].reshape(-1, self.s_dim)
            acts = action_seqs[:, :-1].reshape(-1, self.a_dim)
            if self._is_nn:
                Xn, Yn = self.model.prepare_training_data(states, nexts,
                                                          acts)
                pred = self.model.predict_nn(Xn)
            else:
                Yn = nexts
                pred = self.model.step(states, acts)
            trans_split = torch.mean((pred - Yn) ** 2, dim=0)
            outs.append(torch.mean(trans_split))
            if split:
                outs.extend([err_split, trans_split])
        elif split:
            outs.append(err_split)
        if per_step:
            outs.append(torch.mean((traj - gt) ** 2, dim=(0, 2)))
        return outs[0] if len(outs) == 1 else tuple(outs)

    # ------------------------------------------------------------------
    # checkpoints (learner_base.py:66-67; nn_model.py:137-142)
    # ------------------------------------------------------------------
    def save_params(self, step: int) -> str:
        """``weights_step{step}.npz`` in the log directory; returns its
        path."""
        from .checkpoint import save_checkpoint

        return save_checkpoint(
            os.path.join(self.logdir, f"weights_step{step}"), self.params)

    def load_params(self, path: str):
        from .checkpoint import load_checkpoint

        self.params = load_checkpoint(path, like=self.params)

    # ------------------------------------------------------------------
    _SPLIT_NAMES = {
        6: ["vx", "vy", "vz", "p", "q", "r"],
        12: ["x", "y", "z", "roll", "pitch", "yaw",
             "vx", "vy", "vz", "p", "q", "r"],
        13: ["x", "y", "z", "qx", "qy", "qz", "qw",
             "vx", "vy", "vz", "p", "q", "r"],
    }

    def _log_split(self, scope: str, tensor, step: int):
        """Per-dimension scalars, named by the reference's axis convention
        for the 6/12/13-dim AUV layouts (learner_base.py:534-552), ``d{i}``
        otherwise."""
        if isinstance(tensor, torch.Tensor):
            tensor = tensor.detach().cpu().numpy()
        tensor = np.asarray(tensor).reshape(-1)
        names = self._SPLIT_NAMES.get(
            tensor.shape[0], [f"d{i}" for i in range(tensor.shape[0])])
        for i, axs in enumerate(names):
            self.observer.scalar(f"{scope}-{axs}", float(tensor[i]), step)

    def _log_grad_weights(self, items, step: int):
        """Per-parameter gradient and weight histograms, named by the JAX
        package's pytree paths (learner_base.py:510-528)."""
        for name, p in items:
            self.observer.histogram(f"grad{name}",
                                    p.grad.detach().reshape(-1), step)
            self.observer.histogram(f"weights{name}",
                                    p.detach().reshape(-1), step)
