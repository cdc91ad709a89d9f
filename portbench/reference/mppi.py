"""One information-theoretic MPPI solve, plain and in float64.

Williams et al., "Information theoretic MPC for model-based reinforcement
learning" (ICRA 2017), in the form of NicolayP/mppi-tf's controller: K
sequences eps = (upsilon sigma) z perturb the nominal sequence U; each is
rolled out through the model, scored by the state cost of every next state
plus the action cost

    0.5 (gamma (u^T S^-1 u + 2 u^T S^-1 eps) + lam (1 - 1/upsilon) eps^T S^-1 eps)

and the terminal state's cost; the weights are softmax(-(c - min c) / lam),
the costs first divided by max(c - min c) where the configuration
normalises; U += sum_k w_k eps_k. The first row of U is applied and U
shifts by one row with a zero row appended.

``plan`` returns the updated sequence before the shift; ``Planner`` runs
it at one cell's shapes, replayed as a CUDA graph on the card. The model, the
state cost and their parameters come from a configuration's reference
module (``point_mass3d.py``, ``rexrov2.py``); the normals from
``noise.normals``.
"""

from __future__ import annotations

import torch

from . import noise


def plan(ref, x0, useq, cost_params, seed: int, solve, k: int,
         normalize: bool) -> torch.Tensor:
    """The updated nominal sequence [tau, adim] (float64) of one solve from
    state ``x0`` [sdim] and sequence ``useq`` [tau, adim]; ``ref`` is the
    configuration's reference, ``cost_params`` its state cost's; the
    solve index an int or a one-element int64 tensor on the device."""
    dev = ref.device
    x0 = torch.as_tensor(x0, dtype=torch.float64, device=dev)
    useq = torch.as_tensor(useq, dtype=torch.float64, device=dev)
    tau, adim = useq.shape
    z = noise.normals(seed, solve, k, tau, adim, device=dev)
    eps = z @ ref.scale.T                              # [k, tau, adim]
    del z
    costs = _costs(ref, x0, useq, eps, cost_params)
    arg = costs - costs.min()
    if normalize:
        top = arg.max()
        arg = arg / torch.where(top > 0, top, torch.ones_like(top))
    w = torch.softmax(-arg / ref.lam, dim=0)
    wnoise = (w @ eps.reshape(k, -1)).reshape(tau, adim)
    return useq + wnoise


class Planner:
    """``plan`` at one cell's shapes. On the card it is captured as a CUDA
    graph at its first call and replayed after (a solve is some thousands
    of small operations, launched once each by the replay instead of one
    by one from Python: the same kernels, the same bits); elsewhere it
    runs eagerly. The cost parameters' tensors, the state, the sequence
    and the solve index are copied into the graph's inputs at each
    call."""

    def __init__(self, ref, seed: int, k: int, normalize: bool):
        self.ref, self.seed, self.k, self.normalize = ref, seed, k, normalize
        self.graph = None

    def __call__(self, x0, useq, cost_params, solve: int) -> torch.Tensor:
        ref = self.ref
        if ref.device.type != "cuda":
            return plan(ref, x0, useq, cost_params, self.seed, solve, self.k,
                        self.normalize)
        like = {"dtype": torch.float64, "device": ref.device}
        inputs = {"x0": torch.as_tensor(x0, **like),
                  "useq": torch.as_tensor(useq, **like),
                  "solve": noise.index_tensor(solve, ref.device),
                  **{n: v for n, v in cost_params.items()
                     if isinstance(v, torch.Tensor)}}
        if self.graph is None:
            self.bufs = {n: v.clone() for n, v in inputs.items()}
            self.cp = {**cost_params, **{n: self.bufs[n] for n in
                                         cost_params if n in inputs}}
            side = torch.cuda.Stream(device=ref.device)
            side.wait_stream(torch.cuda.current_stream(ref.device))
            with torch.cuda.stream(side):
                self._plan()
            torch.cuda.current_stream(ref.device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = self._plan()
        for n, v in inputs.items():
            self.bufs[n].copy_(v)
        self.graph.replay()
        return self.out.clone()

    def _plan(self):
        b = self.bufs
        return plan(self.ref, b["x0"], b["useq"], self.cp, self.seed,
                    b["solve"], self.k, self.normalize)


def _costs(ref, x0, useq, eps, cost_params) -> torch.Tensor:
    """Per-sample rollout costs [k] over the noise ``eps`` [k, tau, adim]."""
    k = eps.shape[0]
    x = x0.expand(k, x0.shape[0])
    inv_s, gamma = ref.inv_sigma, ref.gamma
    n_coef = ref.lam * (1.0 - 1.0 / ref.upsilon)
    cost = torch.zeros(k, dtype=torch.float64, device=x.device)
    for t in range(useq.shape[0]):
        u, e = useq[t], eps[:, t]
        x = ref.step(x, u[None, :] + e)
        rhs = inv_s @ u
        act = 0.5 * (gamma * (u @ rhs + 2.0 * (e @ rhs))
                     + n_coef * torch.sum((e @ inv_s.T) * e, dim=-1))
        cost = cost + ref.state_cost(x, cost_params) + act
    return cost + ref.state_cost(x, cost_params)


def shift(new_useq: torch.Tensor) -> torch.Tensor:
    """The receding-horizon shift: drop the first row, append zeros."""
    return torch.cat([new_useq[1:], torch.zeros_like(new_useq[:1])])


class Controller:
    """The controller's terms of a configuration, in float64 on
    ``device``: lam, gamma, upsilon, sigma (its ``sigma_diag``), the noise
    scale upsilon sigma, Sigma^-1 and each action's noise scale (a row's
    norm of the scale: the unit of the gap between two sequences)."""

    def __init__(self, config: dict, device):
        c = config["controller"]
        self.device = torch.device(device)
        self.lam, self.gamma = float(c["lam"]), float(c["gamma"])
        self.upsilon = float(c["upsilon"])
        sigma = torch.diag(torch.tensor(c["sigma_diag"], dtype=torch.float64,
                                        device=self.device))
        self.scale = self.upsilon * sigma
        self.inv_sigma = torch.linalg.inv(sigma)
        self.action_scale = torch.linalg.vector_norm(self.scale, dim=1)
