"""Plain reference of ``nn_auv``: the learned AUV dynamics of
NicolayP/mppi-tf (``scripts/src/models/nn_model.py:179-304``,
``NNAUVModel``; ``config/models/auv_nn_model_quat.yaml``).

State [x y z | qx qy qz qw | u v w p q r], action the 6-dim body force.
One step of the model over its dt:

    f = [x[3:13], u]                        (16 features, position dropped)
    h = (f - x_mean) / x_std
    h = relu(h W1 + b1), relu(h W2 + b2), relu(h W3 + b3)   (3 x 32, ReLU)
    y = h W4 + b4                            (13 outputs, linear)
    x' = x + (y y_std + y_mean),  the quaternion block renormalised.

The state cost is rexrov2's static quaternion cost (``rexrov2.py``: the
10-dim error [p - g_p, 2 acos(q . g_q), nu - g_nu] on Q); the host plant,
which the fleet's vehicles are stepped by, is rexrov2's Fossen model of
the configuration named under ``plant``, since a learned model plans for
a real vehicle.

Departures from nn_model.py, each as the program has them:

- the quaternion is renormalised after the delta is added (the port's
  documented deviation, PARITY.md 6b); nn_model.py:303-304 adds the raw
  delta;
- the weights are seeded random weights, not trained ones: He-initialised
  N(0, 1) sqrt(2 / fan_in) drawn in float64 from ``torch.Generator(seed)``
  layer by layer as ``w [fan_in, fan_out]``, biases 0 (the port's
  ``models/nn.py::mlp_init``), rounded to float32 as the program holds
  them;
- the normalisers are data of the configuration (a learner would compute
  them from its buffer), rounded to float32 as the program holds them;
- the position mask of the yaml (its first three rows) is the features'
  dropped position.

Float64 throughout; TF32 is switched off for matrix products. Imports
nothing of the program.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import torch

from . import rexrov2
from .mppi import Controller

FEATURES, SDIM = 16, 13


def he_layers(sizes, seed: int) -> list:
    """[(w [fan_in, fan_out], b [fan_out])] of float64 tensors holding the
    float32 weights drawn from ``seed``."""
    gen = torch.Generator()
    gen.manual_seed(int(seed))
    out = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        w = torch.randn(fan_in, fan_out, generator=gen,
                        dtype=torch.float64) * math.sqrt(2.0 / fan_in)
        out.append((w.to(torch.float32).double(),
                    torch.zeros(fan_out, dtype=torch.float64)))
    return out


class Reference(Controller):
    """The configuration's learned model, the static quaternion cost and
    the rexrov2 plant on ``device``."""

    def __init__(self, config: dict, device):
        super().__init__(config, device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        m = config["model"]
        self.dt = float(config["dt"])
        sizes = [FEATURES, *m["hidden"], SDIM]
        self.layers = [(w.to(self.device), b.to(self.device))
                       for w, b in he_layers(sizes, m["seed"])]

        def f32(v):
            return torch.tensor(v, dtype=torch.float32).to(
                dtype=torch.float64, device=self.device)

        norm = m["normalisers"]
        self.x_mean, self.x_std = f32(norm["x_mean"]), f32(norm["x_std"])
        self.y_mean, self.y_std = f32(norm["y_mean"]), f32(norm["y_std"])
        plant = json.loads((Path(__file__).resolve().parents[1] / "configs"
                            / f"{config['plant']}.json").read_text())
        self.auv = rexrov2.Reference(
            {**plant, "controller": config["controller"],
             "cost": config["cost"]}, device)

    def step(self, x, u):
        """The model: x [k, 13], u [k, 6] -> x' [k, 13] over dt."""
        h = (torch.cat([x[:, 3:], u], dim=-1) - self.x_mean) / self.x_std
        for w, b in self.layers[:-1]:
            h = torch.relu(h @ w + b)
        w, b = self.layers[-1]
        x = x + ((h @ w + b) * self.y_std + self.y_mean)
        q = x[:, 3:7]
        n = torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                        min=1e-12)
        return torch.cat([x[:, :3], q / n, x[:, 7:]], dim=-1)

    def state_cost(self, x, cp):
        return self.auv.state_cost(x, cp)

    def static_params(self, goal) -> dict:
        return self.auv.static_params(goal)

    def plant(self, x, u, dt: float, substeps: int):
        """The rexrov2 plant (``rexrov2.Reference.plant``)."""
        return self.auv.plant(x, u, dt, substeps)

    def host_plant(self, x, u, dt: float, substeps: int):
        """The rexrov2 plant on the host, for a fleet's vehicles
        (``rexrov2.Reference.host_plant``)."""
        return self.auv.host_plant(x, u, dt, substeps)
