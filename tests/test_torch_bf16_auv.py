"""The bf16 block compute of the fused AUV kernels (compute_dtype=
"bfloat16"): the port's plain bf16 version against the JAX package's
Pallas kernel at compute_dtype="bfloat16" (interpret mode, compiled
without XLA's excess precision, injected normals; tests/
test_torch_bf16_pm.py says why), and the bf16 solve objects' plumbing.

The port's Fossen algebra is shaped as its own kernel's (auv_mppi.cu:
M nu, the cross products, the cached M^-1), not as the JAX kernel's; at
tests/test_bf16_kernel.py's AUV shapes the two still agree bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_tf_tpu.costs import get_cost as jget_cost
from mppi_tf_tpu.kernels.auv_mppi import FusedAUVMPPI as JFused
from mppi_tf_tpu.kernels.auv_mppi import chunk_noise_auv
from mppi_tf_tpu.models import get_model as jget_model
from mppi_tf_tpu_torch.controller import MPPI
from mppi_tf_tpu_torch.costs import get_cost
from mppi_tf_tpu_torch.kernels import auv_mppi as auv
from mppi_tf_tpu_torch.kernels import pm_mppi as pm
from mppi_tf_tpu_torch.models import get_model
from tests.test_auv_kernel import _auv_cfg, _task
from tests.test_torch_bf16_pm import assert_bf16_side, exact_jax  # noqa

# tests/test_bf16_kernel.py::test_bf16_auv_runs_finite's family
K, TAU, TILE = 80, 2, 32
SIGMA = np.diag([40.0, 40.0, 40.0, 5.0, 5.0, 5.0])
LAM, GAMMA, UPS = 0.5, 0.2, 1.2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(k=K, tau=TAU):
    rng = np.random.RandomState(0)
    z = rng.randn(tau, 6, k).astype(np.float32)
    x0 = np.zeros(13)
    x0[6], x0[2] = 1.0, -1.0
    useq = (5.0 * rng.randn(tau, 6)).astype(np.float32)
    return z, x0, useq


def _port(cd, k=K, tau=TAU, rk=2, **kw):
    model = get_model({**_auv_cfg(), "rk": rk}, dt=0.1, action_dim=6,
                      device="cpu")
    cost = get_cost(_task(), lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=SIGMA)
    return auv.FusedAUVMPPI(model, cost, k=k, tau=tau, lam=LAM, upsilon=UPS,
                            sigma=SIGMA, compute_dtype=cd, **kw)


def test_plain_bf16_costs_match_pallas_bf16(exact_jax):
    """rk2 Fossen rollout, static quaternion cost: the criterion, bit
    parity with the JAX kernel, and the f32 version failing the
    criterion."""
    z, x0, useq = _inputs()
    out = {}
    for cd in ("float32", "bfloat16"):
        model = jget_model({**_auv_cfg(), "rk": 2}, dt=0.1, action_dim=6)
        cost = jget_cost(_task(), lam=LAM, gamma=GAMMA, upsilon=UPS,
                         sigma=SIGMA)
        jf = JFused(model, cost, k=K, tau=TAU, lam=LAM, upsilon=UPS,
                    sigma=SIGMA, tile=TILE, interpret=True, compute_dtype=cd)
        c, _ = jf.costs_phase(0, x0, useq, model.init_params(),
                              cost.init_params(),
                              z=jnp.asarray(chunk_noise_auv(z, TILE)),
                              use_prng=False)
        out["jax", cd] = np.asarray(c).reshape(-1)[:K]
        c, _ = _port(cd).costs_phase(torch.tensor(x0, dtype=torch.float32),
                                     torch.as_tensor(useq),
                                     z=torch.as_tensor(z))
        out["port", cd] = c.numpy()
    assert_bf16_side(out["port", "bfloat16"], out["port", "float32"],
                     out["jax", "bfloat16"], out["jax", "float32"])
    np.testing.assert_array_equal(out["port", "bfloat16"],
                                  out["jax", "bfloat16"])


@pytest.mark.parametrize("rk", [1, 4])
def test_plain_bf16_rk_stays_near_f32(rk):
    """rk 1 and 4 at bf16 (the JAX kernel runs rk4 as rk2, a fault not
    copied, so its bf16 rk4 is no reference): finite, within 1e-3 of the
    f32 rollout's costs, and not equal to them."""
    z, x0, useq = _inputs()
    args = (torch.tensor(x0, dtype=torch.float32), torch.as_tensor(useq))
    c16, _ = _port("bfloat16", rk=rk).costs_phase(*args,
                                                  z=torch.as_tensor(z))
    c32, _ = _port("float32", rk=rk).costs_phase(*args, z=torch.as_tensor(z))
    assert torch.isfinite(c16).all() and not torch.equal(c16, c32)
    torch.testing.assert_close(c16, c32, rtol=1e-3, atol=0.0)


def test_bf16_solve_rounds_the_normals_in_every_phase():
    """The fused and two-phase bf16 solves weigh the bf16-rounded normals,
    injected or drawn: the weighted noise of the plain fused solve is the
    softmax over its costs of the rounded z."""
    z, x0, useq = _inputs(k=300)
    f16 = _port("bfloat16", k=300, antithetic=True)
    args = (torch.tensor(x0, dtype=torch.float32), torch.as_tensor(useq))
    for zz in (torch.as_tensor(z), None):
        parts = auv.fused_solve_plain(f16.consts, f16.pack_dyn(*args), 300,
                                      TAU, seed=3, solve=1, z=zz)
        zr = zz if zz is not None else pm.noise_plain(
            3, 1, 300, TAU, 6, half=pm.antithetic_half(300))
        zr = pm.round_bf16(zr)
        costs, _ = auv.fused_costs_plain(f16.consts, f16.pack_dyn(*args), 300,
                                         TAU, seed=3, solve=1, z=zz)
        ref = pm.block_partials(costs, zr.reshape(TAU * 6, 300), LAM)
        torch.testing.assert_close(parts, ref, rtol=0, atol=0)
    wn, info = f16.solve(*args, seed=3, solve=1, normalize=True)
    assert torch.isfinite(wn).all() and torch.isfinite(info["nabla"])


def test_bf16_constants_and_validation():
    """The bf16 build's packed constants: the dynamics' rounded to bf16,
    dt, lam, nc_half and the f32 state cost's Q left as they are; any
    other compute_dtype raises; the AUV controller on the torch path
    refuses bf16."""
    p32, p16 = _port("float32").consts.packed, _port("bfloat16").consts.packed
    assert np.array_equal(p16[:3], p32[:3])
    assert np.array_equal(p16[-100:], p32[-100:])
    body = p16[3:-100]
    assert np.array_equal(body, torch.from_numpy(p32[3:-100]).to(
        torch.bfloat16).float().numpy())
    assert not np.array_equal(body, p32[3:-100])
    with pytest.raises(ValueError, match="float32.*bfloat16"):
        _port("float16")
    model = get_model({**_auv_cfg(), "rk": 2}, dt=0.1, action_dim=6,
                      device="cpu")
    cost = get_cost(_task(), lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=SIGMA)
    with pytest.raises(ValueError, match="fused kernel path only"):
        MPPI(model, cost, k=10, tau=3, sigma=SIGMA, device="cpu",
             kernel_dtype="bfloat16")
