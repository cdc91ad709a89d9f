"""The dynamic_ab variant of the fused point-mass solve (kernels/pm_mppi.py
FusedLTIMPPI, the kDynAB instantiation of pm_fused_solve / pm_fused_costs):
its packing and plain versions against the JAX package's FusedLTIMPPI
(Pallas interpret mode, injected normals), before and after a refit
through the same solve object, against the constant-(A, B) point-mass
solve on the same map, and the model-domain guards. The CUDA kernels are
held against these plain versions on the card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_tf_tpu.costs import get_cost as jget_cost
from mppi_tf_tpu.kernels.pm_mppi import FusedLTIMPPI as JLTI
from mppi_tf_tpu.kernels.pm_mppi import chunk_noise
from mppi_tf_tpu.models.dmd import DMDModel as JDMDModel
from mppi_tf_tpu_torch.controller import MPPI
from mppi_tf_tpu_torch.controller.dmd import DMDMPPI
from mppi_tf_tpu_torch.costs import get_cost
from mppi_tf_tpu_torch.interop import from_jax_params
from mppi_tf_tpu_torch.kernels import pm_mppi as pm
from mppi_tf_tpu_torch.kernels.errors import KernelUnsupportedError
from mppi_tf_tpu_torch.models import get_model
from mppi_tf_tpu_torch.models.dmd import DMDModel

SIGMA = np.diag([0.25, 0.3, 0.2])
LAM, GAMMA, UPS = 0.8, 0.2, 1.2
TASK = {"type": "static", "diag": True,
        "goal": [1.0, 0.0, 0.5, 0.0, -0.5, 0.0],
        "Q": [5.0, 1.0, 5.0, 1.0, 5.0, 1.0]}
SCHED = {"type": "exp", "start": 1.0, "end": 0.25}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _dense_ab(seed=5):
    """The dense random (A, B) of tests/test_pallas_kernel.py:386-408 and
    the generator that made them."""
    rng = np.random.RandomState(seed)
    A = np.eye(6) + 0.05 * rng.randn(6, 6)
    B = 0.1 * rng.randn(6, 3)
    return A, B, rng


def _jax(k, tau, A, B, schedule=None, tile=256):
    model = JDMDModel(6, 3, init_A=A, init_B=B, dtype=jnp.float32)
    cost = jget_cost(TASK, lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=SIGMA)
    fused = JLTI(model, cost, k=k, tau=tau, lam=LAM, upsilon=UPS,
                 sigma=SIGMA, tile=tile, interpret=True, schedule=schedule)
    return fused, model.init_params(), cost.init_params()


def _port(k, tau, A, B, **kw):
    model = DMDModel(6, 3, init_A=A, init_B=B)
    cost = get_cost(TASK, lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=SIGMA)
    return pm.FusedLTIMPPI(model, cost, k=k, tau=tau, lam=LAM, upsilon=UPS,
                           sigma=SIGMA, **kw), model


def _inputs(rng, k, tau):
    z_std = rng.randn(tau, 3, k).astype(np.float32)
    x0 = np.array([0.2, 0.0, -0.1, 0.0, 0.3, 0.0])
    useq = (0.1 * rng.randn(tau, 3)).astype(np.float32)
    return z_std, x0, useq


@pytest.mark.parametrize("schedule", [None, SCHED], ids=["flat", "sched"])
def test_pack_dyn_matches_jax(schedule):
    """Element by element in JAX's _Dyn order, the A and B scale blocks
    after u_half; the port packs inv_mass = 1 where JAX leaves the unused
    slot 0."""
    k, tau = 300, 9
    A, B, rng = _dense_ab()
    _, x0, useq = _inputs(rng, k, tau)
    jf, mp, cp = _jax(k, tau, A, B, schedule=schedule)
    fused, _ = _port(k, tau, A, B, schedule=schedule)
    ref = np.asarray(jf.pack_dyn(mp, cp, x0, useq))
    got = fused.pack_dyn(torch.as_tensor(x0), torch.as_tensor(useq))
    lay = pm.Dyn(tau, 6, 3, dynamic_ab=True, scheduled=schedule is not None)
    assert got.shape == ref.shape == (lay.size,)
    assert lay.size == 1 + 12 + tau * 9 + 1 + 54 + (tau if schedule else 0)
    assert got[0].item() == 1.0 and ref[0] == 0.0
    np.testing.assert_allclose(got[1:].numpy(), ref[1:], rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(got[lay.A:lay.Bs].numpy(),
                                  A.astype(np.float32).ravel())


@pytest.mark.parametrize("normalize", [False, True])
def test_plain_lti_matches_pallas_interpret_and_refits(normalize):
    """The plain dynamic_ab solve (pm_fused_solve + pm_merge, or
    pm_fused_costs + mppi_weights + merges) and its costs == the JAX
    FusedLTIMPPI in interpret mode on injected normals (K=700, H=7, tile
    256) at rtol 1e-4; then a refit, new (A, B) written into the model in
    place, through the same solve object."""
    k, tau = 700, 7
    A, B, rng = _dense_ab()
    z_std, x0, useq = _inputs(rng, k, tau)
    jf, mp, cp = _jax(k, tau, A, B)
    fused, model = _port(k, tau, A, B)
    zc = jnp.asarray(chunk_noise(z_std, 256))
    args = torch.as_tensor(x0), torch.as_tensor(useq)
    z_t = torch.as_tensor(z_std)
    mp2 = {"A": np.eye(6) + 0.02 * rng.randn(6, 6),
           "B": 0.15 * rng.randn(6, 3)}
    for params in (mp, mp2):
        jmp = {key: jnp.asarray(v, jnp.float32) for key, v in params.items()}
        if params is mp2:
            from_jax_params(params, None, model)
        wn_j, st_j = jf.solve(0, x0, useq, jmp, cp, z=zc, use_prng=False,
                              normalize=normalize)
        wn_p, st_p = fused.solve(*args, z=z_t, normalize=normalize)
        np.testing.assert_allclose(wn_p.numpy(), np.asarray(wn_j),
                                   rtol=1e-4, atol=1e-4)
        for key in ("cost_min", "cost_max", "cost_mean", "nabla"):
            np.testing.assert_allclose(st_p[key].item(), float(st_j[key]),
                                       rtol=1e-4, atol=1e-4)
        costs_j, _ = jf.costs_phase(0, x0, useq, jmp, cp, z=zc,
                                    use_prng=False)
        costs_p, _ = fused.costs_phase(*args, z=z_t)
        np.testing.assert_allclose(costs_p.numpy(),
                                   np.asarray(costs_j).reshape(-1)[:k],
                                   rtol=1e-4, atol=1e-4)


def test_seeded_dmd_costs_equal_the_point_mass_kernel():
    """A DMD model seeded with the point mass's (A, B) at mass 1 (the JAX
    bench's dmd row): the plain dynamic_ab costs equal the plain
    constant-(A, B) costs of FusedPointMassMPPI on the same z."""
    sigma = np.diag([0.25, 0.25, 0.25])
    pmod = get_model({"type": "point_mass", "mass": 1.0}, dt=0.1,
                     state_dim=6, action_dim=3)
    dmd = DMDModel(6, 3, init_A=pmod.A.numpy(), init_B=pmod.B.numpy())
    cost = get_cost(TASK, lam=0.8, gamma=0.2, upsilon=1.0, sigma=sigma)
    kw = dict(k=600, tau=12, lam=0.8, upsilon=1.0, sigma=sigma)
    const = pm.FusedPointMassMPPI(pmod, cost, **kw)
    lti = pm.FusedLTIMPPI(dmd, cost, **kw)
    rng = np.random.default_rng(2)
    z = torch.as_tensor(rng.standard_normal((12, 3, 600), np.float32))
    x0 = torch.as_tensor(rng.standard_normal(6), dtype=torch.float32)
    useq = torch.as_tensor(0.1 * rng.standard_normal((12, 3)),
                           dtype=torch.float32)
    c_const, st_const = const.costs_phase(x0, useq, z=z)
    c_lti, st_lti = lti.costs_phase(x0, useq, z=z)
    np.testing.assert_allclose(c_lti.numpy(), c_const.numpy(), rtol=1e-6)
    wn_c, _ = const.solve(x0, useq, z=z)
    wn_l, _ = lti.solve(x0, useq, z=z)
    np.testing.assert_allclose(wn_l.numpy(), wn_c.numpy(), rtol=1e-5,
                               atol=1e-7)


def test_model_domain_guards():
    """FusedLTIMPPI takes DMDModel only and FusedPointMassMPPI keeps
    refusing it (JAX tests/test_pallas_kernel.py:479-495)."""
    cost = get_cost(TASK, lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=SIGMA)
    pmod = get_model({"type": "point_mass", "mass": 1.3}, dt=0.1,
                     state_dim=6, action_dim=3)
    kw = dict(k=64, tau=4, lam=LAM, upsilon=UPS, sigma=SIGMA)
    with pytest.raises(KernelUnsupportedError, match="DMDModel"):
        pm.FusedLTIMPPI(pmod, cost, **kw)
    with pytest.raises(KernelUnsupportedError, match="PointMassModel"):
        pm.FusedPointMassMPPI(DMDModel(6, 3), cost, **kw)
    with pytest.raises(KernelUnsupportedError, match="float32"):
        pm.FusedLTIMPPI(DMDModel(6, 3, dtype=torch.float64), cost, **kw)
    lti = pm.FusedLTIMPPI(DMDModel(6, 3), cost, **kw)
    assert lti.consts.dynamic_ab and not lti.consts.A.any()
    assert lti.template_args("pm_fused_solve") == (6, 3, 0, 0, 1, 0)
    assert lti.template_args("pm_fused_costs") == (6, 3, 1, 0, 1, 0)
    # the card's input check wants the larger dyn of the variant
    with pytest.raises(ValueError, match="dyn"):
        pm._check_solve_inputs("pm_fused_solve", lti.consts,
                               torch.zeros(pm.Dyn(4, 6, 3).size), None, 64,
                               4)
    pm._check_solve_inputs("pm_fused_solve", lti.consts, torch.zeros(
        pm.Dyn(4, 6, 3, dynamic_ab=True).size), None, 64, 4)


def _dmd_ctrl(sdim=6, adim=3, **kw):
    sigma = np.diag([0.25] * adim)
    task = {"type": "static", "diag": True, "goal": [0.5] * sdim,
            "Q": [1.0] * sdim}
    return DMDMPPI(DMDModel(sdim, adim, **kw),
                   get_cost(task, lam=0.8, gamma=0.2, upsilon=1.0,
                            sigma=sigma),
                   k=256, tau=6, lam=0.8, upsilon=1.0, sigma=sigma,
                   refit_every=5, device="cpu"), sigma


def test_resolve_kernel_order_and_unbuilt_dims(monkeypatch):
    """_resolve_kernel tries (FusedPointMassMPPI, FusedLTIMPPI,
    FusedAUVMPPI): a DMD model lands on FusedLTIMPPI. On a CUDA model,
    dims the kernel is not built for raise under "cuda" and stay on the
    torch path under "auto"; kernel="cuda" on the CPU still raises."""
    ctrl, sigma = _dmd_ctrl()
    ctrl._resolve_kernel("auto", sigma, None)
    assert type(ctrl._fused) is pm.FusedLTIMPPI
    assert ctrl.kernel_path == "cuda"
    with pytest.raises(ValueError, match="CUDA device"):
        MPPI(DMDModel(6, 3), ctrl._cost, k=8, tau=3, sigma=sigma,
             kernel="cuda", device="cpu")
    odd, sigma1 = _dmd_ctrl(3, 1)
    monkeypatch.setattr(DMDModel, "device",
                        property(lambda self: torch.device("cuda")))
    odd._resolve_kernel("auto", sigma1, None)
    assert odd._fused is None and odd.kernel_path == "torch"
    with pytest.raises(KernelUnsupportedError):
        odd._resolve_kernel("cuda", sigma1, None)


def test_refit_changes_the_next_fused_solve():
    """DMDMPPI on the fused solve object (plain versions on the CPU): a
    refit through save() reaches the next solve, which equals a solve
    object built after the refit; nothing of the prior (A, B) is kept."""
    ctrl, sigma = _dmd_ctrl(reg=1e-8)
    ctrl._resolve_kernel("auto", sigma, None)
    fused = ctrl._fused
    x = torch.full((6,), 0.1)
    useq = torch.zeros(6, 3)
    wn0, _ = fused.solve(x, useq, seed=3, solve=1)
    rng = np.random.default_rng(4)
    pmod = get_model({"type": "point_mass", "mass": 2.0}, dt=0.1,
                     state_dim=6, action_dim=3, dtype=torch.float64)
    A, B = pmod.A.numpy(), pmod.B.numpy() / 2.0
    xs = np.zeros(6)
    for _ in range(20):
        u = rng.uniform(-1.0, 1.0, 3)
        ctrl.save(xs, u, A @ xs + B @ u)
        xs = A @ xs + B @ u
    assert ctrl.n_fits == 1 and ctrl._fused is fused
    wn1, _ = fused.solve(x, useq, seed=3, solve=1)
    fresh = pm.FusedLTIMPPI(ctrl._model, ctrl._cost, k=256, tau=6, lam=0.8,
                            upsilon=1.0, sigma=sigma)
    wn_fresh, _ = fresh.solve(x, useq, seed=3, solve=1)
    assert (wn1 - wn0).abs().max() > 1e-3
    np.testing.assert_array_equal(wn1.numpy(), wn_fresh.numpy())
    np.testing.assert_allclose(ctrl.model_params["B"].numpy(), B, atol=1e-4)
    # the controller's own step runs the fused solve with the new (A, B)
    assert np.all(np.isfinite(ctrl.next(np.zeros(6))))
