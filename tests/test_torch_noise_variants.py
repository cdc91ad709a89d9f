"""The scheduled and antithetic solves of the port against the JAX package.

- the mirrored Philox stream (XLA layout: z[half + i] = -z[i], half =
  ceil(K/2)) bit for bit, for K even and odd, and a weights phase on it
  against the update chain;
- the schedule's plain kernel versions (kernels/pm_mppi.py, auv_mppi.py,
  nn_mppi.py) against the JAX kernels on injected normals: the point mass
  against its Pallas kernel in interpret mode; the AUV and NN against the
  JAX XLA path (their Pallas kernels take minutes in interpret mode, and
  the JAX AUV kernel runs every rk != 1 as rk2);
- ``dyn`` with the schedule block against the JAX ``pack_dyn``;
- ten-step f64 closed loops of the port's ``MPPI`` against the JAX
  ``MPPI._solve_with_noise`` on schedule-scaled, mirrored eps, and the
  kernel path's glue (its solve objects on the CPU run their plain
  versions) against the port's plain path on the same Philox noise;
- ``set_noise_schedule``, the ``noise-schedule`` config key and
  ``resolve_noise_schedule`` in both packages.

The CUDA kernels are held against these plain versions on the card by
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_tf_tpu.controller import get_controller as jget_controller
from mppi_tf_tpu.controller.mppi import MPPI as JMPPI
from mppi_tf_tpu.costs import get_cost as jget_cost
from mppi_tf_tpu.kernels.pm_mppi import FusedPointMassMPPI as JFused
from mppi_tf_tpu.kernels.pm_mppi import chunk_noise
from mppi_tf_tpu.models import get_model as jget_model
from mppi_tf_tpu.ops import noise as jnoise
from mppi_tf_tpu_torch.controller import MPPI, get_controller
from mppi_tf_tpu_torch.costs import get_cost
from mppi_tf_tpu_torch.kernels import auv_mppi as auv
from mppi_tf_tpu_torch.kernels import nn_mppi as nnk
from mppi_tf_tpu_torch.kernels import pm_mppi as pm
from mppi_tf_tpu_torch.models import get_model
from mppi_tf_tpu_torch.ops import noise as tnoise
from mppi_tf_tpu_torch.ops import update as upd

SIGMA = np.diag([0.25, 0.3, 0.2])
LAM, GAMMA, UPS = 0.8, 0.2, 1.2
TASK = {"type": "static", "diag": True,
        "goal": [1.0, 0.0, 0.5, 0.0, -0.5, 0.0],
        "Q": [5.0, 1.0, 5.0, 1.0, 5.0, 1.0]}
MODEL = {"type": "point_mass", "mass": 1.3}
SCHED = {"type": "exp", "start": 1.0, "end": 0.25}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _sched(tau, spec=SCHED):
    return jnoise.resolve_noise_schedule(spec, tau)


def _mirror(z_half, k):
    """[half, ...] normals -> the antithetic [k, ...] draw of
    ops/noise.sample_noise_antithetic: rows half + i are -row i."""
    return np.concatenate([z_half, -z_half], axis=0)[:k]


# ---------------------------------------------------------------------------
# the mirrored Philox stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [600, 601])
def test_noise_plain_antithetic_mirrors_bit_for_bit(k):
    half = pm.antithetic_half(k)
    assert half == (k + 1) // 2
    z = pm.noise_plain(5, 2, k, 7, 3, half=half)
    assert torch.equal(z[..., half:], -z[..., :k - half])
    # the first half is the plain stream's first half; for odd k its last
    # sample (half - 1) has no mirror
    plain = pm.noise_plain(5, 2, k, 7, 3)
    assert torch.equal(z[..., :half], plain[..., :half])
    assert not torch.equal(z, plain)
    # the first samples of the solve, dumped with the solve's half
    head = pm.pm_noise_dump(5, 2, 128, 7, 3, "cpu", half=half)
    assert torch.equal(head, z[..., :128])
    # a mirror of the same layout as ops/noise.sample_noise_antithetic
    zk = z.permute(2, 0, 1).numpy()
    np.testing.assert_array_equal(zk, _mirror(zk[:half], k))


def test_antithetic_half():
    assert pm.antithetic_half(10) == 5 and pm.antithetic_half(11) == 6
    assert pm.antithetic_half(11, antithetic=False) == 0


@pytest.mark.parametrize("k", [500, 501])
def test_weights_on_mirrored_stream_equal_update_chain(k):
    """Phase B on the mirrored Philox stream (mppi_weights' plain version)
    == the normalized update chain on the same eps, at f64."""
    tau, adim = 6, 3
    rng = np.random.default_rng(k)
    costs = torch.as_tensor(rng.uniform(10.0, 90.0, size=k))
    beta, cmax = costs.min(), costs.max()
    nrm = torch.stack([beta, 1.0 / ((cmax - beta) * LAM)])
    zsum, stats = pm.merge_plain(pm.weights_plain(
        nrm, costs, tau, adim, seed=4, solve=9, block=64, antithetic=True))
    z = pm.noise_plain(4, 9, k, tau, adim,
                       half=pm.antithetic_half(k)).double()
    eps = z.permute(2, 0, 1)                            # [k, tau, adim]
    np.testing.assert_allclose(
        (zsum.reshape(tau, adim) / stats[1]).numpy(),
        upd.mppi_update(costs, eps, LAM, normalize=True).numpy(),
        rtol=1e-10, atol=1e-13)


# ---------------------------------------------------------------------------
# plain kernel versions against the JAX kernels (schedule)
# ---------------------------------------------------------------------------

def _pm_port(k, tau, **kw):
    model = get_model(MODEL, dt=0.1, state_dim=6, action_dim=3)
    cost = get_cost(TASK, lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=SIGMA)
    return pm.FusedPointMassMPPI(model, cost, k=k, tau=tau, lam=LAM,
                                 upsilon=UPS, sigma=SIGMA, **kw)


def _pm_jax(k, tau, schedule=SCHED, tile=256):
    model = jget_model(MODEL, dt=0.1, state_dim=6, action_dim=3)
    cost = jget_cost(TASK, lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=SIGMA)
    fused = JFused(model, cost, k=k, tau=tau, lam=LAM, upsilon=UPS,
                   sigma=SIGMA, tile=tile, interpret=True, schedule=schedule)
    return fused, model.init_params(), cost.init_params()


def _pm_inputs(k, tau, seed=3):
    rng = np.random.RandomState(seed)
    z_std = rng.randn(tau, 3, k).astype(np.float32)
    x0 = np.array([0.2, 0.0, -0.1, 0.0, 0.3, 0.0])
    useq = (0.1 * rng.randn(tau, 3)).astype(np.float32)
    return z_std, x0, useq


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("k,tau", [(700, 7), (512, 10)])
def test_pm_scheduled_plain_matches_pallas_interpret(k, tau, normalize):
    """The scheduled plain solve (pm_fused_solve + pm_merge, or
    pm_fused_costs + mppi_weights + merges) == the JAX Pallas kernel with
    the same schedule in interpret mode, injected normals, tile 256."""
    z_std, x0, useq = _pm_inputs(k, tau, seed=k + tau)
    jf, mp, cp = _pm_jax(k, tau)
    zc = jnp.asarray(chunk_noise(z_std, 256))
    wn_j, st_j = jf.solve(0, x0, useq, mp, cp, z=zc, use_prng=False,
                          normalize=normalize)
    fused = _pm_port(k, tau, schedule=SCHED)
    x0_t, useq_t, z_t = (torch.as_tensor(x0), torch.as_tensor(useq),
                         torch.as_tensor(z_std))
    wn_p, st_p = fused.solve(x0_t, useq_t, z=z_t, normalize=normalize)
    np.testing.assert_allclose(wn_p.numpy(), np.asarray(wn_j), rtol=1e-4,
                               atol=1e-4)
    for key in ("cost_min", "cost_max", "cost_mean", "nabla"):
        np.testing.assert_allclose(st_p[key].item(), float(st_j[key]),
                                   rtol=1e-4, atol=1e-4)
    costs_j, _ = jf.costs_phase(0, x0, useq, mp, cp, z=zc, use_prng=False)
    costs_p, _ = fused.costs_phase(x0_t, useq_t, z=z_t)
    np.testing.assert_allclose(costs_p.numpy(),
                               np.asarray(costs_j).reshape(-1)[:k],
                               rtol=1e-4, atol=1e-4)


def test_pm_pack_dyn_scheduled_matches_jax():
    k, tau = 300, 9
    _, x0, useq = _pm_inputs(k, tau, seed=4)
    jf, mp, cp = _pm_jax(k, tau)
    fused = _pm_port(k, tau, schedule=SCHED)
    ref = np.asarray(jf.pack_dyn(mp, cp, x0, useq))
    got = fused.pack_dyn(torch.as_tensor(x0), torch.as_tensor(useq))
    lay = pm.Dyn(tau, 6, 3, scheduled=True)
    assert got.shape == ref.shape == (lay.size,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[lay.sched:].numpy(), _sched(tau),
                               rtol=1e-7)


def _auv_pair(k, tau, normalize=False, schedule=SCHED, antithetic=False,
              rk=2):
    from tests.test_torch_auv_kernel import _jax, _port

    ctrl = _jax(k, tau, rk=rk, normalize=normalize)
    ctrl._sched = jnp.asarray(_sched(tau, schedule), jnp.float64)
    base = _port(k, tau, rk=rk)
    fused = auv.FusedAUVMPPI(base.model, base.cost, k=k, tau=tau,
                             lam=base.lam, upsilon=base.upsilon,
                             sigma=base._scale.numpy() / base.upsilon,
                             antithetic=antithetic, schedule=schedule)
    return ctrl, fused


def _jax_scheduled(ctrl, eps, x0, useq, precompute=True):
    """(weighted noise, per-sample costs) of the JAX XLA solve with the
    controller's schedule."""
    mp, cp = ctrl.model_params, ctrl._cparams
    _, _, info = ctrl._solve_with_noise_jit(
        jnp.asarray(eps), jnp.asarray(x0), jnp.asarray(useq), mp, cp,
        ctrl._sched)
    mpc = ctrl._model.precompute(mp) if precompute else mp
    costs = ctrl._rollout(jnp.asarray(x0), jnp.asarray(useq),
                          jnp.asarray(eps), mpc, cp, ctrl._sched)
    return np.asarray(info["weighted_noise"]), np.asarray(costs)


@pytest.mark.parametrize("normalize", [False, True])
def test_auv_scheduled_plain_matches_jax_xla(normalize):
    """The AUV kernel's scheduled plain versions (rk2) == the JAX XLA solve
    on eps = c_t scale z (the Pallas AUV kernel's interpret mode takes
    minutes)."""
    from tests.test_torch_auv_kernel import _inputs

    k, tau = 160, 5
    z, _, x0, useq = _inputs(k, tau, seed=7)
    ctrl, fused = _auv_pair(k, tau, normalize=normalize)
    c = _sched(tau)
    eps = np.einsum("ij,tjk->kti", fused._scale.numpy(), z) * c[None, :, None]
    wn_j, costs_j = _jax_scheduled(ctrl, eps, x0, useq)
    dyn = fused.pack_dyn(torch.as_tensor(x0), torch.as_tensor(useq))
    costs_p = auv.sample_costs_plain(fused.consts, dyn, torch.as_tensor(z))
    np.testing.assert_allclose(costs_p.numpy(), costs_j, rtol=1e-4,
                               atol=1e-4)
    wn_p, _ = fused.solve(torch.as_tensor(x0), torch.as_tensor(useq),
                          z=torch.as_tensor(z), normalize=normalize)
    scale = np.abs(wn_j).max()
    np.testing.assert_allclose(wn_p.numpy(), wn_j, rtol=1e-4,
                               atol=1e-4 * scale)


def _nn_pair(k, tau, normalize=False, schedule=SCHED, antithetic=False):
    from tests.test_torch_nn_kernel import _jax, _port

    ctrl = _jax((8, 8), k, tau, normalize=normalize)
    ctrl._sched = jnp.asarray(_sched(tau, schedule), jnp.float64)
    base = _port(ctrl)
    fused = nnk.FusedNNMPPI(base.model, base.cost, k=k, tau=tau,
                            lam=base.lam, upsilon=base.upsilon,
                            sigma=base._scale.numpy() / base.upsilon,
                            antithetic=antithetic, schedule=schedule)
    return ctrl, fused


@pytest.mark.parametrize("normalize", [False, True])
def test_nn_scheduled_plain_matches_jax_xla(normalize):
    """The NN kernel's scheduled plain versions == the JAX XLA solve on
    eps = c_t scale z (the Pallas NN kernel's interpret mode takes
    minutes)."""
    from tests.test_torch_nn_kernel import _inputs

    k, tau = 160, 5
    z, _, x0, useq = _inputs(k, tau, seed=8)
    ctrl, fused = _nn_pair(k, tau, normalize=normalize)
    c = _sched(tau)
    eps = np.einsum("ij,tjk->kti", fused._scale.numpy(), z) * c[None, :, None]
    wn_j, costs_j = _jax_scheduled(ctrl, eps, x0, useq, precompute=False)
    dyn = fused.pack_dyn(torch.as_tensor(x0), torch.as_tensor(useq))
    costs_p = nnk.sample_costs_plain(fused.consts, dyn, torch.as_tensor(z))
    np.testing.assert_allclose(costs_p.numpy(), costs_j, rtol=1e-4,
                               atol=1e-4)
    wn_p, _ = fused.solve(torch.as_tensor(x0), torch.as_tensor(useq),
                          z=torch.as_tensor(z), normalize=normalize)
    scale = np.abs(wn_j).max()
    np.testing.assert_allclose(wn_p.numpy(), wn_j, rtol=1e-4,
                               atol=1e-4 * scale)


def test_auv_pack_dyn_scheduled_matches_jax():
    from mppi_tf_tpu.kernels.auv_mppi import FusedAUVMPPI as JAuv
    from tests.test_torch_auv_kernel import _inputs

    k, tau = 64, 6
    _, _, x0, useq = _inputs(k, tau, seed=2)
    ctrl, fused = _auv_pair(k, tau)
    jf = JAuv(ctrl._model, ctrl._cost, k=k, tau=tau, lam=fused.lam,
              upsilon=fused.upsilon,
              sigma=fused._scale.numpy() / fused.upsilon, tile=64,
              interpret=True, schedule=SCHED)
    ref = np.asarray(jf.pack_dyn(ctrl.model_params, ctrl._cparams, x0,
                                 useq))
    got = fused.pack_dyn(torch.as_tensor(x0), torch.as_tensor(useq))
    lay = auv.Dyn(tau, scheduled=True)
    assert got.shape == ref.shape == (lay.size,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# ten-step closed loops at f64 against the JAX package
# ---------------------------------------------------------------------------

def _pm_modules_f64():
    task = {"type": "static", "goal": [1.0, 0.0, 0.0, 0.0, 0.0, 0.0],
            "Q": np.eye(6).tolist()}
    mcfg = {"type": "point_mass", "mass": 1.5, "limMax": 0.6, "limMin": -0.6}
    kw = dict(lam=1.2, gamma=1.1, upsilon=2.0, sigma=SIGMA)
    port = (get_model(mcfg, dt=0.1, state_dim=6, action_dim=3,
                      dtype=torch.float64),
            get_cost(task, dtype=torch.float64, **kw))
    ref = (jget_model(mcfg, dt=0.1, state_dim=6, action_dim=3,
                      dtype=jnp.float64),
           jget_cost(task, dtype=jnp.float64, **kw))
    return port, ref


def _closed_loop(port, ref, jm, scale, k, tau, x0, rtol, seed):
    """Ten steps of the port's and the JAX _solve_with_noise on the same
    mirrored, schedule-scaled eps; the plants are the packages' own
    models."""
    mp, cp = ref.model_params, ref._cparams
    c = np.asarray(port._sched.numpy(), np.float64)
    np.testing.assert_allclose(c, np.asarray(ref._sched), rtol=1e-15)
    rng = np.random.default_rng(seed)
    adim = scale.shape[0]
    x_p = x_j = x0
    useq_p = torch.zeros(tau, adim, dtype=torch.float64)
    useq_j = jnp.zeros((tau, adim), jnp.float64)
    for _ in range(10):
        z = _mirror(rng.normal(size=((k + 1) // 2, tau, adim)), k)
        eps = np.einsum("ij,ktj->kti", scale, z) * c[None, :, None]
        a_p, useq_p, info_p = port._solve_with_noise(
            torch.as_tensor(eps), torch.as_tensor(x_p), useq_p, port._sched)
        a_j, useq_j, info_j = ref._solve_with_noise_jit(
            jnp.asarray(eps), jnp.asarray(x_j), useq_j, mp, cp, ref._sched)
        big = np.abs(np.asarray(useq_j)).max()
        np.testing.assert_allclose(a_p.numpy(), np.asarray(a_j), rtol=rtol,
                                   atol=1e-12 * big)
        np.testing.assert_allclose(useq_p.numpy(), np.asarray(useq_j),
                                   rtol=rtol, atol=1e-12 * big)
        np.testing.assert_allclose(info_p["cost_mean"].item(),
                                   float(info_j["cost_mean"]), rtol=rtol)
        with torch.no_grad():
            x_p = port._model.predict(torch.as_tensor(x_p), a_p).numpy()
        x_j = np.asarray(jm.predict(jm.precompute(mp), jnp.asarray(x_j),
                                    a_j))
    np.testing.assert_allclose(x_p, x_j, rtol=rtol, atol=1e-12)


@pytest.mark.parametrize("normalize", [False, True],
                         ids=["plain", "normalize"])
def test_pm_scheduled_antithetic_closed_loop_matches_jax(normalize):
    (pm_, pc), (jm, jc) = _pm_modules_f64()
    kw = dict(k=61, tau=10, lam=1.2, upsilon=2.0, sigma=SIGMA,
              noise_schedule=SCHED, antithetic=True,
              normalize_cost=normalize, clip_actions=True)
    port = MPPI(pm_, pc, device="cpu", **kw)
    ref = JMPPI(jm, jc, **kw)
    _closed_loop(port, ref, jm, 2.0 * SIGMA, 61, 10, np.full(6, 0.3),
                 rtol=1e-10, seed=41)


def test_auv_scheduled_antithetic_closed_loop_matches_jax():
    """rexrov2-style AUV (rk2) in both packages, mirrored eps."""
    from mppi_tf_tpu import flagship as jflagship
    from mppi_tf_tpu_torch import flagship

    sigma = np.diag([40.0, 40.0, 40.0, 5.0, 5.0, 5.0])
    kw = dict(k=64, tau=6, lam=0.5, upsilon=1.2, sigma=sigma,
              noise_schedule=SCHED, antithetic=True)
    port = MPPI(get_model(flagship.auv_params(), dt=0.1,
                          dtype=torch.float64),
                get_cost(flagship.auv_task(), lam=0.5, gamma=0.2,
                         upsilon=1.2, sigma=sigma, dtype=torch.float64),
                device="cpu", **kw)
    jm = jget_model(jflagship.auv_params(), dt=0.1, dtype=jnp.float64)
    ref = JMPPI(jm, jget_cost(jflagship.auv_task(), lam=0.5, gamma=0.2,
                              upsilon=1.2, sigma=sigma, dtype=jnp.float64),
                **kw)
    x0 = np.zeros(13)
    x0[[2, 6]] = [-1.0, 1.0]
    _closed_loop(port, ref, jm, 1.2 * sigma, 64, 6, x0, rtol=1e-10,
                 seed=42)


def test_nn_scheduled_antithetic_closed_loop_matches_jax():
    """NNAUVModel (8, 8) with trained-like normalisers in both packages."""
    import jax

    from mppi_tf_tpu_torch.interop import from_jax_params
    from mppi_tf_tpu_torch.models import nn as pnn
    from tests.test_torch_nn_kernel import SIGMA as NN_SIGMA
    from tests.test_torch_nn_kernel import TASK as NN_TASK
    from tests.test_torch_nn_kernel import _jax

    kw = dict(k=64, tau=6, lam=0.5, upsilon=1.2, sigma=NN_SIGMA,
              noise_schedule=SCHED, antithetic=True)
    jctrl = _jax((8, 8), 64, 6)
    ref = JMPPI(jctrl._model, jctrl._cost, **kw)
    ref.model_params = jctrl.model_params
    model = pnn.NNAUVModel(hidden=(8, 8), dtype=torch.float64)
    from_jax_params(jax.tree.map(np.asarray, ref.model_params), None, model)
    port = MPPI(model, get_cost(NN_TASK, lam=0.5, gamma=0.2, upsilon=1.2,
                                sigma=NN_SIGMA, dtype=torch.float64),
                device="cpu", **kw)
    x0 = np.zeros(13)
    x0[6] = 1.0
    _closed_loop(port, ref, jctrl._model, 1.2 * NN_SIGMA, 64, 6, x0,
                 rtol=1e-10, seed=43)


def _h100_loop(package, normalize, k=1000, steps=300):
    """The point_mass_h100 workload (mppi_tf_tpu/bench.py:83-106: H=100,
    exp schedule 1 -> 0.25) at K=``k``: goal errors of each step."""
    from mppi_tf_tpu_torch.envs import PointMassEnv

    task, goal, sigma = TASK, TASK["goal"], np.diag([0.25] * 3)
    cfg = {"samples": k, "horizon": 100, "lambda": 0.8, "upsilon": 1.0,
           "noise": sigma.tolist(), "normalize": normalize,
           "noise-schedule": SCHED}
    mcfg = {"type": "point_mass", "mass": 1.0}
    if package == "jax":
        ctrl = jget_controller(
            jget_model(mcfg, dt=0.1, state_dim=6, action_dim=3),
            jget_cost(task, lam=0.8, gamma=0.2, upsilon=1.0, sigma=sigma),
            dict(cfg, kernel="xla"), seed=0)
    else:
        ctrl = get_controller(
            get_model(mcfg, dt=0.1, state_dim=6, action_dim=3),
            get_cost(task, lam=0.8, gamma=0.2, upsilon=1.0, sigma=sigma),
            cfg, device="cpu")
    env = PointMassEnv(n_dof=3, mass=1.0, dt=0.1)
    x, errs = env.reset(), []
    for _ in range(steps):
        x = env.step(ctrl.next(x))
        errs.append(float(np.linalg.norm(x.ravel() - np.asarray(goal))))
    return np.asarray(errs)


def test_point_mass_h100_loops_in_both_packages():
    """The H=100 scheduled loop settles near the goal in normalized mode
    and keeps a larger error unnormalized (its softmax over 100-step costs
    is near one-hot), in both packages alike: chip_smoke's pm_sched gates
    the unnormalized loop on its mean error over the last 100 steps."""
    window = {(pkg, norm): _h100_loop(pkg, norm)[-100:].mean()
              for pkg in ("port", "jax") for norm in (False, True)}
    for pkg in ("port", "jax"):
        assert window[pkg, True] < 0.1
        assert window[pkg, False] > 2.0 * window[pkg, True]
    assert 0.5 < window["port", False] / window["jax", False] < 2.0


# ---------------------------------------------------------------------------
# the kernel path's glue on the CPU against the port's plain path
# ---------------------------------------------------------------------------

def _attach(ctrl, cls):
    """Give a CPU controller a fused solve object with its options; the
    wrappers then run their plain versions."""
    ctrl._fused = cls(ctrl._model, ctrl._cost, k=ctrl._k, tau=ctrl._tau,
                      lam=ctrl._lam, upsilon=ctrl._upsilon,
                      sigma=ctrl._sigma.numpy(),
                      antithetic=ctrl._antithetic,
                      schedule=None if ctrl._sched is None
                      else ctrl._sched.numpy())
    return ctrl


@pytest.mark.parametrize("normalize", [False, True],
                         ids=["plain", "normalize"])
@pytest.mark.parametrize("model_kind", ["point_mass", "auv", "nn"])
def test_fused_step_matches_plain_path(model_kind, normalize):
    """Three steps of the kernel path (scheduled, antithetic, log mode) ==
    the plain solve on eps = c_t scale z of the mirrored Philox stream of
    each (seed, solve): actions, sequences, log keys, the noise sample."""
    from tests.test_torch_controller import _auv_modules, _modules

    k, tau = 301, 5
    if model_kind == "point_mass":
        (m, c), _ = _modules()
        m, c = m.float(), c.float()
        cls, x0, sigma = pm.FusedPointMassMPPI, np.full(6, 0.2), SIGMA
        kw = dict(lam=1.2, upsilon=2.0)
    elif model_kind == "auv":
        (m, c), cls = _auv_modules(), auv.FusedAUVMPPI
        x0, sigma = np.zeros(13), np.diag([40.0] * 3 + [5.0] * 3)
        x0[[2, 6]] = [-1.0, 1.0]
        kw = dict(lam=0.5, upsilon=1.2)
    else:
        ctrl_j, fz = _nn_pair(k, tau)
        m, c, cls = fz.model, fz.cost, nnk.FusedNNMPPI
        x0, sigma = np.zeros(13), fz._scale.numpy() / fz.upsilon
        x0[6] = 1.0
        kw = dict(lam=0.5, upsilon=1.2)
    kw.update(k=k, tau=tau, sigma=sigma, normalize_cost=normalize, seed=7,
              noise_schedule=SCHED, antithetic=True, log=True, device="cpu")
    fused = _attach(MPPI(m, c, **kw), cls)
    plain = MPPI(m, c, **kw)
    tol = (dict(rtol=1e-9, atol=1e-9) if m.dtype == torch.float64
           else dict(rtol=2e-4, atol=1e-5))
    cvec = fused._fused.sched
    state = torch.as_tensor(x0, dtype=m.dtype)
    useq = torch.zeros(tau, m.get_action_dim(), dtype=m.dtype)
    for step in range(3):
        fused._steps = step
        a_f, seq_f, info_f = fused._fused_step(state, useq)
        z = pm.noise_plain(7, step, k, tau, m.get_action_dim(),
                           half=pm.antithetic_half(k)).to(m.dtype)
        eps = torch.einsum("ij,tjk->kti", fused._fused._scale, z) \
            * cvec[None, :, None]
        a_p, seq_p, info_p = plain._solve_with_noise(eps, state, useq,
                                                     plain._sched)
        for key in ("sample_costs", "weights", "nabla", "arg", "noise",
                    "weighted_noise"):
            torch.testing.assert_close(info_f[key], info_p[key], **tol)
        torch.testing.assert_close(seq_f, seq_p, **tol)
        torch.testing.assert_close(a_f, a_p, **tol)
        useq = seq_p
        state = state + 0.01


# ---------------------------------------------------------------------------
# the controller surface
# ---------------------------------------------------------------------------

def test_set_noise_schedule_in_both_packages():
    (pm_, pc), (jm, jc) = _pm_modules_f64()
    kw = dict(k=32, tau=4, lam=1.2, upsilon=2.0, sigma=SIGMA,
              noise_schedule={"type": "constant", "value": 1.0})
    port = _attach(MPPI(pm_.float(), pc.float(), device="cpu", **kw),
                   pm.FusedPointMassMPPI)
    ref = JMPPI(jm, jc, **kw)
    new = {"type": "linear", "start": 1.0, "end": 0.1}
    port.set_noise_schedule(new)
    ref.set_noise_schedule(new)
    np.testing.assert_allclose(port._sched.numpy(), np.asarray(ref._sched),
                               rtol=1e-6)
    np.testing.assert_allclose(port._fused.sched.numpy(),
                               np.linspace(1.0, 0.1, 4), rtol=1e-6)
    # the solve object keeps its layout: new data, the same dyn size
    dyn = port._fused.pack_dyn(torch.zeros(6), torch.zeros(4, 3))
    assert dyn.shape == (pm.Dyn(4, 6, 3, scheduled=True).size,)
    np.testing.assert_allclose(dyn[-4:].numpy(), np.linspace(1.0, 0.1, 4),
                               rtol=1e-6)
    for ctrl in (MPPI(pm_, pc, device="cpu", k=32, tau=4, sigma=SIGMA),
                 JMPPI(jm, jc, k=32, tau=4, sigma=SIGMA)):
        with pytest.raises(ValueError, match="without a noise_schedule"):
            ctrl.set_noise_schedule([1.0] * 4)


def test_constant_one_schedule_solves_like_unscheduled():
    """A controller whose schedule was set to c_t = 1 takes the same step
    as an unscheduled one on the same seed and solve index (kernel path
    glue on the CPU; u_half is summed in another order)."""
    (pm_, pc), _ = _pm_modules_f64()
    m, c = pm_.float(), pc.float()
    kw = dict(k=300, tau=8, lam=1.2, upsilon=2.0, sigma=SIGMA, seed=3,
              device="cpu")
    sched = _attach(MPPI(m, c, noise_schedule=SCHED, **kw),
                    pm.FusedPointMassMPPI)
    sched.set_noise_schedule({"type": "constant", "value": 1})
    flat = _attach(MPPI(m, c, **kw), pm.FusedPointMassMPPI)
    x = np.full(6, 0.2)
    np.testing.assert_allclose(sched.next(x), flat.next(x), rtol=1e-5,
                               atol=1e-7)


def test_noise_schedule_config_key_in_both_packages():
    (pm_, pc), (jm, jc) = _pm_modules_f64()
    cfg = {"samples": 8, "horizon": 3, "lambda": 0.8, "upsilon": 1.2,
           "noise": SIGMA.tolist(), "antithetic": True,
           "noise-schedule": {"type": "exp", "start": 1.0, "end": 0.5}}
    port = get_controller(pm_, pc, cfg, device="cpu")
    ref = jget_controller(jm, jc, cfg)
    np.testing.assert_allclose(port._sched.numpy(), np.asarray(ref._sched),
                               rtol=1e-12)
    np.testing.assert_allclose(port._sched.numpy(),
                               np.geomspace(1.0, 0.5, 3), rtol=1e-12)
    assert port._antithetic and ref._antithetic


@pytest.mark.parametrize("spec", [
    None, [1, 2, 3, 4, 5], {"type": "constant", "value": 0.5},
    {"type": "linear", "start": 1.0, "end": 0.2},
    {"type": "exp", "start": 1.0, "end": 0.25},
    {"type": "cosine", "start": 1.0, "end": 0.2}])
def test_resolve_noise_schedule_specs_match_jax(spec):
    """The specs of tests/test_noise_schedule.py::test_resolve_specs."""
    port = tnoise.resolve_noise_schedule(spec, 5)
    ref = jnoise.resolve_noise_schedule(spec, 5)
    if spec is None:
        assert port is None and ref is None
        return
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("spec,match", [
    ([1.0, 2.0], "length tau"), ([1.0, 0.0, 1.0, 1.0, 1.0], "positive"),
    ({"type": "linear", "start": 1.0, "end": -0.5}, "positive"),
    ({"type": "warble"}, "unknown noise_schedule type")])
def test_resolve_noise_schedule_rejects_like_jax(spec, match):
    for resolve in (tnoise.resolve_noise_schedule,
                    jnoise.resolve_noise_schedule):
        with pytest.raises(ValueError, match=match):
            resolve(spec, 5)


def test_variant_launch_arguments():
    fused = _pm_port(701, 4, antithetic=True, schedule=SCHED)
    assert pm.variant_args(fused.consts, 701) == (1, 351)
    assert pm.variant_args(_pm_port(701, 4).consts, 701) == (0, 0)
    assert fused.template_args("pm_fused_costs") == (6, 3, 1, 0, 0, 1)
    assert fused.template_args("mppi_weights") == ()
