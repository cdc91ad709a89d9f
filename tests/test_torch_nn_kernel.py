"""The fused NN solve of the port (kernels/nn_mppi.py): its plain versions
against the JAX package's XLA path (``MPPI._solve_with_noise`` /
``_rollout``) at f64 on the same injected normals, with non-trivial X/Y
normalisers so that the fold of ``pack_dyn`` is exercised. The XLA path is
the yardstick the JAX Pallas NN kernel is itself held to
(tests/test_nn_kernel.py, whose interpret mode takes minutes). The CUDA
kernels are held against these plain versions on the card by
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_tf_tpu.controller.mppi import MPPI as JMPPI
from mppi_tf_tpu.costs import get_cost as jget_cost
from mppi_tf_tpu.kernels.nn_mppi import FusedNNMPPI as JFusedNNMPPI
from mppi_tf_tpu.kernels.nn_mppi import _DynNN
from mppi_tf_tpu.models.nn import NNAUVModel as JNNAUVModel
from mppi_tf_tpu_torch.costs import get_cost
from mppi_tf_tpu_torch.interop import from_jax_params
from mppi_tf_tpu_torch.kernels import nn_mppi as nnk
from mppi_tf_tpu_torch.kernels import pm_mppi as pm
from mppi_tf_tpu_torch.kernels.errors import KernelUnsupportedError
from mppi_tf_tpu_torch.models import nn as pnn
from tests.test_nn_kernel import _mp_with_stats

SIGMA = np.diag([50.0, 50.0, 50.0, 20.0, 20.0, 20.0])
LAM, GAMMA, UPS = 0.5, 0.2, 1.2
TASK = {"type": "static_quat", "diag": True,
        "goal": [0.0, 0.0, -2.0, 0.0, 0.0, 0.0, 1.0] + [0.0] * 6,
        "Q": [10.0, 10.0, 10.0, 5.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]}
# f64 on both sides: the folded algebra against normalize -> MLP ->
# denormalize, agreeing to rounding
RTOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax(hidden, k, tau, normalize=False):
    model = JNNAUVModel(action_dim=6, dt=0.1, hidden=hidden, seed=4,
                        dtype=jnp.float64)
    cost = jget_cost(TASK, lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=SIGMA,
                     dtype=jnp.float64)
    ctrl = JMPPI(model, cost, k=k, tau=tau, lam=LAM, upsilon=UPS,
                 sigma=SIGMA, normalize_cost=normalize)
    ctrl.model_params = _mp_with_stats(model)
    return ctrl


def _port_model(ctrl, dtype=torch.float64):
    model = pnn.NNAUVModel(hidden=ctrl._model._hidden, dtype=dtype)
    from_jax_params(jax.tree.map(np.asarray, ctrl.model_params), None, model)
    return model


def _port(ctrl, dtype=torch.float64):
    cost = get_cost(TASK, lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=SIGMA,
                    dtype=dtype)
    return nnk.FusedNNMPPI(_port_model(ctrl, dtype), cost, k=ctrl._k,
                           tau=ctrl._tau, lam=LAM, upsilon=UPS, sigma=SIGMA)


def _inputs(k, tau, seed=0):
    """z [tau, 6, k], eps = scale z as [k, tau, 6], x0 (qw = 1), useq."""
    rng = np.random.RandomState(seed)
    z = rng.randn(tau, 6, k)
    eps = np.einsum("ij,tjk->kti", UPS * SIGMA, z)
    x0 = np.zeros(13)
    x0[6] = 1.0
    return z, eps, x0, 0.5 * rng.randn(tau, 6)


def _jax_solve(ctrl, eps, x0, useq):
    mp, cp = ctrl.model_params, ctrl._cparams
    _, _, info = ctrl._solve_with_noise_jit(
        jnp.asarray(eps), jnp.asarray(x0), jnp.asarray(useq), mp, cp)
    costs = ctrl._rollout(jnp.asarray(x0), jnp.asarray(useq),
                          jnp.asarray(eps), mp, cp)
    return np.asarray(info["weighted_noise"]), np.asarray(costs)


def _t(a):
    return torch.tensor(np.asarray(a, np.float64))


HIDDEN = [(8, 8), (32, 32, 32)]


@pytest.mark.parametrize("hidden", HIDDEN)
@pytest.mark.parametrize("k", [80, 333])
def test_plain_costs_match_jax_rollout(hidden, k):
    tau = 3
    z, eps, x0, useq = _inputs(k, tau, seed=k)
    ctrl = _jax(hidden, k, tau)
    _, costs_j = _jax_solve(ctrl, eps, x0, useq)
    fused = _port(ctrl)
    dyn = fused.pack_dyn(_t(x0), _t(useq))
    np.testing.assert_allclose(
        nnk.sample_costs_plain(fused.consts, dyn, _t(z)).numpy(), costs_j,
        rtol=RTOL)
    costs, rows = nnk.fused_costs_plain(fused.consts, dyn, k, tau, z=_t(z),
                                        block=32)
    _, stats = pm.merge_plain(rows)
    assert rows.shape == (-(-k // 32), pm.STATS)
    np.testing.assert_allclose(
        stats[:5].numpy(), [0.0, 0.0, costs_j.min(), costs_j.max(),
                            costs_j.sum()], rtol=RTOL)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("hidden", HIDDEN)
@pytest.mark.parametrize("k,block", [(80, 32), (333, 256)])
def test_plain_solve_matches_jax_xla(hidden, normalize, k, block):
    """FusedNNMPPI.solve == the XLA solve on the same z; k=80 over blocks
    of 32 and k=333 over 256 leave a ragged last block."""
    tau = 3
    z, eps, x0, useq = _inputs(k, tau, seed=7 + k)
    ctrl = _jax(hidden, k, tau, normalize=normalize)
    wn_j, costs_j = _jax_solve(ctrl, eps, x0, useq)
    fused = _port(ctrl)
    wn, info = fused.solve(_t(x0), _t(useq), z=_t(z), normalize=normalize)
    tol = dict(rtol=1e-7, atol=1e-9 * np.abs(wn_j).max())
    np.testing.assert_allclose(wn.numpy(), wn_j, **tol)
    np.testing.assert_allclose(
        [info["cost_min"].item(), info["cost_max"].item(),
         info["cost_mean"].item()],
        [costs_j.min(), costs_j.max(), costs_j.mean()], rtol=RTOL)
    if not normalize:   # the block partials at another block size
        dyn = fused.pack_dyn(_t(x0), _t(useq))
        zsum, st = pm.merge_plain(nnk.fused_solve_plain(
            fused.consts, dyn, k, tau, z=_t(z), block=block))
        np.testing.assert_allclose(
            (fused.unfold_wnoise(zsum) / st[1]).numpy(), wn_j, **tol)


def test_fold_matches_jax_pack_dyn():
    """The folded weights of pack_dyn == the JAX FusedNNMPPI.pack_dyn's."""
    k, tau = 64, 4
    ctrl = _jax((32, 32, 32), k, tau)
    jf = JFusedNNMPPI(ctrl._model, ctrl._cost, k=k, tau=tau, lam=LAM,
                      upsilon=UPS, sigma=SIGMA, tile=32, interpret=True)
    z, _, x0, useq = _inputs(k, tau)
    jd = np.asarray(jf.pack_dyn(ctrl.model_params, ctrl._cparams, x0, useq))
    fused = _port(ctrl)
    dyn = fused.pack_dyn(_t(x0), _t(useq)).numpy()
    lay = nnk.NNDyn(tau, fused.consts.sizes)
    jlay = _DynNN(tau, list(fused.consts.sizes))
    assert lay.size == dyn.size
    for (w_at, b_at, fi, fo), (jw, jb) in zip(lay.layers, jlay.w_off):
        # the JAX layout is W row-major [fan_in, fan_out], f32
        np.testing.assert_allclose(dyn[w_at:b_at].reshape(fo, fi).T,
                                   jd[jw:jw + fi * fo].reshape(fi, fo),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(dyn[b_at:b_at + fo], jd[jb:jb + fo],
                                   rtol=1e-6, atol=1e-6)
        assert w_at % 4 == 0
    for name in ("x0", "goal", "useq", "rhs_z"):
        a, b = getattr(lay, name), getattr(jlay, name)
        n = 13 if name in ("x0", "goal") else 6 * tau
        np.testing.assert_allclose(dyn[a:a + n], jd[b:b + n], rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(dyn[lay.u_half], jd[jlay.u_half], rtol=1e-6)


def test_weight_update_is_data():
    """A weight update in place reaches the next solve of the same
    FusedNNMPPI: nothing is rebuilt, the result moves."""
    k, tau = 64, 3
    fused = _port(_jax((8, 8), k, tau))
    z, _, x0, useq = _inputs(k, tau, seed=2)
    wn1, i1 = fused.solve(_t(x0), _t(useq), z=_t(z))
    consts = fused.consts
    with torch.no_grad():
        for layer in fused.model.net:
            layer.w.add_(0.05)
    wn2, i2 = fused.solve(_t(x0), _t(useq), z=_t(z))
    assert fused.consts is consts
    assert not torch.allclose(wn1, wn2)
    fused.model.set_normalization(0.0, 2.0, 0.0, 1.0)
    _, i3 = fused.solve(_t(x0), _t(useq), z=_t(z))
    costs = [i["cost_mean"].item() for i in (i1, i2, i3)]
    assert len(set(costs)) == 3, costs


def test_prng_mode_equals_injected_dump_on_cpu():
    k, tau = 300, 5
    fused = _port(_jax((8, 8), k, tau), dtype=torch.float32)
    _, _, x0, useq = _inputs(k, tau, seed=3)
    x0, useq = _t(x0).float(), _t(useq).float()
    z = pm.pm_noise_dump(9, 4, k, tau, 6, "cpu")
    for normalize in (False, True):
        wn_a, st_a = fused.solve(x0, useq, seed=9, solve=4,
                                 normalize=normalize)
        wn_b, st_b = fused.solve(x0, useq, z=z, normalize=normalize)
        torch.testing.assert_close(wn_a, wn_b, rtol=0, atol=0)
        torch.testing.assert_close(st_a["nabla"], st_b["nabla"], rtol=0,
                                   atol=0)


def test_cpu_wrappers_run_plain_and_count_nothing():
    before = dict(pm.launch_counts)
    fused = _port(_jax((32, 32, 32), 300, 5), dtype=torch.float32)
    x0 = torch.zeros(13)
    x0[6] = 1.0
    fused.solve(x0, torch.zeros(5, 6), seed=1, solve=1)
    fused.solve(x0, torch.zeros(5, 6), seed=1, solve=1, normalize=True)
    assert pm.launch_counts == before


def test_wrappers_reject_other_devices_and_topologies():
    fused = _port(_jax((8, 8), 300, 5), dtype=torch.float32)
    c = fused.consts
    dyn = torch.empty(nnk.NNDyn(5, c.sizes).size, device="meta")
    with pytest.raises(ValueError):
        nnk.nn_fused_solve(c, dyn, 300, 5)
    with pytest.raises(ValueError):
        nnk.nn_fused_costs(c, dyn, 300, 5)
    with pytest.raises(KernelUnsupportedError):
        nnk._hidden_args(nnk.NnConsts(
            sizes=(16, 16, 16, 16, 13), lam=LAM, nc_half=0.0, renorm=True,
            scale=SIGMA, Mz=SIGMA, Q=np.eye(10)))
    assert nnk._hidden_args(c) == (8, 8, 0)


def test_eligibility():
    model = pnn.NNAUVModel(hidden=(8, 8))
    cost = get_cost(TASK, lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=SIGMA)
    kw = dict(k=64, tau=2, lam=LAM, upsilon=UPS, sigma=SIGMA)
    assert nnk.FusedNNMPPI(model, cost, **kw).consts.hidden == (8, 8)
    with pytest.raises(KernelUnsupportedError, match="NNAUVModel only"):
        nnk.FusedNNMPPI(pnn.NNAUVModelSpeed(hidden=(8, 8)), cost, **kw)
    with pytest.raises(KernelUnsupportedError, match="NNAUVModel only"):
        nnk.FusedNNMPPI(pnn.NNModel(state_dim=13, action_dim=6), cost, **kw)
    pm_cost = get_cost({"type": "static", "diag": True, "goal": [0.0] * 13,
                        "Q": [1.0] * 13}, lam=LAM, gamma=GAMMA, upsilon=UPS,
                       sigma=SIGMA)
    with pytest.raises(KernelUnsupportedError, match="StaticQuatCost"):
        nnk.FusedNNMPPI(model, pm_cost, **kw)
    with pytest.raises(KernelUnsupportedError, match="built for"):
        nnk.FusedNNMPPI(pnn.NNAUVModel(hidden=(16, 16, 16)), cost, **kw)
    # a bf16-compute model runs the bf16-products build at float32
    bfp = nnk.FusedNNMPPI(pnn.NNAUVModel(hidden=(8, 8),
                                         compute_dtype=torch.bfloat16),
                          cost, **kw)
    assert bfp.consts.bf16_products and bfp.compute_dtype == "float32"
    # the other solve objects refuse the NN model
    from mppi_tf_tpu_torch.kernels.auv_mppi import FusedAUVMPPI

    with pytest.raises(KernelUnsupportedError):
        FusedAUVMPPI(model, cost, **kw)
    with pytest.raises(KernelUnsupportedError):
        pm.FusedPointMassMPPI(model, cost, **kw)


def test_consts_packing_order():
    fused = _port(_jax((8, 8), 10, 3), dtype=torch.float32)
    p = fused.consts.packed
    assert p.dtype == np.float32 and p.shape == (176,)
    np.testing.assert_allclose(p[:4], [LAM, 0.5 * LAM * (1 - 1 / UPS), 1.0,
                                       0.0], rtol=1e-7)
    np.testing.assert_allclose(p[4:40], (UPS * SIGMA).ravel(), rtol=1e-7)
    np.testing.assert_allclose(p[-100:], np.diag(TASK["Q"]).ravel())
    assert fused.consts.sizes == (16, 8, 8, 13)


# ---------------------------------------------------------------------------
# the f32 kernel's tensor-core arithmetic (csrc/nn_mppi.cu, 3xTF32)
# ---------------------------------------------------------------------------

#: the card's gate on the NN kernels' per-sample costs (chip_smoke.py,
#: tests/test_torch_cuda.py)
COST_RTOL, COST_ATOL = 1e-4, 1e-2
#: the chip's NN flagship (chip_smoke.py nn_fused, check_auv): sigma,
#: lambda, upsilon, the depth task, useq of scale 200 from rest
FLAG_SIGMA = 1500.0 * np.eye(6)
FLAG_LAM, FLAG_UPS = 0.5, 1.0
FLAG_TASK = {"type": "static_quat", "diag": True,
             "goal": [0.0, 0.0, -5.0, 0.0, 0.0, 0.0, 1.0] + [0.0] * 6,
             "Q": [100.0, 100.0, 100.0, 10.0] + [1.0] * 6}


def _tf32_rna(a):
    """f32 ``a`` rounded to TF32 as cvt.rna.tf32.f32 rounds it: to nearest
    on the 13 dropped mantissa bits, ties away from zero, by integer
    operations on the f32 bits (nn_mppi.cu tf32_rna)."""
    return ((a.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mlp_3xtf32(layers, h):
    """The f32 kernel's MLP: every activation and weight split into a_hi =
    rna(a) and a_lo = rna(a - a_hi); C starts at the bias and adds, a k
    block of 8 at a time, a_lo b_hi, then a_hi b_lo, then a_hi b_hi (the
    products of TF32 values are exact in f32; the sums f32)."""
    for n, (w, b) in enumerate(layers):
        ah = _tf32_rna(h)
        al = _tf32_rna(h - ah)
        wh = _tf32_rna(w)
        wl = _tf32_rna(w - wh)
        y = b.expand(h.shape[0], -1)
        for j in range(0, w.shape[0], 8):
            blk = slice(j, j + 8)
            y = y + al[:, blk] @ wh[blk]
            y = y + ah[:, blk] @ wl[blk]
            y = y + ah[:, blk] @ wh[blk]
        h = torch.relu(y) if n < len(layers) - 1 else y
    return h


def _costs_3xtf32(consts, dyn, z):
    """nnk.sample_costs_plain's f32 rollout with the kernel's MLP."""
    from mppi_tf_tpu_torch.kernels.auv_mppi import _quat_cost

    tau, _, k = z.shape
    lay = consts.layout(tau)
    ct = pm.sched_factors(dyn, lay, tau)
    scale, Mz, Q = (torch.as_tensor(np.asarray(a), dtype=torch.float32)
                    for a in (consts.scale, consts.Mz, consts.Q))
    layers = [(dyn[w:b].reshape(o, i).T, dyn[b:b + o])
              for w, b, i, o in lay.layers]
    goal = dyn[lay.goal:lay.useq]
    useq = dyn[lay.useq:lay.rhs_z].reshape(tau, 6)
    rhs_z = dyn[lay.rhs_z:lay.u_half].reshape(tau, 6)
    x = dyn[lay.x0:lay.goal].expand(k, 13)
    cost = torch.zeros(k)
    for t in range(tau):
        zt = z[t].T
        h = torch.cat([x[:, 3:], useq[t] + (ct[t] * zt) @ scale.T], dim=-1)
        x = x + _mlp_3xtf32(layers, h)
        qn = torch.rsqrt(torch.clamp(torch.sum(x[:, 3:7] ** 2, dim=-1,
                                               keepdim=True), min=1e-24))
        x = torch.cat([x[:, :3], x[:, 3:7] * qn, x[:, 7:]], dim=-1)
        cost = (cost + _quat_cost(Q, goal, x) + zt @ rhs_z[t]
                + consts.nc_half * ct[t]
                * torch.sum((zt @ Mz.T) * zt, dim=-1))
    return cost + _quat_cost(Q, goal, x) + dyn[lay.u_half]


def test_tf32_rna_rounds_to_nearest_ties_away():
    a = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -11 - 2.0 ** -23,
                      2.0 - 2.0 ** -12, 3.0e-3], dtype=torch.float32)
    want = [1.0 + 2.0 ** -10, 1.0 + 2 * 2.0 ** -10, -(1.0 + 2.0 ** -10),
            1.0, 2.0]
    np.testing.assert_array_equal(_tf32_rna(a)[:5].numpy(), want)
    r = _tf32_rna(a)
    assert torch.all((r.view(torch.int32) & 0x1fff) == 0)
    assert abs(r[5].item() - 3.0e-3) <= 2.0 ** -11 * 3.0e-3


@pytest.mark.parametrize("hidden", HIDDEN)
def test_3xtf32_rollout_meets_the_cost_gate(hidden):
    """The f32 kernel's arithmetic, emulated in torch, inside the full f32
    rollout at the chip's NN flagship scaled down (K 512, H 25, trained
    normalisers, sigma 1500, useq of scale 200), against the f64 JAX XLA
    rollout: within COST_RTOL 1e-4 / COST_ATOL 1e-2, the gate the card
    holds the kernel's costs to against the plain f32 version. Three TF32
    products (a_lo b_hi + a_hi b_lo + a_hi b_hi) leave ~2^-22 of each
    product, a few f32 ulps, so they meet it as the f32 FMAs did."""
    k, tau = 512, 25
    model = JNNAUVModel(action_dim=6, dt=0.1, hidden=hidden, seed=4,
                        dtype=jnp.float64)
    cost = jget_cost(FLAG_TASK, lam=FLAG_LAM, gamma=0.2, upsilon=FLAG_UPS,
                     sigma=FLAG_SIGMA, dtype=jnp.float64)
    ctrl = JMPPI(model, cost, k=k, tau=tau, lam=FLAG_LAM, upsilon=FLAG_UPS,
                 sigma=FLAG_SIGMA)
    x_mean = np.zeros(16)
    x_mean[3] = 0.9
    x_std = np.concatenate([[0.3] * 4, [0.5] * 6, np.diag(FLAG_SIGMA)])
    y_std = np.array([0.05] * 3 + [0.01] * 4 + [0.05] * 6)
    ctrl.model_params = model.set_normalization(
        model.init_params(), x_mean, x_std, np.zeros(13), y_std)
    rng = np.random.RandomState(6)
    z = rng.randn(tau, 6, k).astype(np.float32)
    x0 = np.zeros(13)
    x0[6] = 1.0
    useq = (200.0 * rng.randn(tau, 6)).astype(np.float32)
    eps = np.einsum("ij,tjk->kti", FLAG_UPS * FLAG_SIGMA,
                    z.astype(np.float64))
    costs_j = np.asarray(ctrl._rollout(
        jnp.asarray(x0), jnp.asarray(useq, jnp.float64), jnp.asarray(eps),
        ctrl.model_params, ctrl._cparams))

    port_cost = get_cost(FLAG_TASK, lam=FLAG_LAM, gamma=0.2,
                         upsilon=FLAG_UPS, sigma=FLAG_SIGMA)
    fused = nnk.FusedNNMPPI(_port_model(ctrl, torch.float32), port_cost,
                            k=k, tau=tau, lam=FLAG_LAM, upsilon=FLAG_UPS,
                            sigma=FLAG_SIGMA)
    dyn = fused.pack_dyn(torch.tensor(x0, dtype=torch.float32),
                         torch.tensor(useq))
    zt = torch.tensor(z)
    costs_tc = _costs_3xtf32(fused.consts, dyn, zt).double().numpy()
    costs_f32 = nnk.sample_costs_plain(fused.consts, dyn, zt).double().numpy()
    rel_tc = np.max(np.abs(costs_tc - costs_j) / np.abs(costs_j))
    rel_f32 = np.max(np.abs(costs_f32 - costs_j) / np.abs(costs_j))
    print(f"{hidden}: max rel err against f64 JAX: 3xTF32 {rel_tc:.3e}, "
          f"plain f32 {rel_f32:.3e}; costs {np.abs(costs_j).min():.4g} .. "
          f"{np.abs(costs_j).max():.4g}")
    np.testing.assert_allclose(costs_tc, costs_j, rtol=COST_RTOL,
                               atol=COST_ATOL)
