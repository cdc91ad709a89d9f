"""The fused point-mass kernels of the port (kernels/pm_mppi.py): their
plain versions against the JAX package's Pallas kernel (interpret mode,
injected normals) and against the plain update chain, the Philox stream
against Random123's known answers. The CUDA kernels themselves are held
against these plain versions on the card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_tf_tpu.costs import get_cost as jget_cost
from mppi_tf_tpu.kernels.pm_mppi import FusedPointMassMPPI as JFused
from mppi_tf_tpu.kernels.pm_mppi import chunk_noise
from mppi_tf_tpu.models import get_model as jget_model
from mppi_tf_tpu_torch.costs import CostBase, get_cost
from mppi_tf_tpu_torch.kernels import _build
from mppi_tf_tpu_torch.kernels import pm_mppi as pm
from mppi_tf_tpu_torch.kernels.errors import KernelUnsupportedError
from mppi_tf_tpu_torch.models import get_model
from mppi_tf_tpu_torch.ops import update as upd

SIGMA = np.diag([0.25, 0.3, 0.2])
LAM, GAMMA, UPS = 0.8, 0.2, 1.2
TASK = {"type": "static", "diag": True,
        "goal": [1.0, 0.0, 0.5, 0.0, -0.5, 0.0],
        "Q": [5.0, 1.0, 5.0, 1.0, 5.0, 1.0]}
MODEL = {"type": "point_mass", "mass": 1.3}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _port(k, tau, dtype=torch.float32, device=None):
    model = get_model(MODEL, dt=0.1, state_dim=6, action_dim=3, dtype=dtype,
                      device=device)
    cost = get_cost(TASK, lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=SIGMA,
                    dtype=dtype, device=device)
    return pm.FusedPointMassMPPI(model, cost, k=k, tau=tau, lam=LAM,
                                 upsilon=UPS, sigma=SIGMA), model, cost


def _jax(k, tau, tile=256):
    model = jget_model(MODEL, dt=0.1, state_dim=6, action_dim=3)
    cost = jget_cost(TASK, lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=SIGMA)
    fused = JFused(model, cost, k=k, tau=tau, lam=LAM, upsilon=UPS,
                   sigma=SIGMA, tile=tile, interpret=True)
    return fused, model.init_params(), cost.init_params()


def _inputs(k, tau, seed=3):
    rng = np.random.RandomState(seed)
    z_std = rng.randn(tau, 3, k).astype(np.float32)
    x0 = np.array([0.2, 0.0, -0.1, 0.0, 0.3, 0.0])
    useq = (0.1 * rng.randn(tau, 3)).astype(np.float32)
    return z_std, x0, useq


@pytest.mark.parametrize("k,tau", [(700, 7), (512, 10)])
def test_plain_fused_solve_matches_pallas_interpret(k, tau):
    """Port's plain fused solve + merge == the JAX Pallas kernel (interpret
    mode, injected normals, tile 256) at f32 tolerance; k=700 leaves a
    ragged last block on both sides."""
    z_std, x0, useq = _inputs(k, tau)
    jf, mp, cp = _jax(k, tau)
    wn_j, st_j = jf.solve(0, x0, useq, mp, cp, z=jnp.asarray(
        chunk_noise(z_std, 256)), use_prng=False)
    fused, _, _ = _port(k, tau)
    wn_p, st_p = fused.solve(torch.as_tensor(x0), torch.as_tensor(useq),
                             z=torch.as_tensor(z_std))
    np.testing.assert_allclose(wn_p.numpy(), np.asarray(wn_j), rtol=2e-3,
                               atol=2e-4)
    for key in ("cost_min", "cost_max", "cost_mean", "nabla"):
        np.testing.assert_allclose(st_p[key].item(), float(st_j[key]),
                                   rtol=2e-3)


def test_pack_dyn_matches_jax():
    k, tau = 300, 9
    _, x0, useq = _inputs(k, tau, seed=4)
    jf, mp, cp = _jax(k, tau)
    fused, _, _ = _port(k, tau)
    ref = np.asarray(jf.pack_dyn(mp, cp, x0, useq))
    got = fused.pack_dyn(torch.as_tensor(x0), torch.as_tensor(useq))
    assert got.dtype == torch.float32
    assert got.shape == ref.shape == (pm.Dyn(tau, 6, 3).size,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-7)


def test_fused_plain_matches_update_chain_f64():
    """The folded-algebra rollout + block partials + merge == the port's
    reference path: rollout_costs + mppi_update over eps = scale @ z."""
    from mppi_tf_tpu_torch.controller import MPPI

    k, tau = 333, 6
    fused, model, cost = _port(k, tau)
    model.double()
    cost.double()
    z_std, x0, useq = _inputs(k, tau, seed=5)
    z = torch.as_tensor(z_std, dtype=torch.float64)
    x0_t = torch.as_tensor(x0)
    useq_t = torch.as_tensor(useq, dtype=torch.float64)
    dyn = fused.pack_dyn(x0_t, useq_t).double()
    part = pm.fused_solve_plain(fused.consts, dyn, k, tau, z=z, block=64)
    zsum, stats = pm.merge_plain(part)
    wn = (zsum.reshape(tau, 3) @ torch.as_tensor(UPS * SIGMA).T) / stats[1]

    ctrl = MPPI(model, cost, k=k, tau=tau, lam=LAM, upsilon=UPS, sigma=SIGMA,
                device="cpu")
    eps = z.permute(2, 0, 1) @ torch.as_tensor(UPS * SIGMA).T
    costs = ctrl._rollout(x0_t, useq_t, eps).detach()
    # f32 dyn packing bounds the agreement; the algebra itself is exact
    np.testing.assert_allclose(wn.numpy(),
                               upd.mppi_update(costs, eps, LAM).numpy(),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(
        stats[2:5].numpy(), [costs.min(), costs.max(), costs.sum()],
        rtol=1e-5)


@pytest.mark.parametrize("block", [1, 32, 100, 256, 1024])
def test_block_partials_merge_equal_one_shot_softmax(block):
    rng = np.random.default_rng(block)
    k, n_z, lam = 700, 12, 0.7
    costs = torch.as_tensor(rng.uniform(50.0, 400.0, size=k))
    z = torch.as_tensor(rng.normal(size=(n_z, k)))
    zsum, stats = pm.merge_plain(pm.block_partials(costs, z, lam, block))
    w = torch.softmax(-costs / lam, dim=0)
    np.testing.assert_allclose((zsum / stats[1]).numpy(), (z @ w).numpy(),
                               rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(
        (zsum / stats[1]).numpy(),
        upd.mppi_update(costs, z.T[:, :, None], lam)[:, 0].numpy(),
        rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(stats[0].item(), (-costs / lam).max().item(),
                               rtol=1e-12)
    np.testing.assert_allclose(
        stats[2:5].numpy(), [costs.min(), costs.max(), costs.sum()],
        rtol=1e-12)


def test_block_partials_pad_with_neg_inf_sentinel():
    """Padding samples must weigh exactly zero even for huge finite costs
    (a finite sentinel would beat them; see pm_mppi.NEG_INF)."""
    costs = torch.full((5,), 1e35, dtype=torch.float32)
    part = pm.block_partials(costs, torch.ones(2, 5), lam=1e-3, block=4)
    zsum, stats = pm.merge_plain(part)
    assert torch.all(torch.isfinite(zsum)) and torch.isfinite(stats[1])
    np.testing.assert_allclose((zsum / stats[1]).numpy(), [1.0, 1.0])


@pytest.mark.parametrize("counter,key,expect", [
    ([0, 0, 0, 0], [0, 0],
     [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]),
    ([0xFFFFFFFF] * 4, [0xFFFFFFFF] * 2,
     [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]),
    ([0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344],
     [0xA4093822, 0x299F31D0],
     [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]),
])
def test_philox_known_answers(counter, key, expect):
    out = pm.philox4x32_10(torch.tensor(counter, dtype=torch.int64),
                           torch.tensor(key, dtype=torch.int64))
    assert out.tolist() == expect


def test_box_muller_moments():
    z = pm.noise_plain(seed=11, solve=0, k=20000, tau=5, adim=3)
    assert z.dtype == torch.float32 and z.shape == (5, 3, 20000)
    zd = z.double()
    n = zd.numel()
    assert abs(zd.mean().item()) < 6 * n ** -0.5
    assert abs(zd.var().item() - 1.0) < 6 * (2.0 / n) ** 0.5
    assert abs((zd ** 4).mean().item() - 3.0) < 6 * (96.0 / n) ** 0.5
    assert abs((zd.abs() > 3).double().mean().item() - 0.0027) < 6e-4
    # the uniforms never reach 0: the tail is clipped at sqrt(48 ln 2)
    assert zd.abs().max().item() <= (48 * np.log(2.0)) ** 0.5


def test_noise_stream_indexing():
    """A sample's normals depend on (seed, solve, sample, n) only: the
    first samples of a large draw equal a small draw, and a new solve or
    seed gives a new stream."""
    big = pm.noise_plain(5, 2, 600, 7, 3)
    torch.testing.assert_close(pm.noise_plain(5, 2, 100, 7, 3),
                               big[..., :100], rtol=0, atol=0)
    # n = t*adim + j: a longer horizon extends the same per-sample stream
    torch.testing.assert_close(pm.noise_plain(5, 2, 600, 4, 3),
                               big[:4], rtol=0, atol=0)
    assert not torch.equal(pm.noise_plain(5, 3, 600, 7, 3), big)
    assert not torch.equal(pm.noise_plain(6, 2, 600, 7, 3), big)
    # 64-bit seed and solve indices use both counter / key words
    assert not torch.equal(pm.noise_plain(5 + (1 << 32), 2, 600, 7, 3), big)
    assert not torch.equal(pm.noise_plain(5, 2 + (1 << 32), 600, 7, 3), big)


def test_prng_mode_equals_injected_dump_on_cpu():
    fused, _, _ = _port(300, 5)
    x0, useq = torch.zeros(6), torch.zeros(5, 3)
    wn_a, st_a = fused.solve(x0, useq, seed=9, solve=4)
    z = pm.pm_noise_dump(9, 4, 300, 5, 3, "cpu")
    wn_b, st_b = fused.solve(x0, useq, z=z)
    torch.testing.assert_close(wn_a, wn_b, rtol=0, atol=0)


def test_cpu_wrappers_run_plain_and_count_nothing():
    before = dict(pm.launch_counts)
    fused, _, _ = _port(300, 5)
    fused.solve(torch.zeros(6), torch.zeros(5, 3), seed=1, solve=1)
    pm.pm_noise_dump(1, 1, 300, 5, 3, "cpu")
    assert pm.launch_counts == before


def test_wrappers_reject_other_devices():
    """Only CPU tensors take the plain version: any other device launches
    the kernel or raises, never falls back."""
    fused, _, _ = _port(300, 5)
    dyn = torch.empty(pm.Dyn(5, 6, 3).size, device="meta")
    with pytest.raises(ValueError):
        pm.pm_fused_solve(fused.consts, dyn, 300, 5)
    with pytest.raises(ValueError):
        pm.pm_fused_solve(fused.consts, torch.zeros(pm.Dyn(5, 6, 3).size),
                          300, 5, z=torch.empty(5, 3, 300, device="meta"))
    with pytest.raises(ValueError):
        pm.pm_merge(torch.empty(2, 23, device="meta"))
    with pytest.raises(ValueError):
        pm.pm_noise_dump(0, 0, 10, 2, 3, "meta")


def test_fused_rejects_ineligible():
    class OtherCost(CostBase):
        def state_cost(self, state):
            return state.sum(-1)

    model = get_model(MODEL, dt=0.1, state_dim=6, action_dim=3)
    cost = get_cost(TASK, lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=SIGMA)
    with pytest.raises(KernelUnsupportedError):
        pm.FusedPointMassMPPI(model, OtherCost(LAM, GAMMA, UPS, SIGMA),
                              k=10, tau=3, lam=LAM, upsilon=UPS, sigma=SIGMA)
    with pytest.raises(KernelUnsupportedError):
        pm.FusedPointMassMPPI(model.double(), cost, k=10, tau=3, lam=LAM,
                              upsilon=UPS, sigma=SIGMA)


def test_consts_packing_order():
    fused, _, _ = _port(10, 3)
    c = fused.consts
    packed = c.packed
    assert packed.dtype == np.float32 and packed.shape == (36 + 18 + 36
                                                           + 9 + 2,)
    np.testing.assert_allclose(packed[:36], c.A.ravel())
    np.testing.assert_allclose(packed[54:90], c.Q.ravel())
    np.testing.assert_allclose(packed[-2:], [LAM, 0.5 * LAM * (1 - 1 / UPS)],
                               rtol=1e-7)


def test_parse_ptxas():
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z15pm_merge_kernelPKfiiPfS1_' for 'sm_90a'
ptxas info    : Function properties for _Z15pm_merge_kernelPKfiiPfS1_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, 132 bytes smem, 392 bytes cmem[0]
ptxas info    : Compiling entry function '_Z20pm_noise_dump_kernel' for 'sm_90a'
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, 380 bytes cmem[0]
"""
    rows = _build.parse_ptxas(log)
    assert rows == [
        {"kernel": "_Z15pm_merge_kernelPKfiiPfS1_", "stack": 0,
         "spill_stores": 0, "spill_loads": 0, "registers": 30,
         "static_smem": 132},
        {"kernel": "_Z20pm_noise_dump_kernel", "stack": 8,
         "spill_stores": 4, "spill_loads": 4, "registers": 40,
         "static_smem": 0}]


def test_library_name_carries_source_hash():
    name = _build.library_path().name
    assert name.startswith("libpm_mppi_") and name.endswith(".so")
    assert _build.library_path() == _build.library_path()
