"""The fused point-mass kernels of the port (kernels/pm_mppi.py): their
plain versions against the JAX package's Pallas kernel (interpret mode,
injected normals) and against the plain update chain, the Philox stream
against Random123's known answers. The CUDA kernels themselves are held
against these plain versions on the card by tests/test_torch_cuda.py.
"""

import dataclasses

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


#: the dense-constant point mass: SIGMA with correlations and TASK's Q
#: with off-diagonal terms, so that B scale, Mz and Q are full and the
#: kernels run their dense structure
DENSE_SIGMA = SIGMA + 0.01 * (1.0 - np.eye(3))
DENSE_TASK = {**TASK, "diag": False,
              "Q": (np.diag(TASK["Q"]) + 0.1 * (1.0 - np.eye(6))).tolist()}


def _port(k, tau, dtype=torch.float32, device=None, dense=False):
    task, sigma = (DENSE_TASK, DENSE_SIGMA) if dense else (TASK, SIGMA)
    model = get_model(MODEL, dt=0.1, state_dim=6, action_dim=3, dtype=dtype,
                      device=device)
    cost = get_cost(task, lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=sigma,
                    dtype=dtype, device=device)
    return pm.FusedPointMassMPPI(model, cost, k=k, tau=tau, lam=LAM,
                                 upsilon=UPS, sigma=sigma), model, cost


def _jax(k, tau, tile=256, dense=False):
    task, sigma = (DENSE_TASK, DENSE_SIGMA) if dense else (TASK, SIGMA)
    model = jget_model(MODEL, dt=0.1, state_dim=6, action_dim=3)
    cost = jget_cost(task, lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=sigma)
    fused = JFused(model, cost, k=k, tau=tau, lam=LAM, upsilon=UPS,
                   sigma=sigma, tile=tile, interpret=True)
    return fused, model.init_params(), cost.init_params()


def _inputs(k, tau, seed=3):
    rng = np.random.RandomState(seed)
    z_std = rng.randn(tau, 3, k).astype(np.float32)
    x0 = np.array([0.2, 0.0, -0.1, 0.0, 0.3, 0.0])
    useq = (0.1 * rng.randn(tau, 3)).astype(np.float32)
    return z_std, x0, useq


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("k,tau", [(700, 7), (512, 10)])
def test_plain_fused_solve_matches_pallas_interpret(k, tau, dense):
    """Port's plain fused solve + merge == the JAX Pallas kernel (interpret
    mode, injected normals, tile 256) at f32 tolerance; k=700 leaves a
    ragged last block on both sides. Both structures of the constants:
    the diagonal task (the JAX kernel's sparse trace; the port's
    "integrator") and a full sigma and Q (its dense trace; "dense")."""
    z_std, x0, useq = _inputs(k, tau)
    jf, mp, cp = _jax(k, tau, dense=dense)
    wn_j, st_j = jf.solve(0, x0, useq, mp, cp, z=jnp.asarray(
        chunk_noise(z_std, 256)), use_prng=False)
    fused, _, _ = _port(k, tau, dense=dense)
    assert fused.consts.structure == ("dense" if dense else "integrator")
    wn_p, st_p = fused.solve(torch.as_tensor(x0), torch.as_tensor(useq),
                             z=torch.as_tensor(z_std))
    np.testing.assert_allclose(wn_p.numpy(), np.asarray(wn_j), rtol=2e-3,
                               atol=2e-4)
    for key in ("cost_min", "cost_max", "cost_mean", "nabla"):
        np.testing.assert_allclose(st_p[key].item(), float(st_j[key]),
                                   rtol=2e-3)


@pytest.mark.parametrize("k,tau", [(700, 7), (512, 10)])
def test_plain_normalized_solve_matches_pallas_interpret(k, tau):
    """The two-phase normalized solve (pm_fused_costs -> mppi_weights ->
    pm_merge, plain versions) == the JAX Pallas costs and weights kernels
    in interpret mode on injected normals, f32 on both sides; phase by
    phase as well."""
    z_std, x0, useq = _inputs(k, tau, seed=8)
    jf, mp, cp = _jax(k, tau)
    zc = jnp.asarray(chunk_noise(z_std, 256))
    wn_j, st_j = jf.solve(0, x0, useq, mp, cp, z=zc, use_prng=False,
                          normalize=True)
    fused, _, _ = _port(k, tau)
    x0_t, useq_t, z_t = (torch.as_tensor(x0), torch.as_tensor(useq),
                         torch.as_tensor(z_std))
    wn_p, st_p = fused.solve(x0_t, useq_t, z=z_t, normalize=True)
    # f32 sums in another order; the normalized exponent is bounded
    np.testing.assert_allclose(wn_p.numpy(), np.asarray(wn_j), rtol=1e-3,
                               atol=1e-5)
    for key in ("cost_min", "cost_max", "cost_mean", "nabla"):
        np.testing.assert_allclose(st_p[key].item(), float(st_j[key]),
                                   rtol=1e-4)
    costs_j, cst_j = jf.costs_phase(0, x0, useq, mp, cp, z=zc,
                                    use_prng=False)
    costs_p, cst_p = fused.costs_phase(x0_t, useq_t, z=z_t)
    np.testing.assert_allclose(costs_p.numpy(),
                               np.asarray(costs_j).reshape(-1)[:k],
                               rtol=1e-5)
    for key in ("cost_min", "cost_max", "cost_sum"):
        np.testing.assert_allclose(cst_p[key].item(), float(cst_j[key]),
                                   rtol=1e-5)
    zsum_j, l_j = jf.weights_phase(0, costs_j, cst_j["cost_min"],
                                   cst_j["cost_max"], z=zc, use_prng=False)
    zsum_p, l_p = fused.weights_phase(costs_p, cst_p["cost_min"],
                                      cst_p["cost_max"], z=z_t)
    np.testing.assert_allclose(l_p.item(), float(l_j), rtol=1e-4)
    np.testing.assert_allclose(zsum_p.numpy(), np.asarray(zsum_j),
                               rtol=1e-3, atol=1e-3)


def test_pm_normalized_matches_update_chain_f64():
    """Two-phase plain solve at f64 == rollout_costs + the normalized
    mppi_update over eps = scale @ z."""
    from mppi_tf_tpu_torch.controller import MPPI

    k, tau = 333, 6
    fused, model, cost = _port(k, tau)
    model.double()
    cost.double()
    z_std, x0, useq = _inputs(k, tau, seed=9)
    z = torch.as_tensor(z_std, dtype=torch.float64)
    x0_t = torch.as_tensor(x0)
    useq_t = torch.as_tensor(useq, dtype=torch.float64)
    dyn = fused.pack_dyn(x0_t, useq_t).double()
    costs, rows = pm.fused_costs_plain(fused.consts, dyn, k, tau, z=z,
                                       block=64)
    _, st = pm.merge_plain(rows)
    denom = st[3] - st[2]
    nrm = torch.stack([st[2], 1.0 / (denom * LAM)])
    zsum, stats = pm.merge_plain(pm.weights_plain(nrm, costs, tau, 3, z=z,
                                                  block=64))
    scale = torch.as_tensor(UPS * SIGMA)
    wn = (zsum.reshape(tau, 3) @ scale.T) / stats[1]
    ctrl = MPPI(model, cost, k=k, tau=tau, lam=LAM, upsilon=UPS, sigma=SIGMA,
                device="cpu")
    eps = z.permute(2, 0, 1) @ scale.T
    ref_costs = ctrl._rollout(x0_t, useq_t, eps).detach()
    # f32 dyn packing bounds the agreement; the algebra itself is exact
    np.testing.assert_allclose(costs.numpy(), ref_costs.numpy(), rtol=1e-5)
    np.testing.assert_allclose(
        wn.numpy(), upd.mppi_update(ref_costs, eps, LAM,
                                    normalize=True).numpy(),
        rtol=1e-4, atol=1e-6)


def test_pm_noise_sample_is_the_solve_noise():
    fused, _, _ = _port(600, 4)
    eps = fused.noise_sample(seed=2, solve=3)
    z = pm.noise_plain(2, 3, 512, 4, 3)
    torch.testing.assert_close(
        eps, torch.einsum("ij,tjk->kti", fused._scale, z), rtol=0, atol=0)


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


def _seeded_rows(nb, n_z, seed):
    """Partial rows (m_b, l_b, cost min, max, sum, 0, 0, 0, zsum_b) in f64:
    spread maxima, positive l_b, zsum_b of both signs."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((nb, pm.STATS + n_z))
    rows[:, 0] = -np.abs(rng.normal(0.0, 3.0, nb))
    rows[:, 1] = rng.uniform(1.0, 256.0, nb)
    c = rng.uniform(1e3, 5e4, (nb, 2))
    rows[:, 2], rows[:, 3] = c.min(axis=1), c.max(axis=1)
    rows[:, 4] = rng.uniform(1e5, 1e7, nb)
    rows[:, pm.STATS:] = rng.normal(0.0, 30.0, (nb, n_z))
    return rows


class _MergedShard:
    """The per-shard solve that mppi_tf_tpu/parallel/fused.py's
    build_sharded_fused_solve runs on each device, standing in with a
    merged row: its raw pieces (m, l, zsum, cost stats) are the row that
    solve_with_noise hands it as its shard of z, so the factory's own
    _shard_reduce (pmax of m, f = exp(m - m_g), psum of l f and zsum f,
    pmin / pmax / psum of the cost stats) merges the given rows."""

    k = tile = adim = 1
    _scale = np.eye(1)

    def __init__(self, width: int):
        self.tau = width - pm.STATS

    def solve(self, seed, state, useq, mparams, cparams, z=None, **kw):
        r = z[0, 0]
        return {"m": r[0], "l": r[1], "cost_min": r[2], "cost_max": r[3],
                "cost_sum": r[4], "zsum": r[pm.STATS:]}

    def unfold_wnoise(self, zsum):
        return zsum.reshape(self.tau, 1)


def _jax_shard_merge(merged):
    """(l, cost min, max, sum, zsum) of the reference's shard merge over
    the rows ``merged`` (at most 8, one a device of the 8-device CPU mesh;
    the others hold no samples: m = -inf, l = 0), run through
    build_sharded_fused_solve's solve_with_noise. Its outputs give back
    zsum = wnoise l (the action and the shifted sequence) and the cost
    sum = cost_mean k (k = 8)."""
    from mppi_tf_tpu.parallel import make_mesh
    from mppi_tf_tpu.parallel.fused import build_sharded_fused_solve

    n = 8
    width = pm.STATS + max(merged.shape[1] - pm.STATS, 1)
    rows = np.zeros((n, width))
    rows[:, 0], rows[:, 2], rows[:, 3] = -np.inf, np.inf, -np.inf
    rows[:len(merged), :merged.shape[1]] = merged
    _, solve = build_sharded_fused_solve(_MergedShard(width),
                                         make_mesh(n), k_global=n)
    tau = width - pm.STATS
    one = jnp.zeros(1)
    action, shifted, info = solve(jnp.asarray(rows.reshape(1, 1, -1)), one,
                                  jnp.zeros((tau, 1)), one, one)
    wnoise = np.concatenate([np.asarray(action), np.asarray(shifted)[:-1,
                                                                       0]])
    l = float(info["nabla"])
    return (l, float(info["cost_min"]), float(info["cost_max"]),
            float(info["cost_mean"]) * n,
            wnoise[:merged.shape[1] - pm.STATS] * l)


@pytest.mark.parametrize("n_z", [0, 150, 300])
@pytest.mark.parametrize("nb", [1, 3, 391])
def test_merge_of_slice_merges_equals_one_merge(nb, n_z):
    """The two-level merge pm_merge's parallel forms rest on, in f64:
    merge_plain of all rows equals merge_plain over the merges of any
    partition of the rows into slices (the kernel's 8 interleaved row
    slices, 8 contiguous ranks, slices of one row), and equals the JAX
    reference's shard merge (parallel/fused.py, on the 8-device CPU
    mesh) over the same slices wherever they number at most 8. m, cost
    min and cost max are equal exactly; the sums within 1e-12 of each
    column's l1 mass."""
    rows = _seeded_rows(nb, n_z, seed=nb * 1000 + n_z)
    zsum, st = (t.numpy() for t in pm.merge_plain(torch.as_tensor(rows)))
    f = np.exp(rows[:, 0] - st[0])
    l1 = np.concatenate([[(f * rows[:, 1]).sum(), np.abs(rows[:, 4]).sum()],
                         f @ np.abs(rows[:, pm.STATS:])])
    per = -(-nb // 8)
    partitions = {"interleaved": [np.arange(s, nb, 8) for s in range(8)],
                  "contiguous": [np.arange(r * per, min(nb, (r + 1) * per))
                                 for r in range(8)],
                  "rows": [np.array([b]) for b in range(nb)]}
    for name, slices in partitions.items():
        slices = [s for s in slices if s.size]
        merged = []
        for s in slices:
            z_s, st_s = (t.numpy() for t in pm.merge_plain(
                torch.as_tensor(rows[s])))
            merged.append(np.concatenate([st_s, z_s]))
        merged = np.stack(merged)
        z2, st2 = (t.numpy() for t in pm.merge_plain(
            torch.as_tensor(merged)))
        assert (st2[0], st2[2], st2[3]) == (st[0], st[2], st[3]), name
        got = [(st2[1], st2[4], z2)]
        if len(slices) <= 8:
            l_j, cmin, cmax, csum, z_j = _jax_shard_merge(merged)
            assert (cmin, cmax) == (st[2], st[3]), name
            got.append((l_j, csum, z_j))
        for l_g, csum_g, z_g in got:
            err = np.abs(np.concatenate([[l_g - st[1], csum_g - st[4]],
                                         z_g - zsum]))
            assert np.all(err <= 1e-12 * l1), (name, (err / l1).max())


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


@pytest.mark.parametrize("k,k_short", [(4097, 4096), (1500, 512), (701, 3)])
def test_noise_columns_do_not_depend_on_k(k, k_short):
    """Sample k's normals are the same whatever the draw's width: the first
    k_short columns of a draw of k equal a draw of k_short, bit for bit
    (the card's dump is held to the same, tests/test_torch_cuda.py)."""
    wide = pm.noise_plain(4, 6, k, 5, 3)
    assert torch.equal(wide[..., :k_short], pm.noise_plain(4, 6, k_short,
                                                           5, 3))


@pytest.mark.parametrize("k", [1, 2, 3])
def test_noise_fewer_samples_than_a_vector(k):
    """k < 4: as many columns as samples, finite, the first columns of a
    wider draw."""
    z = pm.noise_plain(8, 1, k, 7, 3)
    assert z.shape == (7, 3, k) and bool(torch.isfinite(z).all())
    assert torch.equal(z, pm.noise_plain(8, 1, 64, 7, 3)[..., :k])


@pytest.mark.parametrize("tau,adim", [(7, 3), (5, 1), (3, 2), (1, 6)])
def test_noise_ragged_last_philox_block(tau, adim):
    """n_z = tau adim not a multiple of 4: normal n is word n % 4 of Philox
    block n // 4 whatever n_z is, so the rows equal the first n_z rows of a
    draw whose n_z is the next multiple of 4."""
    n_z = tau * adim
    z = pm.noise_plain(3, 9, 300, tau, adim).reshape(n_z, 300)
    full = pm.noise_plain(3, 9, 300, -(-n_z // 4) * 4, 1).reshape(-1, 300)
    assert torch.equal(z, full[:n_z])


@pytest.mark.parametrize("k,half", [(4097, 2049), (701, 351), (5, 3),
                                    (130, 65), (128, 64)])
def test_noise_antithetic_odd_half_mirrors_exactly(k, half):
    """From sample ``half`` on each column is the exact negative of column
    k - half, and the columns before it are the plain draw's, at an odd
    half and at the even half of an even k."""
    z = pm.noise_plain(2, 5, k, 7, 3, half=half)
    plain = pm.noise_plain(2, 5, k, 7, 3)
    assert torch.equal(z[..., :half], plain[..., :half])
    n = k - half
    assert torch.equal(z[..., half:], -plain[..., :n])
    assert torch.equal(z[..., half:] + z[..., :n], torch.zeros_like(
        z[..., :n]))


@pytest.mark.parametrize("k,tau,adim,half", [(700, 7, 3, 0), (513, 5, 6, 257),
                                             (3, 7, 3, 0)])
def test_noise_dump_bf16_is_the_f32_dump_rounded(k, tau, adim, half):
    """The bf16 dump (the CPU wrapper's plain version) is the f32 dump
    rounded to bf16 and held in f32: every value is a bf16 value, and the
    mirrored columns stay exact negatives."""
    f32 = pm.pm_noise_dump(6, 2, k, tau, adim, "cpu", half=half)
    bf = pm.pm_noise_dump(6, 2, k, tau, adim, "cpu", half=half,
                          compute_dtype="bfloat16")
    assert bf.dtype == torch.float32 and bf.shape == f32.shape
    assert torch.equal(bf, f32.to(torch.bfloat16).float())
    assert torch.equal(bf, bf.to(torch.bfloat16).float())
    if half:
        assert torch.equal(bf[..., half:], -bf[..., :k - half])


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
    fused.solve(torch.zeros(6), torch.zeros(5, 3), seed=1, solve=1,
                normalize=True)
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
    with pytest.raises(ValueError):
        pm.pm_fused_costs(fused.consts, dyn, 300, 5)
    with pytest.raises(ValueError):
        pm.mppi_weights(torch.zeros(2, device="meta"), torch.zeros(300), 5,
                        3)


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
    # A, Bs, Q, Mz, lam, nc_half, then the seven ellipse constants (zero
    # for the quadratic cost)
    assert packed.dtype == np.float32 and packed.shape == (36 + 18 + 36
                                                           + 9 + 2 + 7,)
    np.testing.assert_allclose(packed[:36], c.A.ravel())
    np.testing.assert_allclose(packed[54:90], c.Q.ravel())
    np.testing.assert_allclose(packed[-9:-7],
                               [LAM, 0.5 * LAM * (1 - 1 / UPS)], rtol=1e-7)
    np.testing.assert_array_equal(packed[-7:], np.zeros(7))


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
    assert name.startswith("libmppi_kernels_") and name.endswith(".so")
    assert _build.library_path() == _build.library_path()


def test_library_hash_covers_every_source_and_header(tmp_path, monkeypatch):
    """Editing any .cu or .cuh under csrc/ renames the library, so a stale
    build is never loaded; no nvcc runs here."""
    for name in ("a.cu", "b.cu", "common.cuh"):
        (tmp_path / name).write_text(f"// {name}\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build.sources()] == ["a.cu", "b.cu"]
    names = {_build.library_path()}
    for name in ("common.cuh", "b.cu"):
        (tmp_path / name).write_text("// edited\n")
        names.add(_build.library_path())
    (tmp_path / "c.cuh").write_text("// new header\n")
    names.add(_build.library_path())
    assert len(names) == 4
    (tmp_path / "notes.txt").write_text("not a source")
    assert _build.library_path() in names


def _structure_case(case):
    """The consts of a point-mass solve object of ``case`` on the CPU."""
    from mppi_tf_tpu_torch.models.dmd import DMDModel

    sdim, adim, task, sigma = 6, 3, TASK, SIGMA
    if case in ("1dof", "2dof", "elipse"):
        adim = 1 if case == "1dof" else 2
        sdim, sigma = 2 * adim, SIGMA[:adim, :adim]
        task = ({"type": "elipse", "a": 4.0, "b": 2.0, "center_x": 0.0,
                 "center_y": 0.0, "speed": 5.0, "m_state": 1.0,
                 "m_vel": 0.1} if case == "elipse" else
                {"type": "static", "diag": True, "goal": [0.5] * sdim,
                 "Q": [1.0] * sdim})
    elif case == "sigma_off_diagonal":
        sigma = SIGMA.copy()
        sigma[0, 1] = sigma[1, 0] = 0.01
    elif case == "q_off_diagonal":
        q = np.diag(TASK["Q"])
        q[2, 3] = q[3, 2] = 0.1
        task = {**TASK, "diag": False, "Q": q.tolist()}
    model = get_model(MODEL, dt=0.1, state_dim=sdim, action_dim=adim)
    cost = get_cost(task, lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=sigma)
    kw = {"k": 10, "tau": 3, "lam": LAM, "upsilon": UPS, "sigma": sigma}
    if case == "dynamic_ab":
        dmd = DMDModel(6, 3, dt=0.1, init_A=model.A.numpy(),
                       init_B=model.B.numpy() / 1.3)
        return pm.FusedLTIMPPI(dmd, cost, **kw).consts
    if case == "bfloat16":
        return pm.FusedPointMassMPPI(model, cost, compute_dtype="bfloat16",
                                     **kw).consts
    consts = pm.FusedPointMassMPPI(model, cost, **kw).consts
    if case == "dmd_fit_A":
        # a DMDModel fitted to the point mass's own transitions: A's
        # diagonal lies within rounding of 1, not at it
        rng = np.random.default_rng(0)
        A, B = consts.A, model.B.numpy() / 1.3
        xs = rng.standard_normal((40, 6))
        us = rng.standard_normal((40, 3))
        xn = xs @ A.T + us @ B.T + 1e-6 * rng.standard_normal((40, 6))
        fit_A = DMDModel(6, 3, dt=0.1).fit(
            torch.as_tensor(xs), torch.as_tensor(us),
            torch.as_tensor(xn))["A"].double().numpy()
        assert np.any(np.float32(np.diag(fit_A)) != 1.0)
        consts = dataclasses.replace(consts, A=fit_A)
    return consts


@pytest.mark.parametrize("case,structure", [
    ("main", "integrator"), ("elipse", "integrator"),
    ("1dof", "integrator"), ("2dof", "integrator"),
    ("sigma_off_diagonal", "dense"), ("q_off_diagonal", "dense"),
    ("dmd_fit_A", "dense"), ("dynamic_ab", "dense"), ("bfloat16", "dense")])
def test_structure_is_integrator_exactly(case, structure):
    """PmConsts.structure is "integrator" only where every entry the
    kernels' integrator instantiation leaves out is exactly 0.0 and every
    one it takes as 1 is exactly 1.0 (the point mass's A, B scale at a
    diagonal sigma, diagonal Q and Mz), at f32 without dynamic_ab; one
    off-diagonal sigma or Q entry, an A whose diagonal is not exactly 1,
    dynamic (A, B) or the bf16 build give "dense"."""
    assert _structure_case(case).structure == structure


def test_template_args_carry_the_structure():
    """template_args ends in the structure's STRUCT: the diagonal task's
    solve launches <6, 3, MODE, 0, 0, 1>, the dense-constant one <..., 0,
    0, 0> and FusedLTIMPPI <..., 0, 1, 0>."""
    from mppi_tf_tpu_torch.models.dmd import DMDModel

    fused, model, cost = _port(10, 3)
    assert fused.template_args("pm_fused_solve") == (6, 3, 0, 0, 0, 1)
    assert fused.template_args("pm_fused_costs") == (6, 3, 1, 0, 0, 1)
    assert fused.template_args("mppi_weights") == ()
    dense, _, _ = _port(10, 3, dense=True)
    assert dense.template_args("pm_fused_solve") == (6, 3, 0, 0, 0, 0)
    lti = pm.FusedLTIMPPI(DMDModel(6, 3, dt=0.1, init_A=model.A.numpy(),
                                   init_B=model.B.numpy()), cost, k=10,
                          tau=3, lam=LAM, upsilon=UPS, sigma=SIGMA)
    assert lti.template_args("pm_fused_costs") == (6, 3, 1, 0, 1, 0)
    assert pm.STRUCTURES == {"dense": 0, "integrator": 1}
