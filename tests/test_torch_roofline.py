"""The port's roofline module (``mppi_tf_tpu_torch/roofline.py``) on the
CPU: ``classify`` against the JAX package's on the same work and ceiling
dicts, the counts at the flagship shapes against the bounds PERF.md's
kernel table records (computed by chip_smoke.py through this module), the
work models against those counts, and the ceilings' plain versions. The
card's microbenchmarks are held by tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from mppi_tf_tpu import roofline as jroofline
from mppi_tf_tpu_torch import flagship, roofline
from mppi_tf_tpu_torch.controller import MPPI
from mppi_tf_tpu_torch.costs import get_cost
from mppi_tf_tpu_torch.kernels import auv_mppi as auv
from mppi_tf_tpu_torch.kernels import pm_mppi as pm
from mppi_tf_tpu_torch.kernels.nn_mppi import FusedNNMPPI
from mppi_tf_tpu_torch.models import get_model
from mppi_tf_tpu_torch.models.nn import NNAUVModel

# the flagship shapes and constants of chip_smoke.py (the JAX bench's rows)
K, H, SIGMA, LAM, GAMMA = 100_000, 50, np.diag([0.25] * 3), 0.8, 0.2
GOAL, Q = [1.0, 0.0, 0.5, 0.0, -0.5, 0.0], [5.0, 1.0, 5.0, 1.0, 5.0, 1.0]
AUV_K, AUV_H, AUV_SIGMA, AUV_LAM = 262_144, 25, 1500.0 * np.eye(6), 0.5
NN_K, NN_H = 65_536, 25


def _pm(k=K, tau=H, **opts):
    model = get_model({"type": "point_mass", "mass": 1.0}, dt=0.1,
                      state_dim=6, action_dim=3)
    cost = get_cost({"type": "static", "diag": True, "goal": GOAL, "Q": Q},
                    lam=LAM, gamma=GAMMA, upsilon=1.0, sigma=SIGMA)
    return pm.FusedPointMassMPPI(model, cost, k=k, tau=tau, lam=LAM,
                                 upsilon=1.0, sigma=SIGMA, **opts)


def _auv(k=AUV_K, tau=AUV_H):
    model = get_model({**flagship.auv_params(), "rk": 2}, dt=0.1)
    cost = get_cost(flagship.auv_task(), lam=AUV_LAM, gamma=0.2,
                    upsilon=1.0, sigma=AUV_SIGMA)
    return auv.FusedAUVMPPI(model, cost, k=k, tau=tau, lam=AUV_LAM,
                            upsilon=1.0, sigma=AUV_SIGMA)


def _nn(k=NN_K, tau=NN_H):
    """chip_smoke.py's nn_fused on the CPU."""
    model = NNAUVModel(hidden=(32, 32, 32), seed=17)
    x_mean = np.zeros(16)
    x_mean[3] = 0.9
    model.set_normalization(
        x_mean, np.concatenate([[0.3] * 4, [0.5] * 6, np.diag(AUV_SIGMA)]),
        np.zeros(13), np.array([0.05] * 3 + [0.01] * 4 + [0.05] * 6))
    cost = get_cost(flagship.auv_task(), lam=AUV_LAM, gamma=0.2,
                    upsilon=1.0, sigma=AUV_SIGMA)
    return FusedNNMPPI(model, cost, k=k, tau=tau, lam=AUV_LAM, upsilon=1.0,
                       sigma=AUV_SIGMA)


def _dyn(fused):
    return roofline._rest_dyn(fused)


def test_headline_bounds_are_the_kernel_tables():
    """Rows 1, 3 and 4 at K=100,000, H=50 (PERF.md §6: solve 0.0135 and
    costs 0.0130 ms by operations, phase B 0.0076, the merge 0.00007 ms by
    bytes)."""
    f = _pm()
    c, d, n_z = f.consts, _dyn(f).numel(), H * 3
    nb = -(-K // pm.BLOCK)
    solve = roofline.bound_ms(roofline.solve_bytes(d, K, n_z),
                              roofline.solve_ops(c, K, H, prng=True))
    costs = roofline.bound_ms(roofline.solve_bytes(d, K, n_z, True),
                              roofline.solve_ops(c, K, H, prng=True,
                                                 costs_only=True))
    weights = roofline.bound_ms(roofline.weights_bytes(K, n_z),
                                roofline.weights_ops(K, n_z, True))
    merge = roofline.bound_ms(4.0 * nb * (pm.STATS + n_z)
                              + 4.0 * (n_z + pm.STATS), nb * (2.0 * n_z + 6))
    assert c.structure == "integrator"
    assert [round(b[0], 4) for b in (solve, costs, weights)] == [
        0.0135, 0.0130, 0.0076]
    assert round(merge[0], 5) == 0.00007
    assert [b[1] for b in (solve, costs, weights, merge)] == [
        "operations", "operations", "operations", "bytes"]


def test_auv_and_nn_bounds_are_the_kernel_tables():
    """Row 5 (rk2 solve 0.1038 ms), row 6 (costs 0.1026), row 8 (f32 ops
    0.1567 / 0.1564, tensor-core form 0.0803 / 0.0800)."""
    a = _auv()
    dyn = _dyn(a)
    n_z = AUV_H * 6
    solve = roofline.bound_ms(roofline.solve_bytes(dyn.numel(), AUV_K, n_z),
                              roofline.auv_solve_ops(a.consts, dyn, AUV_K,
                                                     AUV_H, prng=True))
    costs = roofline.bound_ms(
        roofline.solve_bytes(dyn.numel(), AUV_K, n_z, True),
        roofline.auv_solve_ops(a.consts, dyn, AUV_K, AUV_H, prng=True,
                               costs_only=True))
    assert (round(solve[0], 4), round(costs[0], 4)) == (0.1038, 0.1026)
    nn = _nn()
    c, d = nn.consts, _dyn(nn).numel()
    n_z = NN_H * 6
    b_s = roofline.solve_bytes(d, NN_K, n_z)
    b_c = roofline.solve_bytes(d, NN_K, n_z, True)
    f32 = [roofline.bound_ms(b, roofline.nn_solve_ops(
        c, NN_K, NN_H, prng=True, costs_only=co))[0]
        for b, co in ((b_s, False), (b_c, True))]
    tc = [roofline.nn_tc_bound(c, b, NN_K, NN_H, prng=True,
                               costs_only=co)[0]
          for b, co in ((b_s, False), (b_c, True))]
    assert [round(v, 4) for v in f32] == [0.1567, 0.1564]
    assert [round(v, 4) for v in tc] == [0.0803, 0.0800]


def test_bf16_and_variant_counts():
    """The bf16 row 1 · bf16 (0.0135 ms: at upsilon 1 the bf16 body has
    no z-quadratic either, as the f32 count) and the noise variants' terms:
    the schedule adds (dims + 1) a sample-step, antithetic saves the
    mirrored half's normals."""
    f = _pm(compute_dtype="bfloat16")
    d = _dyn(f).numel()
    ops = roofline.solve_ops(f.consts, K, H, prng=True)
    b = roofline.bf16_bound(roofline.solve_bytes(d, K, H * 3), ops,
                            roofline.bf16_rollout_ops(f.consts, K, H))
    assert round(b[0], 4) == 0.0135
    assert roofline.sched_ops(10, 4, 6) == 10 * 4 * 7
    assert roofline.mirror_saving(5, 2) == 2 * 2 * roofline.OPS_PER_NORMAL


@pytest.mark.parametrize("measured_ms", [0.0, 0.05, 1.3])
@pytest.mark.parametrize("work", [
    {"flops": 3.2e9, "trans": 1e5, "bm_pairs": 7.5e6, "hbm_bytes": 4e5},
    {"flops": 1e6, "trans": 5e8, "bm_pairs": 0, "hbm_bytes": 0},
    {"flops": 1e6, "hbm_bytes": 9e9}])
def test_classify_equals_jax(work, measured_ms):
    ceil = {"vpu_flops": 6.1e13, "transcendental_per_s": 4.1e12,
            "hbm_bytes_per_s": 3.0e12, "bm_pairs_per_s": 2.9e11}
    assert roofline.classify(work, ceil, measured_ms) == \
        jroofline.classify(work, ceil, measured_ms)


def test_classify_without_pair_ceiling_equals_jax():
    work = {"flops": 1e9, "bm_pairs": 1e6, "hbm_bytes": 1e3}
    ceil = {"vpu_flops": 1e12, "transcendental_per_s": 1e11,
            "hbm_bytes_per_s": 1e11}
    assert roofline.classify(work, ceil, 2.0) == jroofline.classify(
        work, ceil, 2.0)


def test_xla_solve_work_equals_jax():
    args = (5000, 30, 3, 40, 40, 6)
    assert roofline.xla_solve_work(*args) == jroofline.xla_solve_work(*args)


@pytest.mark.parametrize("normalize", [False, True])
def test_work_models_split_the_counts(normalize):
    """A work model's f32 operations plus its normals at OPS_PER_NORMAL
    give the count of its kernels (the fused solve, or the costs kernel
    and phase B); its bytes are theirs."""
    k, tau = 3000, 12
    for fused, ops in ((_pm(k, tau), lambda f, **kw: roofline.solve_ops(
            f.consts, k, tau, **kw)),
            (_auv(k, tau), lambda f, **kw: roofline.auv_solve_ops(
                f.consts, _dyn(f), k, tau, **kw)),
            (_nn(k, tau), lambda f, **kw: roofline.nn_solve_ops(
                f.consts, k, tau, **kw))):
        work = {pm.FusedPointMassMPPI: roofline.pm_work,
                auv.FusedAUVMPPI: roofline.auv_work,
                FusedNNMPPI: roofline.nn_work}[type(fused)](fused, normalize)
        n_z = tau * fused.adim
        noise = 2.0 * work["bm_pairs"] * roofline.OPS_PER_NORMAL
        if normalize:
            want = (ops(fused, prng=True, costs_only=True)
                    + roofline.weights_ops(k, n_z, True))
        else:
            want = ops(fused, prng=True)
        assert work["flops"] + noise == pytest.approx(want, rel=1e-12)
        assert work["trans"] >= k and work["hbm_bytes"] > 0


def test_roofline_for_workload_reads_the_controller(monkeypatch):
    """A torch-route controller gets the torch route's model, a kernel
    route its kernels'; both against the ceilings of the controller's
    device."""
    model = get_model({"type": "point_mass", "mass": 1.0}, dt=0.1,
                      state_dim=6, action_dim=3)
    cost = get_cost({"type": "static", "diag": True, "goal": GOAL, "Q": Q},
                    lam=LAM, gamma=GAMMA, upsilon=1.0, sigma=SIGMA)
    ctrl = MPPI(model, cost, k=512, tau=10, lam=LAM, sigma=SIGMA,
                device="cpu")
    ceil = {"vpu_flops": 1e12, "transcendental_per_s": 1e11,
            "hbm_bytes_per_s": 1e11, "bm_pairs_per_s": 1e10}
    devices = []
    monkeypatch.setattr(roofline, "measure_ceilings",
                        lambda device: devices.append(device) or ceil)
    row = roofline.roofline_for_workload("point_mass", ctrl, 0.5)
    assert row == roofline.classify(
        roofline.xla_solve_work(512, 10, 3, 40, 40, 6), ceil, 0.5)
    ctrl._resolve_kernel("auto", SIGMA, None)     # the kernels' plain route
    row = roofline.roofline_for_workload("point_mass", ctrl, 0.5)
    assert row == roofline.classify(roofline.pm_work(ctrl._fused), ceil, 0.5)
    assert [torch.device(d).type for d in devices] == ["cpu", "cpu"]


def test_measure_ceilings_cpu_plain_versions():
    ceil = roofline.measure_ceilings(device="cpu", reps=1)
    assert (ceil["backend"], ceil["device"]) == ("cpu", "cpu")
    for key in ("vpu_flops", "transcendental_per_s", "bm_pairs_per_s",
                "hbm_bytes_per_s"):
        assert np.isfinite(ceil[key]) and ceil[key] > 0, key


def test_measure_ceilings_default_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no GPU"):
        roofline.measure_ceilings()
