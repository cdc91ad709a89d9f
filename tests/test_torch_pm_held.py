"""The held prefix of the unnormalised point-mass solve on the CPU: the
rule that sizes it (``kernels/pm_mppi.py`` ``held_normals``) and the
``pm_z_held`` counter, with the launch mocked."""

import pytest
import torch

from mppi_tf_tpu_torch import tracing
from mppi_tf_tpu_torch.controller import graph
from mppi_tf_tpu_torch.kernels import _launch
from mppi_tf_tpu_torch.kernels import pm_mppi as pm

#: the H100's shared memory: a block's opt-in, an SM's, reserved a block
H100 = pm.SmemLimits(232_448, 233_472, 1_024)
#: the A100's
A100 = pm.SmemLimits(166_912, 167_936, 1_024)


def _held(sdim, adim, tau, structure="integrator", limits=H100,
          dynamic_ab=False, scheduled=False):
    size = pm.Dyn(tau, sdim, adim, dynamic_ab, scheduled).size
    return pm.held_normals(sdim, adim, tau, structure, size, limits)


@pytest.mark.parametrize("case,want", [
    # the headline point mass: the longest prefix two blocks an SM hold
    (((6, 3, 50), {}), 104),
    # every normal where they fit: (4, 2) and (2, 1) at H=50
    (((4, 2, 50), {}), 100),
    (((2, 1, 50), {}), 50),
    # a whole-Philox-block prefix at H=100, scheduled or not, and at a
    # normal count off the Philox grid
    (((6, 3, 100), {"scheduled": True}), 96),
    (((6, 3, 100), {}), 96),
    (((6, 3, 101), {}), 96),
    # the dense structure beside its rows of A and B scale
    (((6, 3, 50), {"structure": "dense", "dynamic_ab": True}), 104),
    # a card with less shared memory holds less
    (((6, 3, 50), {"limits": A100}), 72),
    # none where dyn and the pass-two sums alone outgrow the block
    (((6, 3, 1000), {}), 0),
])
def test_held_normals_rule(case, want):
    (sdim, adim, tau), kw = case
    assert _held(sdim, adim, tau, **kw) == want


@pytest.mark.parametrize("sdim,adim", [(6, 3), (4, 2), (2, 1)])
@pytest.mark.parametrize("tau", [1, 7, 25, 50, 73, 100, 101, 300])
@pytest.mark.parametrize("structure", ["integrator", "dense"])
@pytest.mark.parametrize("limits", [H100, A100])
def test_held_prefix_fits_two_blocks_and_is_the_longest(sdim, adim, tau,
                                                        structure, limits):
    """Every normal or whole Philox blocks; the block's shared memory with
    the prefix fits the opt-in and two blocks an SM; four normals more
    would not (unless all are held)."""
    n_z = tau * adim
    size = pm.Dyn(tau, sdim, adim).size
    held = pm.held_normals(sdim, adim, tau, structure, size, limits)
    assert 0 <= held <= n_z and (held == n_z or held % 4 == 0)

    def fits(h):
        lead = 4 * (-(-size // 4) * 4 + pm.ab_words(sdim, adim, structure)
                    + pm.WARPS * n_z) + pm.STATIC_SMEM
        block = lead + 4 * pm.BLOCK * h
        return (block <= limits.block_optin
                and 2 * (block + limits.reserved) <= limits.sm)

    if held > 0:
        assert fits(held)
    if held < n_z:
        assert not fits(min(held + 4, n_z))


@pytest.fixture
def mocked_launch(monkeypatch):
    """pm_fused_solve's launch on CPU tensors, recorded, not run; the card
    an H100; ``capturing`` toggles the stream's capture."""
    calls, state = [], {"capturing": False}
    monkeypatch.setattr(pm, "on_card", lambda *t: True)
    monkeypatch.setattr(pm, "launch",
                        lambda name, device, *args: calls.append(
                            (name, args)))
    monkeypatch.setattr(pm, "smem_limits", lambda device: H100)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: state["capturing"])
    return calls, state


def _solve(n=None, k=1000, tau=50, compute_dtype="float32"):
    from mppi_tf_tpu_torch.costs import get_cost
    from mppi_tf_tpu_torch.models import get_model

    model = get_model({"type": "point_mass", "mass": 1.0}, dt=0.1,
                      state_dim=6, action_dim=3, device="cpu")
    cost = get_cost({"type": "static", "diag": True, "goal": [0.0] * 6,
                     "Q": [1.0] * 6}, lam=0.8, gamma=0.2, upsilon=1.0,
                    sigma=0.25 * torch.eye(3).numpy(), device="cpu")
    f = pm.FusedPointMassMPPI(model, cost, k=k, tau=tau, lam=0.8,
                              upsilon=1.0, sigma=0.25 * torch.eye(3).numpy(),
                              compute_dtype=compute_dtype)
    size = pm.Dyn(tau, 6, 3).size
    dyn = torch.zeros(size if n is None else (n, size))
    return f.consts, dyn, k, tau


@pytest.mark.parametrize("n", [None, 3])
def test_pm_z_held_counts_held_and_redrawn_normals(mocked_launch, n):
    """A launch passes the rule's held count last before the stream and
    adds its held and redrawn normals, over every vehicle's samples, to
    ``tracing.counters()["pm_z_held"]``; a launch recorded into a graph
    adds to ``captured_z_held`` instead, and its replays add as
    ``launch_counts`` do (``graph.add_replays``)."""
    calls, state = mocked_launch
    consts, dyn, k, tau = _solve(n)
    assert consts.structure == "integrator"
    vehicles = n or 1
    held = _held(6, 3, tau)
    before = tracing.counters()["pm_z_held"]
    pm.pm_fused_solve(consts, dyn, k, tau, seed=1, solve=2)
    name, args = calls[-1]
    assert name == "pm_fused_solve" and args[-1] == held
    assert args[-2] == vehicles
    got = tracing.counters()["pm_z_held"]
    assert got == {"held": before["held"] + vehicles * k * held,
                   "redrawn": before["redrawn"]
                   + vehicles * k * (3 * tau - held)}
    assert held / (held + 3 * tau - held) == pytest.approx(104 / 150)

    state["capturing"] = True
    cap_before = dict(_launch.captured_z_held)
    pm.pm_fused_solve(consts, dyn, k, tau, seed=1, solve=2)
    state["capturing"] = False
    assert tracing.counters()["pm_z_held"] == got
    per_replay = {key: _launch.captured_z_held[key] - cap_before[key]
                  for key in cap_before}
    assert per_replay == {"held": vehicles * k * held,
                          "redrawn": vehicles * k * (3 * tau - held)}
    graph.add_replays({}, {}, 5, per_replay)
    assert tracing.counters()["pm_z_held"] == {
        key: got[key] + 5 * per_replay[key] for key in got}


def test_pm_z_held_counts_a_bf16_solve_as_redrawn(mocked_launch):
    """The bf16 build draws every normal again: held 0."""
    calls, _ = mocked_launch
    consts, dyn, k, tau = _solve(compute_dtype="bfloat16")
    before = tracing.counters()["pm_z_held"]
    pm.pm_fused_solve(consts, dyn, k, tau)
    name, args = calls[-1]
    assert name == "pm_fused_solve_bf16" and args[-1] == 0
    assert tracing.counters()["pm_z_held"] == {
        "held": before["held"], "redrawn": before["redrawn"] + k * 3 * tau}


def test_costs_phase_holds_nothing(mocked_launch):
    """Phase A has no pass two: its launch takes no held count and
    counts nothing."""
    calls, _ = mocked_launch
    consts, dyn, k, tau = _solve()
    before = tracing.counters()["pm_z_held"]
    pm.pm_fused_costs(consts, dyn, k, tau)
    assert calls[-1][0] == "pm_fused_costs"
    assert tracing.counters()["pm_z_held"] == before
