"""The port's control server (``mppi_tf_tpu_torch/serve.py``) on the CPU.

Every case of tests/test_serve.py against the port's server; transcripts
of one request sequence sent to the JAX server serving JAX controllers
and to the port's server serving the port's controllers, at f64 on the
same injected noise (replies within 1e-10, the same keys, an error reply
wherever JAX gives one); the two deviations by design (an m-step reply
advances the stored plan by m, and m > tau + 1 is an error; ``info``'s
``kernel`` is the port's ``kernel_path``), each held by its own test; a
deterministic coalescer batch; and ``python -m mppi_tf_tpu_torch.serve
--cpu`` announcing its address.
"""

import contextlib
import json
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_tf_tpu import serve as jserve
from mppi_tf_tpu.controller import FleetMPPI as JFleetMPPI
from mppi_tf_tpu.controller import MPPI as JMPPI
from mppi_tf_tpu.controller.dmd import DMDMPPI as JDMDMPPI
from mppi_tf_tpu.costs import get_cost as jget_cost
from mppi_tf_tpu.models import get_model as jget_model
from mppi_tf_tpu.models.dmd import DMDModel as JDMDModel
from mppi_tf_tpu_torch import serve
from mppi_tf_tpu_torch.controller import FleetMPPI, MPPI
from mppi_tf_tpu_torch.controller.dmd import DMDMPPI
from mppi_tf_tpu_torch.costs import get_cost
from mppi_tf_tpu_torch.costs.waypoints import WayPointsCost
from mppi_tf_tpu_torch.models import get_model
from mppi_tf_tpu_torch.models.dmd import DMDModel
from mppi_tf_tpu_torch.ops import noise as noise_ops
from mppi_tf_tpu_torch.serve import ControlClient, ControlServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
SIGMA = np.diag([0.4, 0.4])
GOAL = [1.0, 0.0, -0.5, 0.0]
Q4 = [8.0, 1.5, 8.0, 1.5]
STATIC = {"type": "static", "diag": True, "goal": GOAL, "Q": Q4}
#: the port's plain route against JAX's XLA route at f64 on the same
#: normals: the same ops but for each package's own reductions
TOL = 1e-10


def _family(dtype=F64):
    model = get_model({"type": "point_mass", "mass": 1.0}, dt=0.1,
                      state_dim=4, action_dim=2, dtype=dtype)
    cost = get_cost(STATIC, lam=0.6, gamma=0.2, upsilon=1.0, sigma=SIGMA,
                    dtype=dtype)
    return model, cost


def _jfamily(task=STATIC):
    model = jget_model({"type": "point_mass", "mass": 1.0}, dt=0.1,
                       state_dim=4, action_dim=2, dtype=jnp.float64)
    cost = jget_cost(task, lam=0.6, gamma=0.2, upsilon=1.0, sigma=SIGMA,
                     dtype=jnp.float64)
    return model, cost


def _step(model):
    """The plant: the port model's one-step prediction at f64."""
    def step(x, u):
        with torch.no_grad():
            return model.predict(torch.as_tensor(x, dtype=F64),
                                 torch.as_tensor(u, dtype=F64)).numpy()
    return step


@contextlib.contextmanager
def _serving(ctrl, module=serve):
    server = module.ControlServer(ctrl)
    host, port = server.serve_background()
    client = module.ControlClient(host, port)
    try:
        yield client
    finally:
        client.close()
        server.close()


@pytest.fixture()
def served():
    model, cost = _family()
    ctrl = MPPI(model, cost, k=256, tau=15, lam=0.6, upsilon=1.0,
                sigma=SIGMA, seed=2, device="cpu")
    with _serving(ctrl) as client:
        yield model, ctrl, client


def _wp_cost(waypoints):
    return WayPointsCost(0.4, 0.1, 1.0, SIGMA, Q=np.array(
        [6.0, 0.6, 6.0, 0.6]), diag=True, waypoints=waypoints, dtype=F64)


# ---- the cases of tests/test_serve.py -----------------------------------------

def test_served_closed_loop_converges(served):
    """The plant held by the 'vehicle stack' (this test), the controller
    behind the socket: the served loop reaches the goal, then a set_goal
    over the wire re-targets it."""
    model, _ctrl, client = served
    info = client.info()
    assert info["controller"] == "MPPI" and info["k"] == 256
    step = _step(model)
    x = np.zeros(4)
    for _ in range(60):
        u = client.next(x)
        assert u.shape == (2,)
        x = step(x, u)
    assert np.linalg.norm(x[0::2] - np.array([1.0, -0.5])) < 0.25, x
    client.set_goal([-0.5, 0.0, 0.8, 0.0])
    for _ in range(60):
        x = step(x, client.next(x))
    assert np.linalg.norm(x[0::2] - np.array([-0.5, 0.8])) < 0.25, x


def test_server_survives_bad_requests(served):
    """Protocol errors come back as {'error': ...} and the same connection
    keeps serving."""
    _model, _ctrl, client = served
    assert client.request(op="ping") == {"ok": True}
    assert "unknown op" in client.request(op="warp")["error"]
    assert "error" in client.request(op="next", state=[[1, 2], [3]])
    assert "error" in client.request(op="next")
    assert client.next(np.zeros(4)).shape == (2,)
    # save() without an observer is a no-op on plain MPPI
    assert client.request(op="save", x=[0, 0, 0, 0], u=[0, 0],
                          x_next=[0, 0, 0, 0]) == {"ok": True}


def test_served_adaptive_dmd_identifies_over_the_wire():
    """save() ticks stream transitions into the served DMD controller; the
    identification runs server-side."""
    model, cost = _family()
    ctrl = DMDMPPI(DMDModel(4, 2, reg=1e-10, dtype=F64), cost, k=64, tau=8,
                   lam=0.6, upsilon=1.0, sigma=SIGMA, seed=2, refit_every=4,
                   min_samples=6, device="cpu")
    step = _step(model)
    with _serving(ctrl) as client:
        rng = np.random.default_rng(0)
        x = np.zeros(4)
        for _ in range(8):
            u = rng.uniform(-1, 1, 2)
            xn = step(x, u)
            client.save(x, u, xn)
            x = xn
    assert ctrl.n_fits >= 1
    np.testing.assert_allclose(ctrl.model_params["A"].numpy(),
                               model.A.numpy(), atol=1e-4)


def test_close_before_serving_returns_promptly():
    """close() on a server whose accept loop never started returns (the
    shutdown Event is only ever set by serve_forever)."""
    model, cost = _family()
    server = ControlServer(MPPI(model, cost, k=8, tau=3, lam=0.6,
                                upsilon=1.0, sigma=SIGMA, device="cpu"))
    t0 = time.perf_counter()
    server.close()
    assert time.perf_counter() - t0 < 1.0


def test_served_fleet():
    """A FleetMPPI behind the endpoint: batched states in, batched actions
    out, re-tasking through set_goal [n, dim], one goal, or a vehicle."""
    model, cost = _family()
    goals = np.array([[1.0, 0.0, -0.5, 0.0], [-0.8, 0.0, 0.3, 0.0]])
    fleet = FleetMPPI(model, cost, n_vehicles=2, k=64, tau=8, lam=0.6,
                      upsilon=1.0, sigma=SIGMA, goals=goals, seed=2,
                      device="cpu")
    with _serving(fleet) as client:
        assert client.info()["n_vehicles"] == 2
        assert client.next(np.zeros((2, 4))).shape == (2, 2)
        client.set_goal(np.array([[0.2, 0.0, 0.2, 0.0],
                                  [0.4, 0.0, 0.4, 0.0]]))
        np.testing.assert_allclose(fleet.cost_params["goal"][1].numpy(),
                                   [0.4, 0.0, 0.4, 0.0])
        client.set_goal([0.7, 0.0, -0.7, 0.0])
        np.testing.assert_allclose(fleet.cost_params["goal"].numpy(),
                                   np.tile([0.7, 0.0, -0.7, 0.0], (2, 1)))
        assert client.request(op="set_goal", vehicle=1,
                              goal=[0.1, 0.0, 0.1, 0.0]) == {"ok": True}
        np.testing.assert_allclose(fleet.cost_params["goal"][0].numpy(),
                                   [0.7, 0.0, -0.7, 0.0])
        np.testing.assert_allclose(fleet.cost_params["goal"][1].numpy(),
                                   [0.1, 0.0, 0.1, 0.0])


def test_served_mission_single_controller():
    """A 2-leg mission over the wire: upload, fly it through next() +
    advance_waypoints (the queue pops server-side), finish on the last
    leg."""
    wp1, wp2 = [0.8, 0.0, 0.0, 0.0], [0.8, 0.0, -0.7, 0.0]
    model, _ = _family()
    ctrl = MPPI(model, _wp_cost([wp1]), k=300, tau=12, lam=0.4, upsilon=1.0,
                sigma=SIGMA, seed=5, device="cpu")
    step = _step(model)
    with _serving(ctrl) as client:
        client.set_waypoints([wp1, wp2])
        assert ctrl.waypoints_remaining() == 2
        x, popped = np.zeros(4), 0
        for _ in range(160):
            x = step(x, client.next(x))
            resp = client.advance_waypoints(x, radius=0.25)
            popped += resp["advanced"]
            if resp["remaining"] == 1 and \
                    np.linalg.norm(x - np.asarray(wp2)) < 0.2:
                break
        assert popped == 1
        assert np.linalg.norm(x - np.asarray(wp2)) < 0.2
        assert "error" in client.request(op="set_waypoints")


def test_served_fleet_mission_ops():
    """Per-vehicle mission upload and whole-fleet queue advancement."""
    wp_a = [[0.6, 0.0, 0.0, 0.0], [0.6, 0.0, 0.6, 0.0]]
    wp_b = [[-0.5, 0.0, 0.0, 0.0]]
    model, _ = _family()
    fleet = FleetMPPI(model, _wp_cost([[0.0, 0.0, 0.0, 0.0]]), n_vehicles=2,
                      k=64, tau=8, lam=0.4, upsilon=1.0, sigma=SIGMA, seed=2,
                      device="cpu")
    with _serving(fleet) as client:
        client.set_waypoints(wp_a, vehicle=0)
        client.set_waypoints(wp_b, vehicle=1)
        np.testing.assert_array_equal(fleet.waypoints_remaining(), [2, 1])
        resp = client.request(op="set_waypoints", waypoints=wp_a)
        assert "vehicle" in resp["error"]
        resp = client.advance_waypoints(np.asarray([wp_a[0], wp_b[0]]),
                                        radius=0.25)
        assert resp["advanced"] == 1 and resp["remaining"] == [1, 1]


def test_served_quat_mission_ops():
    """Quaternion waypoint missions: a non-unit quaternion is an error
    reply, and advance_waypoints pops with the quaternion metric."""
    from tests.test_auv_kernel import _auv_cfg

    sigma = np.diag([2000.0] * 3 + [200.0] * 3)
    model = get_model(_auv_cfg(), dt=0.1, action_dim=6, dtype=F64)
    wp1, wp2 = np.zeros(13), np.zeros(13)
    wp1[2], wp1[6], wp2[2], wp2[6] = -1.0, 1.0, -2.0, 1.0
    cost = get_cost({"type": "waypoints_quat", "diag": True,
                     "waypoints": [wp1.tolist()],
                     "Q": [60.0, 60.0, 60.0, 10.0] + [1.0] * 6},
                    lam=0.5, gamma=0.2, upsilon=1.0, sigma=sigma, dtype=F64)
    ctrl = MPPI(model, cost, k=64, tau=4, lam=0.5, upsilon=1.0, sigma=sigma,
                seed=5, device="cpu")
    with _serving(ctrl) as client:
        resp = client.request(op="set_waypoints",
                              waypoints=[np.zeros(13).tolist()])
        assert "error" in resp and "unit" in resp["error"]
        client.set_waypoints([wp1.tolist(), wp2.tolist()])
        assert ctrl.waypoints_remaining() == 2
        x = np.zeros(13)
        x[6] = 1.0
        assert client.next(x).shape == (6,)
        resp = client.advance_waypoints(wp1.tolist(), radius=0.5)
        assert resp["advanced"] == 1 and resp["remaining"] == 1


def test_served_vehicle_index_on_single_controller_rejected():
    """A 'vehicle' index sent to a single controller's set_waypoints is an
    error reply and the queue is untouched."""
    wp1, wp2 = [0.8, 0.0, 0.0, 0.0], [0.8, 0.0, -0.7, 0.0]
    model, _ = _family()
    ctrl = MPPI(model, _wp_cost([wp1]), k=32, tau=4, lam=0.4, upsilon=1.0,
                sigma=SIGMA, seed=5, device="cpu")
    with _serving(ctrl) as client:
        client.set_waypoints([wp1, wp2])
        resp = client.request(op="set_waypoints", waypoints=[wp1], vehicle=0)
        assert "error" in resp and "not a fleet" in resp["error"]
        assert ctrl.waypoints_remaining() == 2


def test_served_set_goal_vehicle_index_on_single_controller_rejected():
    """The same guard on set_goal: no silent full re-goal."""
    model, cost = _family()
    ctrl = MPPI(model, cost, k=32, tau=4, lam=0.6, upsilon=1.0, sigma=SIGMA,
                seed=5, device="cpu")
    goal_before = ctrl._cost.params()["goal"].clone()
    with _serving(ctrl) as client:
        resp = client.request(op="set_goal", goal=[9.0, 0.0, 9.0, 0.0],
                              vehicle=2)
        assert "error" in resp and "not a fleet" in resp["error"]
    assert torch.equal(ctrl._cost.params()["goal"], goal_before)


def test_mstep_reply_single_controller(served):
    """{"op": "next", "m": 5}: the first m actions of the updated plan U';
    the stored plan is then U'[5:] padded with the init action (the port's
    deviation: JAX's stays U'[1:] padded); m = 1 is the plain reply shape
    and m = 0 an error."""
    _model, ctrl, client = served
    plan = client.next_plan(np.zeros(4), m=5)
    assert plan.shape == (5, 2)
    # U'[5:] first, then the init action (zeros) five times
    assert np.all(ctrl.useq.numpy()[:10] != 0.0)
    np.testing.assert_array_equal(ctrl.useq.numpy()[10:], 0.0)
    resp = client.request(op="next", state=[0.0] * 4, m=1)
    assert "actions" not in resp and len(resp["action"]) == 2
    assert "error" in client.request(op="next", state=[0.0] * 4, m=0)


def test_mstep_open_loop_tracks(served):
    """Driving the plant with m-step replies (replan every m ticks)
    converges."""
    model, _ctrl, client = served
    step = _step(model)
    x = np.zeros(4)
    for _ in range(25):
        for u in client.next_plan(x, m=3):
            x = step(x, u)
    assert np.linalg.norm(x[0::2] - np.array([1.0, -0.5])) < 0.3, x


class _HeldCoalescer(serve._FleetCoalescer):
    """A coalescer whose dispatcher waits for ``release`` before it takes
    its first request, so that the test decides what is queued."""

    release = None

    def _run(self):
        assert self.release.wait(30)
        super()._run()


def _held_fleet_server(monkeypatch, n=4):
    model, cost = _family()
    fleet = FleetMPPI(model, cost, n_vehicles=n, k=64, tau=8, lam=0.6,
                      upsilon=1.0, sigma=SIGMA,
                      goals=np.tile(GOAL, (n, 1)), seed=2, device="cpu")
    release = threading.Event()
    monkeypatch.setattr(_HeldCoalescer, "release", release)
    monkeypatch.setattr(serve, "_FleetCoalescer", _HeldCoalescer)
    return fleet, ControlServer(fleet), release


def _hammer(host, port, reqs: dict) -> tuple:
    """One client thread a vehicle, each sending its request; returns
    (threads, results)."""
    results = {}

    def run(v):
        c = ControlClient(host, port)
        try:
            results[v] = c.request(**reqs[v])
        finally:
            c.close()

    threads = [threading.Thread(target=run, args=(v,)) for v in reqs]
    for t in threads:
        t.start()
    return threads, results


def _wait_queued(server, n):
    t0 = time.perf_counter()
    while server._coalescer._q.qsize() < n:
        assert time.perf_counter() - t0 < 30, "requests never queued"
        time.sleep(0.005)


def test_fleet_coalescing_batches_concurrent_requests(monkeypatch):
    """Four concurrent per-vehicle requests, all queued before the
    dispatcher takes the first, are served by ONE dispatch (batched == 4),
    each client with its own vehicle's row of that dispatch; m-step and
    vehicle compose."""
    fleet, server, release = _held_fleet_server(monkeypatch)
    calls = []
    real_next = fleet.next

    def recorded(states):
        actions = real_next(states)
        calls.append((np.array(states), actions.copy()))
        return actions

    fleet.next = recorded
    host, port = server.serve_background()
    try:
        reqs = {v: {"op": "next", "vehicle": v, "state": [0.1 * v] * 4}
                for v in range(4)}
        threads, results = _hammer(host, port, reqs)
        _wait_queued(server, 4)
        release.set()
        for t in threads:
            t.join(timeout=30)
        assert set(results) == {0, 1, 2, 3}
        assert [r["batched"] for r in results.values()] == [4] * 4
        assert len(calls) == 1
        states, actions = calls[0]
        np.testing.assert_array_equal(states, [[0.1 * v] * 4
                                               for v in range(4)])
        for v, r in results.items():
            assert r["action"] == actions[v].tolist()
        c = ControlClient(host, port)
        try:
            plan = c.next_plan([0.0] * 4, m=4, vehicle=2)
            assert plan.shape == (4, 2)
        finally:
            c.close()
    finally:
        server.close()


def test_coalescer_rejects_a_bad_state_for_that_request_alone(monkeypatch):
    """A one-element state (which numpy would broadcast over the vehicle's
    row) and a short state are error replies before they are queued; a
    good request held in the same batch still gets its row, planned from
    the cached states of the other vehicles."""
    fleet, server, release = _held_fleet_server(monkeypatch)
    calls = []
    real_next = fleet.next

    def recorded(states):
        actions = real_next(states)
        calls.append((np.array(states), actions.copy()))
        return actions

    fleet.next = recorded
    host, port = server.serve_background()
    try:
        good = [0.3, -0.1, 0.2, 0.0]
        threads, results = _hammer(
            host, port, {0: {"op": "next", "vehicle": 0, "state": good}})
        _wait_queued(server, 1)
        bad = {1: [0.5], 2: [0.1, 0.2]}
        for v, state in bad.items():
            c = ControlClient(host, port)
            try:
                resp = c.request(op="next", vehicle=v, state=state)
            finally:
                c.close()
            assert "error" in resp and "shape" in resp["error"], resp
        assert server._coalescer._q.qsize() == 1
        release.set()
        for t in threads:
            t.join(timeout=30)
        assert results[0]["batched"] == 1
        assert len(calls) == 1
        states, actions = calls[0]
        np.testing.assert_array_equal(states[0], good)
        np.testing.assert_array_equal(states[1:], 0.0)
        assert results[0]["action"] == actions[0].tolist()
    finally:
        server.close()


def test_vehicle_next_on_single_controller_rejected(served):
    _model, _ctrl, client = served
    resp = client.request(op="next", vehicle=0, state=[0.0] * 4)
    assert "FleetMPPI" in resp["error"]


def test_coalescer_vehicle_out_of_range():
    model, cost = _family()
    fleet = FleetMPPI(model, cost, n_vehicles=2, k=32, tau=5, lam=0.6,
                      upsilon=1.0, sigma=SIGMA, seed=2, device="cpu")
    with _serving(fleet) as client:
        resp = client.request(op="next", vehicle=7, state=[0.0] * 4)
        assert "out of range" in resp["error"]
        assert client.next([0.0] * 4, vehicle=1).shape == (2,)


# ---- transcripts: the JAX server and the port's on one request sequence -----

def _inject_single(monkeypatch, jctrl, eps):
    """eps[s] is the noise of the s-th solve of both controllers: JAX's
    jitted solve is replaced by its injected-noise twin, the port draws
    through ``noise_ops.sample_noise``."""
    jctrl._solve_jit = lambda key, state, useq, mp, cp, sched=None: \
        jctrl._solve_with_noise_jit(jnp.asarray(eps[jctrl._steps]), state,
                                    useq, mp, cp)
    draws = iter(torch.as_tensor(eps))
    monkeypatch.setattr(noise_ops, "sample_noise",
                        lambda *a, **kw: next(draws))


def _inject_fleet(monkeypatch, jfleet, eps):
    """eps[s, v]: vehicle v's noise at fleet step s, in both packages."""
    n = jfleet.n_vehicles
    tpl = jfleet._tpl

    def step(seed, keys, states, useq, mp, cp):
        s = jfleet._steps
        outs = [tpl._solve_with_noise(
            jnp.asarray(eps[s, v]), states[v], useq[v], mp,
            jax.tree.map(lambda x, v=v: x[v], cp)) for v in range(n)]
        return (jnp.stack([o[0] for o in outs]),
                jnp.stack([o[1] for o in outs]), keys, {})

    jfleet._step_jit = step
    draws = iter(torch.as_tensor(eps.reshape(-1, *eps.shape[2:])))
    monkeypatch.setattr(noise_ops, "sample_noise",
                        lambda *a, **kw: next(draws))


def _jax_advance(jctrl, req):
    """The port's m-step deviation applied to the JAX controller after its
    reply: its plan shifted m - 1 further steps (that vehicle's row for a
    coalesced request), so the two stay comparable."""
    m = int(req.get("m", 1))
    if req.get("op") != "next" or m < 2:
        return
    u = np.array(jctrl._useq)
    rows = [req["vehicle"]] if "vehicle" in req else slice(None)
    pad = np.zeros_like(u[..., :m - 1, :])
    u[rows] = np.concatenate([u[..., m - 1:, :], pad], axis=-2)[rows]
    jctrl._useq = jnp.asarray(u)


def _same_reply(rj: dict, rp: dict, req: dict) -> None:
    assert set(rp) == set(rj), (req, rj, rp)
    for key, vj in rj.items():
        vp = rp[key]
        if key in ("solve_ms", "error"):
            continue
        if key == "kernel":   # the second deviation by design
            assert (vj, vp) == ("xla", "torch"), (req, vj, vp)
        elif key in ("action", "actions"):
            np.testing.assert_allclose(vp, vj, rtol=0, atol=TOL,
                                       err_msg=str(req))
        else:
            assert vp == vj, (req, key, vj, vp)


def _transcript(jctrl, pctrl, requests) -> list:
    """Each request to both servers in turn; the replies compared."""
    replies = []
    with _serving(jctrl, jserve) as jc, _serving(pctrl) as pc:
        for req in requests:
            rj, rp = jc.request(**req), pc.request(**req)
            _same_reply(rj, rp, req)
            if "error" not in rj:
                _jax_advance(jctrl, req)
            replies.append((rj, rp))
    return replies


def _states(n_req, shape, seed):
    return np.random.default_rng(seed).normal(scale=0.5,
                                              size=(n_req, *shape))


def test_transcript_single_controller(monkeypatch):
    """next, m-step next, set_goal, info, ping, save and bad ops on the
    static cost: the same replies from both servers (1e-10 at f64)."""
    k, tau = 64, 8
    jm, jcost = _jfamily()
    jctrl = JMPPI(jm, jcost, k=k, tau=tau, lam=0.6, upsilon=1.0,
                  sigma=SIGMA, seed=2)
    pm, pcost = _family()
    pctrl = MPPI(pm, pcost, k=k, tau=tau, lam=0.6, upsilon=1.0, sigma=SIGMA,
                 seed=2, device="cpu")
    eps = _states(12, (k, tau, 2), 0) @ SIGMA.T
    _inject_single(monkeypatch, jctrl, eps)
    xs = _states(12, (4,), 1).tolist()
    reqs = [{"op": "info"}, {"op": "ping"},
            {"op": "next", "state": xs[0]}, {"op": "next", "state": xs[1]},
            {"op": "next", "state": xs[2], "m": 3},
            {"op": "next", "state": xs[3]},
            {"op": "set_goal", "goal": [-0.5, 0.0, 0.8, 0.0]},
            {"op": "next", "state": xs[4], "m": tau + 1},
            {"op": "next", "state": xs[5]},
            {"op": "next", "state": xs[6], "m": 1},
            {"op": "save", "x": xs[6], "u": [0.1, 0.2], "x_next": xs[7]},
            {"op": "set_goal", "goal": [0.0] * 4, "vehicle": 1},
            {"op": "next", "state": xs[7], "vehicle": 0},
            {"op": "next", "state": xs[7], "m": 0},
            {"op": "next"}, {"op": "next", "state": [[1, 2], [3]]},
            {"op": "warp"}, {"op": "set_waypoints", "waypoints": [GOAL]},
            {"op": "next", "state": xs[8], "m": 2},
            {"op": "next", "state": xs[9]}]
    replies = _transcript(jctrl, pctrl, reqs)
    assert replies[0][1]["kernel"] == pctrl.kernel_path == "torch"
    assert sum("error" in rj for rj, _ in replies) == 7
    assert jctrl._steps == pctrl._steps == 9
    np.testing.assert_allclose(pctrl.useq.numpy(), np.asarray(jctrl._useq),
                               rtol=0, atol=TOL)


def test_transcript_mission(monkeypatch):
    """set_waypoints, advance_waypoints and next on a waypoint cost, in
    both servers; the vehicle-index guard."""
    k, tau = 64, 8
    wps = [[0.6, 0.0, 0.0, 0.0], [0.6, 0.0, 0.6, 0.0], [0.0, 0.0, 0.6, 0.0]]
    task = {"type": "waypoints", "diag": True, "alpha": 0.2,
            "waypoints": [[0.0, 0.0, 0.0, 0.0]], "Q": [6.0, 0.6, 6.0, 0.6]}
    jm, jcost = _jfamily(task)
    jctrl = JMPPI(jm, jcost, k=k, tau=tau, lam=0.6, upsilon=1.0,
                  sigma=SIGMA, seed=3)
    pm, _ = _family()
    pcost = get_cost(task, lam=0.6, gamma=0.2, upsilon=1.0, sigma=SIGMA,
                     dtype=F64)
    pctrl = MPPI(pm, pcost, k=k, tau=tau, lam=0.6, upsilon=1.0, sigma=SIGMA,
                 seed=3, device="cpu")
    eps = _states(6, (k, tau, 2), 2) @ SIGMA.T
    _inject_single(monkeypatch, jctrl, eps)
    reqs = [{"op": "set_waypoints", "waypoints": wps},
            {"op": "next", "state": [0.1, 0.0, 0.0, 0.0]},
            {"op": "advance_waypoints", "state": [0.2, 0.0, 0.0, 0.0],
             "radius": 0.25},
            {"op": "advance_waypoints", "state": wps[0], "radius": 0.25},
            {"op": "next", "state": wps[0], "m": 4},
            {"op": "advance_waypoints", "state": wps[1], "radius": 0.25},
            {"op": "advance_waypoints", "state": wps[2], "radius": 0.25},
            {"op": "next", "state": wps[2]},
            {"op": "set_waypoints", "waypoints": wps[:1], "vehicle": 0},
            {"op": "set_waypoints"},
            {"op": "next", "state": wps[1]}]
    replies = _transcript(jctrl, pctrl, reqs)
    assert [replies[i][1]["remaining"] for i in (2, 3, 5, 6)] == [3, 2, 1, 1]
    assert pctrl.waypoints_remaining() == jctrl.waypoints_remaining() == 1


def test_transcript_dmd_save(monkeypatch):
    """save() streams transitions into DMDMPPI in both servers; the refits
    identify the same (A, B) and the replans after them agree."""
    k, tau = 64, 8
    jm, jcost = _jfamily()
    jctrl = JDMDMPPI(JDMDModel(4, 2, reg=1e-10, dtype=jnp.float64), jcost,
                     k=k, tau=tau, lam=0.6, upsilon=1.0, sigma=SIGMA, seed=2,
                     refit_every=4, min_samples=6)
    plant, pcost = _family()
    pctrl = DMDMPPI(DMDModel(4, 2, reg=1e-10, dtype=F64), pcost, k=k,
                    tau=tau, lam=0.6, upsilon=1.0, sigma=SIGMA, seed=2,
                    refit_every=4, min_samples=6, device="cpu")
    eps = _states(6, (k, tau, 2), 3) @ SIGMA.T
    _inject_single(monkeypatch, jctrl, eps)
    step, rng = _step(plant), np.random.default_rng(4)
    reqs, x = [{"op": "next", "state": [0.0] * 4}], np.zeros(4)
    for _ in range(12):
        u = rng.uniform(-1, 1, 2)
        xn = step(x, u)
        reqs.append({"op": "save", "x": x.tolist(), "u": u.tolist(),
                     "x_next": xn.tolist()})
        x = xn
    reqs += [{"op": "next", "state": x.tolist()},
             {"op": "next", "state": x.tolist(), "m": 3},
             {"op": "next", "state": [0.0] * 4}]
    _transcript(jctrl, pctrl, reqs)
    assert pctrl.n_fits == jctrl.n_fits >= 2
    np.testing.assert_allclose(pctrl.model_params["A"].numpy(),
                               np.asarray(jctrl.model_params["A"]),
                               rtol=0, atol=1e-9)


def test_transcript_fleet(monkeypatch):
    """The fleet: whole-fleet next and m-step next, coalesced vehicle
    requests (one client: a batch of one each), set_goal for the fleet, a
    vehicle and all, info, bad vehicle indices."""
    n, k, tau = 3, 48, 6
    goals = np.array([[1.0, 0.0, -0.5, 0.0], [-0.8, 0.0, 0.3, 0.0],
                      [0.2, 0.0, 1.1, 0.0]])
    jm, jcost = _jfamily()
    jfleet = JFleetMPPI(jm, jcost, n_vehicles=n, k=k, tau=tau, lam=0.6,
                        upsilon=1.0, sigma=SIGMA, goals=goals, seed=2,
                        kernel="xla")
    pm, pcost = _family()
    pfleet = FleetMPPI(pm, pcost, n_vehicles=n, k=k, tau=tau, lam=0.6,
                       upsilon=1.0, sigma=SIGMA, goals=goals, seed=2,
                       device="cpu")
    eps = _states(10 * n, (k, tau, 2), 5).reshape(10, n, k, tau, 2) @ SIGMA.T
    _inject_fleet(monkeypatch, jfleet, eps)
    xs = _states(10, (n, 4), 6).tolist()
    reqs = [{"op": "info"},
            {"op": "next", "state": xs[0]},
            {"op": "next", "state": xs[1], "m": 3},
            {"op": "next", "state": xs[2][1], "vehicle": 1},
            {"op": "next", "state": xs[2][0], "vehicle": 0, "m": 4},
            {"op": "set_goal", "goal": [0.7, 0.0, -0.7, 0.0]},
            {"op": "next", "state": xs[3]},
            {"op": "set_goal", "goal": [0.1, 0.0, 0.1, 0.0], "vehicle": 2},
            {"op": "set_goal", "goal": goals[::-1].tolist()},
            {"op": "next", "state": xs[4][2], "vehicle": 2, "m": tau + 1},
            {"op": "next", "state": xs[4][0], "vehicle": 7},
            {"op": "next", "state": xs[5], "m": 0},
            {"op": "next", "state": xs[6]}]
    replies = _transcript(jfleet, pfleet, reqs)
    assert replies[0][1]["n_vehicles"] == n
    assert [rp.get("batched") for _, rp in replies[3:5]] == [1, 1]
    assert pfleet._steps == jfleet._steps == 7
    np.testing.assert_allclose(pfleet.useq.numpy(), np.asarray(jfleet._useq),
                               rtol=0, atol=TOL)


# ---- the deviations by design ----------------------------------------------------

def test_mstep_advances_the_stored_plan_by_m(monkeypatch):
    """After an m-step reply the stored plan is U'[m:] padded with the
    init action, U' the updated plan of that solve (JAX: U'[1:] padded);
    the reply itself is U'[:m], as JAX's; m = tau + 2 is an error reply
    (JAX returns tau + 1 actions) and leaves the controller untouched."""
    k, tau, m = 64, 8, 3
    model, cost = _family()
    ctrl = MPPI(model, cost, k=k, tau=tau, lam=0.6, upsilon=1.0, sigma=SIGMA,
                seed=2, device="cpu")
    twin = MPPI(model, cost, k=k, tau=tau, lam=0.6, upsilon=1.0,
                sigma=SIGMA, seed=2, device="cpu")
    eps = torch.as_tensor(_states(1, (k, tau, 2), 7)[0] @ SIGMA.T)
    x = torch.as_tensor([0.3, 0.0, -0.2, 0.1], dtype=F64)
    _a, _shifted, info = twin._solve_with_noise(eps, x, twin.useq)
    u_new = info["useq"].numpy()                       # U' of the solve
    draws = iter([eps])
    monkeypatch.setattr(noise_ops, "sample_noise",
                        lambda *a, **kw: next(draws))
    with _serving(ctrl) as client:
        plan = client.next_plan(x.numpy(), m=m)
        np.testing.assert_allclose(plan, u_new[:m], rtol=0, atol=1e-15)
        np.testing.assert_allclose(ctrl.useq.numpy(),
                                   np.vstack([u_new[m:],
                                              np.zeros((m, 2))]),
                                   rtol=0, atol=1e-15)
        before = ctrl.useq.clone()
        resp = client.request(op="next", state=[0.0] * 4, m=tau + 2)
        assert "error" in resp and "tau + 1" in resp["error"]
        assert torch.equal(ctrl.useq, before) and ctrl._steps == 1


def test_mstep_vehicle_request_shifts_that_row_alone(monkeypatch):
    """A coalesced m-step request shifts that vehicle's stored row m - 1
    further steps; the other rows keep the one-step shift."""
    fleet, server, release = _held_fleet_server(monkeypatch, n=3)
    release.set()
    host, port = server.serve_background()
    try:
        c = ControlClient(host, port)
        try:
            c.next(np.zeros((3, 4)))
            before = fleet.useq.clone()
            plan = c.next_plan([0.1] * 4, m=4, vehicle=1)
        finally:
            c.close()
        after = fleet.useq
        info = fleet._last_info["useq"]                 # U' of each row
        np.testing.assert_allclose(plan, info[1, :4].numpy(), rtol=0,
                                   atol=0)
        np.testing.assert_array_equal(after[1].numpy(), np.vstack(
            [info[1, 4:].numpy(), np.zeros((4, 2))]))
        for v in (0, 2):
            np.testing.assert_array_equal(after[v].numpy(), np.vstack(
                [info[v, 1:].numpy(), np.zeros((1, 2))]))
        assert not torch.equal(before, after)
    finally:
        server.close()


def test_info_kernel_is_the_ports_kernel_path():
    """info has JAX's keys; its kernel value is the port's kernel_path
    ("torch" here; "cuda" on the kernels) where JAX says "xla" /
    "pallas"."""
    jm, jcost = _jfamily()
    pm, pcost = _family()
    jctrl = JMPPI(jm, jcost, k=32, tau=4, lam=0.6, upsilon=1.0,
                  sigma=SIGMA)
    pctrl = MPPI(pm, pcost, k=32, tau=4, lam=0.6, upsilon=1.0, sigma=SIGMA,
                 device="cpu")
    with _serving(jctrl, jserve) as jc, _serving(pctrl) as pc:
        rj, rp = jc.info(), pc.info()
    assert set(rj) == set(rp)
    assert (rj.pop("kernel"), rp.pop("kernel")) == ("xla", "torch")
    assert rj == rp


def test_jax_client_drives_the_ports_server(served):
    """The protocol is shared: JAX's client against the port's server."""
    _model, ctrl, _client = served
    server = ControlServer(ctrl)
    host, port = server.serve_background()
    jc = jserve.ControlClient(host, port)
    try:
        assert jc.next(np.zeros(4)).shape == (2,)
        assert jc.next_plan(np.zeros(4), m=3).shape == (3, 2)
        assert jc.info()["kernel"] == "torch"
    finally:
        jc.close()
        server.close()


# ---- the entry point ---------------------------------------------------------------

def test_main_cpu_builds_and_announces(tmp_path):
    """``python -m mppi_tf_tpu_torch.serve --cpu`` builds the configured
    controller, prints its address and serves it."""
    from mppi_tf_tpu_torch.cfg import config

    env = config.write_config(dict(config.default_config("envs/point_mass"),
                                   samples=64, horizon=8),
                              str(tmp_path / "env.yaml"))
    cmd = [sys.executable, "-m", "mppi_tf_tpu_torch.serve", "--cpu",
           "--config", env, "--task", "tasks/static_cost", "--model",
           "models/point_mass_model", "--port", "0"]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        line = json.loads(proc.stdout.readline())
        assert set(line) == {"serving", "controller"}
        assert line["controller"] == "MPPI"
        host, port = line["serving"].rsplit(":", 1)
        client = ControlClient(host, int(port))
        try:
            assert client.info()["kernel"] == "torch"
            assert client.next(np.zeros(6)).shape == (3,)
        finally:
            client.close()
    finally:
        proc.kill()
        proc.communicate(timeout=30)


def test_main_without_gpu_raises():
    """Without --cpu the server wants the card and says so."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="--cpu"):
        serve.main(["--config", "envs/point_mass", "--task",
                    "tasks/static_cost", "--model",
                    "models/point_mass_model"])
