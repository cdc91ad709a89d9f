"""Control serving: a controller (or fleet) behind a TCP endpoint.

The port of the JAX package's ``serve.py``. The reference's live consumer
was an external ROS node calling the controller each tick (TODO.md:109-156
"ROS Integration"); this module is that deployment surface without the ROS
dependency: newline-delimited JSON over TCP exposing the controller API,
so any stack (a ROS bridge included) drives the controller remotely. The
protocol is the JAX package's op for op and key for key, so a client of
one package works against the other's server:

    {"op": "next", "state": [...]}            -> {"action": [...], "solve_ms": t}
    {"op": "next", "state": [...], "m": 5}    -> {"action": [...],
                                                 "actions": [[...] x m], ...}
    {"op": "set_goal", "goal": [...]}         -> {"ok": true}
    {"op": "save", "x": [...], "u": [...],
     "x_next": [...]}                         -> {"ok": true}
    {"op": "info"}                            -> {"controller": ..., "model":
                                                 ..., "k": ..., "tau": ...,
                                                 "kernel": ...,
                                                 "n_vehicles": ...}
    {"op": "set_waypoints",
     "waypoints": [[...], ...]}               -> {"ok": true}
    {"op": "advance_waypoints",
     "state": [...], "radius": r}             -> {"advanced": n,
                                                 "remaining": ...}
    {"op": "ping"}                            -> {"ok": true}
    anything else                             -> {"error": "..."}

A FleetMPPI serves the same way: "state" is [n, sDim], "action" comes back
[n, aDim], "set_goal" takes [n, goal_dim] (or one goal for the fleet, or a
"vehicle" index), "set_waypoints" takes a "vehicle" index. Concurrent
per-vehicle ``{"op": "next", "vehicle": i, "state": [...]}`` requests
coalesce: a dispatcher thread drains every pending request and replans the
whole fleet in one ``FleetMPPI.next`` (on the kernel route one launch of
each kernel over all vehicles), then wakes each client with its own row.
Vehicles with no fresh request are replanned from their last known state.

Requests serialise through one lock: a controller is stateful (its nominal
sequence, its noise stream). The handler threads and the dispatcher call
the controller, whose solves run with grad mode off and launch their
kernels on the controller's device; the server moves nothing between
devices and never sets the current device.

Two deviations from the JAX server, by design:

- **m-step replies advance the plan by m.** The reply to an m-step
  request is the first m actions of the updated plan U' (the action, then
  the head of the shifted sequence), as in JAX; the client applies them
  open loop and replans m ticks later. The JAX server shifts the stored
  plan by one step only, so its next replan warm-starts from a plan m - 1
  ticks stale. Here the stored plan is shifted m - 1 further steps (to
  U'[m:] padded with the init action) under the lock; for a coalesced
  fleet request, that vehicle's row alone. An ``m`` above tau + 1, for
  which JAX silently returns fewer than m actions, is an error reply.
- **``info``'s ``kernel`` is the port's ``kernel_path``** ("cuda" or
  "torch"), where the JAX server says "pallas" or "xla".
"""

from __future__ import annotations

import json
import queue
import socket
import socketserver
import threading
import time
from typing import Optional

import numpy as np
import torch

from .ops import update as upd


def _advance_plan(ctrl, steps: int, vehicle: Optional[int] = None) -> None:
    """Shift the controller's stored plan ``steps`` more steps, appending
    the init action (zeros, as ``MPPI._postprocess`` does): the plan an
    m-step reply leaves is U'[m:] padded. ``vehicle``: that row of a
    fleet's [n, tau, aDim] plan alone."""
    if steps < 1:
        return
    useq = ctrl._useq
    init = torch.zeros(steps, useq.shape[-1], dtype=useq.dtype,
                       device=useq.device)
    if vehicle is None:
        ctrl._useq = upd.shift(useq, init, steps)
    else:   # out of place: a host copy of the plans may share its memory
        rows = useq.clone()
        rows[vehicle] = upd.shift(useq[vehicle], init, steps)
        ctrl._useq = rows


def _plan_head(action: np.ndarray, useq: np.ndarray, m: int) -> np.ndarray:
    """The first m actions of the updated plan: the action, then the head
    of the shifted sequence ([m, aDim], or [n, m, aDim] for a fleet)."""
    if useq.ndim == 3:
        return np.concatenate([action[:, None], useq[:, :m - 1]], axis=1)
    return np.vstack([action[None], useq[:m - 1]])


class _FleetCoalescer:
    """Batch concurrent per-vehicle ``next`` requests into ONE fleet
    dispatch. A dispatcher thread drains every queued request, overwrites
    the cached per-vehicle states (f64 numpy, as JAX keeps them; the
    fleet's ``next`` casts them to its device) with the fresh ones,
    replans the whole fleet once under the server lock, and wakes each
    waiting client with its own row. Requests arriving during a solve
    batch into the next one."""

    def __init__(self, fleet, lock):
        self._fleet = fleet
        self._lock = lock
        n, sdim = fleet.n_vehicles, fleet._sdim
        self._states = np.zeros((n, sdim))
        if sdim >= 7:
            self._states[:, 6] = 1.0  # unit quaternion for AUV states
        self._q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, vehicle: int, state, m: int) -> dict:
        """Blocking: enqueue one vehicle's request, wait for its row."""
        v = int(vehicle)
        if not 0 <= v < self._fleet.n_vehicles:
            return {"error": f"vehicle {v} out of range "
                             f"[0, {self._fleet.n_vehicles})"}
        # checked here, for this request alone: numpy would broadcast a
        # one-element state over the vehicle's row, and a short one would
        # fail the whole batch's dispatch
        state = np.asarray(state, np.float64)
        if state.shape != (self._fleet._sdim,):
            return {"error": f"vehicle {v} state must have shape "
                             f"({self._fleet._sdim},), got "
                             f"{list(state.shape)}"}
        box: dict = {}
        ev = threading.Event()
        self._q.put((v, state, m, box, ev))
        if not ev.wait(timeout=600.0):
            return {"error": "fleet dispatch timed out"}
        return box["resp"]

    def close(self):
        self._q.put(None)
        self._thread.join(timeout=5)

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            batch = [item]
            stop = False
            while True:  # drain everything already queued
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    stop = True
                    break
                batch.append(nxt)
            try:
                self._dispatch(batch)
            except Exception as e:  # wake every waiter with the error
                for _v, _s, _m, box, _ev in batch:
                    box["resp"] = {"error": f"{type(e).__name__}: {e}"}
            finally:
                for _v, _s, _m, _box, ev in batch:
                    ev.set()
            if stop:
                return

    def _dispatch(self, batch) -> None:
        """One whole-fleet replan for ``batch``; fills each request's box."""
        for v, s, _m, _box, _ev in batch:
            self._states[v] = s
        shifts = {v: m - 1 for v, _s, m, _box, _ev in batch if m > 1}
        with self._lock:
            t0 = time.perf_counter()
            actions = self._fleet.next(self._states)
            ms = (time.perf_counter() - t0) * 1e3
            # one copy of the plans to the host a dispatch, where a
            # request asks for more than its action
            useq = self._fleet.useq.cpu().numpy() if shifts else None
            for v, steps in shifts.items():
                _advance_plan(self._fleet, steps, vehicle=v)
        for v, _s, m, box, _ev in batch:
            resp = {"action": actions[v].tolist(), "solve_ms": round(ms, 3),
                    "batched": len(batch)}
            if m > 1:
                resp["actions"] = _plan_head(actions[v], useq[v],
                                             m).tolist()
            box["resp"] = resp


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        server: ControlServer = self.server  # type: ignore[assignment]
        for raw in self.rfile:
            raw = raw.strip()
            if not raw:
                continue
            try:
                resp = server._dispatch(json.loads(raw.decode()))
            except Exception as e:  # a bad request must not kill serving
                resp = {"error": f"{type(e).__name__}: {e}"}
            self.wfile.write((json.dumps(resp) + "\n").encode())
            self.wfile.flush()


class ControlServer(socketserver.ThreadingTCPServer):
    """Serve one controller (MPPI / sharded / DMD / FleetMPPI) over TCP.

    ``serve_background()`` starts the accept loop in a daemon thread and
    returns (host, port); port 0 picks a free one. Requests serialise
    through a lock; connections are handled concurrently, so N vehicle
    stacks can hold sockets open. The controller stays on its device.
    """

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, controller, host: str = "127.0.0.1", port: int = 0):
        super().__init__((host, port), _Handler)
        self._ctrl = controller
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._started = False
        # fleet controllers get the request coalescer: per-vehicle `next`
        # requests batch into one whole-fleet dispatch
        self._coalescer: Optional[_FleetCoalescer] = None
        if hasattr(controller, "set_goals"):
            self._coalescer = _FleetCoalescer(controller, self._lock)

    # -- protocol ---------------------------------------------------------
    def _dispatch(self, req: dict) -> dict:
        op = req.get("op")
        if op == "ping":
            return {"ok": True}
        c = self._ctrl
        tpl = getattr(c, "_tpl", c)  # FleetMPPI wraps a template MPPI
        if op == "info":
            return {
                "controller": type(c).__name__,
                "model": type(getattr(tpl, "_model", None)).__name__,
                "k": getattr(tpl, "_k", None),
                "tau": getattr(tpl, "_tau", None),
                "kernel": getattr(tpl, "kernel_path", None),
                "n_vehicles": getattr(c, "n_vehicles", 1),
            }
        if op == "next":
            state = np.asarray(req["state"], np.float64)
            m = int(req.get("m", 1))
            if m < 1:
                return {"error": f"m must be >= 1, got {m}"}
            if m > tpl._tau + 1:
                return {"error": f"m must be <= tau + 1 = {tpl._tau + 1} "
                                 f"(the updated plan's length), got {m}"}
            if "vehicle" in req:
                # per-vehicle fleet request: coalesce into one dispatch
                if self._coalescer is None:
                    return {"error": "'vehicle' next requests need a "
                                     "served FleetMPPI"}
                return self._coalescer.submit(int(req["vehicle"]), state,
                                              m)
            with self._lock:
                t0 = time.perf_counter()
                action = np.asarray(c.next(state))
                ms = (time.perf_counter() - t0) * 1e3
                resp = {"action": action.tolist(), "solve_ms": round(ms, 3)}
                if m > 1:
                    resp["actions"] = _plan_head(
                        action, c.useq.cpu().numpy(), m).tolist()
                    _advance_plan(c, m - 1)
            return resp
        if op == "set_goal":
            goal = np.asarray(req["goal"], np.float64)
            with self._lock:
                if hasattr(c, "set_goals"):  # fleet controller
                    if "vehicle" in req:  # re-task ONE vehicle
                        c.set_vehicle_goal(int(req["vehicle"]), goal)
                    elif goal.ndim == 1:  # same goal for the whole fleet
                        c.set_goals(np.tile(goal, (c.n_vehicles, 1)))
                    else:
                        c.set_goals(goal)
                elif "vehicle" in req:
                    # a client that believes it re-tasks vehicle k of a
                    # fleet must not replace the single controller's goal
                    return {"error": "'vehicle' index given but the "
                                     "served controller is not a fleet"}
                else:
                    c.set_goal(goal)
            return {"ok": True}
        if op == "set_waypoints":
            wps = req["waypoints"]
            with self._lock:
                if hasattr(c, "set_vehicle_waypoints"):  # fleet
                    if "vehicle" not in req:
                        return {"error": "fleet set_waypoints needs a "
                                         "'vehicle' index (per-vehicle "
                                         "missions)"}
                    c.set_vehicle_waypoints(int(req["vehicle"]), wps)
                elif "vehicle" in req:
                    # nor a single controller's whole mission
                    return {"error": "'vehicle' index given but the "
                                     "served controller is not a fleet"}
                else:
                    c.set_waypoints(wps)
            return {"ok": True}
        if op == "advance_waypoints":
            state = np.asarray(req["state"], np.float64)
            radius = float(req["radius"])
            with self._lock:
                adv = c.advance_waypoints(state, radius)
                rem = c.waypoints_remaining()
            return {"advanced": int(adv),
                    "remaining": np.asarray(rem).tolist()}
        if op == "save":
            if not hasattr(c, "save"):
                return {"error": f"{type(c).__name__} has no save() (not "
                                 "an adaptive/observed controller)"}
            with self._lock:
                c.save(np.asarray(req["x"], np.float64),
                       np.asarray(req["u"], np.float64),
                       np.asarray(req["x_next"], np.float64))
            return {"ok": True}
        return {"error": f"unknown op {op!r}; valid: next, set_goal, "
                         "set_waypoints, advance_waypoints, save, info, "
                         "ping"}

    # -- lifecycle --------------------------------------------------------
    def serve_forever(self, *args, **kwargs):
        self._started = True
        return super().serve_forever(*args, **kwargs)

    def serve_background(self):
        """Start accepting in a daemon thread; returns (host, port)."""
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True)
        # before start(): close() must never see a started thread without
        # the flag (shutdown would deadlock)
        self._started = True
        self._thread.start()
        return self.server_address

    def close(self):
        # shutdown() waits on an Event only serve_forever() sets: calling
        # it before the accept loop started would deadlock
        if self._started:
            self.shutdown()
        self.server_close()
        if self._coalescer is not None:
            self._coalescer.close()
        if self._thread is not None:
            self._thread.join(timeout=5)


class ControlClient:
    """Blocking JSON-lines client for :class:`ControlServer` (either
    package's): the shape a ROS bridge (or any vehicle stack) takes."""

    def __init__(self, host: str, port: int, timeout: float = 120.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._file = self._sock.makefile("rwb")

    def request(self, **req) -> dict:
        self._file.write((json.dumps(req) + "\n").encode())
        self._file.flush()
        line = self._file.readline()
        if not line:
            raise ConnectionError("server closed the connection")
        return json.loads(line.decode())

    def _checked(self, **req) -> dict:
        resp = self.request(**req)
        if "error" in resp:
            raise RuntimeError(resp["error"])
        return resp

    def next(self, state, vehicle: Optional[int] = None) -> np.ndarray:
        req = {"op": "next",
               "state": np.asarray(state, np.float64).tolist()}
        if vehicle is not None:  # fleet server: coalesced per-vehicle row
            req["vehicle"] = int(vehicle)
        return np.asarray(self._checked(**req)["action"])

    def next_plan(self, state, m: int,
                  vehicle: Optional[int] = None) -> np.ndarray:
        """m-step reply: the first ``m`` actions of the updated plan
        ([m, aDim]); apply them open loop and replan m ticks later."""
        req = {"op": "next", "m": int(m),
               "state": np.asarray(state, np.float64).tolist()}
        if vehicle is not None:
            req["vehicle"] = int(vehicle)
        resp = self._checked(**req)
        return np.asarray(resp.get("actions", [resp["action"]]))

    def set_goal(self, goal) -> None:
        self._checked(op="set_goal",
                      goal=np.asarray(goal, np.float64).tolist())

    def save(self, x, u, x_next) -> None:
        self._checked(op="save", x=np.asarray(x, np.float64).tolist(),
                      u=np.asarray(u, np.float64).tolist(),
                      x_next=np.asarray(x_next, np.float64).tolist())

    def set_waypoints(self, waypoints, vehicle: Optional[int] = None):
        req = {"op": "set_waypoints",
               "waypoints": [np.asarray(w, np.float64).tolist()
                             for w in waypoints]}
        if vehicle is not None:
            req["vehicle"] = int(vehicle)
        self._checked(**req)

    def advance_waypoints(self, state, radius: float) -> dict:
        return self._checked(op="advance_waypoints",
                             state=np.asarray(state, np.float64).tolist(),
                             radius=float(radius))

    def info(self) -> dict:
        return self.request(op="info")

    def close(self):
        try:
            self._file.close()
        finally:
            self._sock.close()


def main(argv=None):
    """``python -m mppi_tf_tpu_torch.serve``: build the configured
    controller on the card (``--cpu``: on the CPU) and serve it."""
    import argparse

    from .cfg import load_config
    from .controller import get_controller
    from .envs.runner import build_model_and_cost

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True, help="env config (YAML/name)")
    p.add_argument("--task", required=True, help="task config")
    p.add_argument("--model", required=True, help="model config")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7117)
    p.add_argument("--cpu", action="store_true",
                   help="serve from the CPU instead of the card")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serve: no GPU is present; pass --cpu to serve "
                           "from the CPU")

    env_cfg = load_config(args.config)
    task_cfg = load_config(args.task)
    model_cfg = load_config(args.model)
    model, cost, _sigma = build_model_and_cost(env_cfg, task_cfg, model_cfg,
                                               device=device)
    ctrl = get_controller(model, cost, env_cfg, device=device)
    server = ControlServer(ctrl, host=args.host, port=args.port)
    host, port = server.server_address
    print(json.dumps({"serving": f"{host}:{port}",
                      "controller": type(ctrl).__name__}), flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.close()


if __name__ == "__main__":
    main()
