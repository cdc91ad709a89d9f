"""The port's CUDA graphs: when one goes stale, how one is captured, and
how its replays are counted.

Two callers capture graphs: the on-device loop (``envs/mjx_env.py``: a
control period, and the DMD refit captured into its pool) and the fleet's
step (``controller/fleet.py`` ``_StepGraph``). Both test ``freeze_key``
before a replay and capture again where it moved, capture through
``capture`` and count the launches of their replays with
``add_replays``, so that ``kernels/_launch.py``'s and
``kernels/plant.py``'s ``launch_counts`` hold what ran on the card,
graphed or not.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional

import torch

from .. import tracing
from ..kernels import _launch, plant

#: the CUDA graph node types (CUgraphNodeType, cudaGraphNodeType) that
#: ``graph_node_kinds`` names; every other type counts as "other"
_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset"}


def freeze_key(ctrl, cost_tensors) -> tuple:
    """What a CUDA graph of ``ctrl``'s fused solve froze: the solve object
    and its constants (by-value kernel arguments), the schedule tensor,
    the seed and flags, the addresses of the model's parameters and
    buffers and of ``cost_tensors`` (the cost params the graph reads), and
    the key of a model's cached derived values (``AUVModel.mats_key``).
    Ints and addresses only, cheap enough to test before every replay: a
    graph is captured again when it changes, while parameters written in
    place are read live."""
    model, fused = ctrl._model, ctrl._fused
    mats_key = getattr(model, "mats_key", None)
    return (id(fused), id(fused.consts),
            None if fused.sched is None else fused.sched.data_ptr(),
            ctrl._base_seed, ctrl._normalize_cost, ctrl._log,
            ctrl._clip_actions, id(ctrl._S), _addresses(model),
            tuple(t.data_ptr() for t in cost_tensors),
            None if mats_key is None else mats_key())


def _addresses(module) -> tuple:
    """The addresses of every parameter and buffer of ``module`` and its
    submodules, read from the modules' own dicts (a fraction of the cost
    of ``named_parameters``)."""
    out, stack = [], [module]
    while stack:
        mod = stack.pop()
        for tensors in (mod._parameters, mod._buffers):
            out += [t.data_ptr() for t in tensors.values() if t is not None]
        stack += [m for m in mod._modules.values() if m is not None]
    return tuple(out)


def graph_node_kinds(graph) -> dict:
    """The nodes of a captured ``CUDAGraph(keep_graph=True)``, by kind:
    {kernel, memcpy, memset, other: count}, read from the graph itself
    through ``libcuda`` (``cuGraphGetNodes``, ``cuGraphNodeGetType``: what
    the runtime's ``cudaGraphGetNodes`` and ``cudaGraphNodeGetType`` call
    on the same handle)."""
    drv = ctypes.CDLL("libcuda.so.1")

    def check(rc: int) -> None:
        if rc != 0:
            raise RuntimeError(f"reading a CUDA graph's nodes: CUresult {rc}")

    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(drv.cuGraphGetNodes(raw, None, ctypes.byref(n)))
    nodes = (ctypes.c_void_p * n.value)()
    check(drv.cuGraphGetNodes(raw, nodes, ctypes.byref(n)))
    out = dict.fromkeys(("kernel", "memcpy", "memset", "other"), 0)
    kind = ctypes.c_int(0)
    for node in nodes:
        check(drv.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(kind)))
        out[_NODE_KINDS.get(kind.value, "other")] += 1
    return out


class Capture(NamedTuple):
    """What ``capture`` returns: the warm-up's result (``warm``) and the
    captured call's (``out``, the graph's static outputs), the graph and
    the second body's (None without one), the solve's and the plant's
    kernel launches the capture recorded ({entry point: nodes}), the
    graph's nodes by kind and the capture's seconds."""
    warm: object
    out: object
    graph: torch.cuda.CUDAGraph
    second: Optional[torch.cuda.CUDAGraph]
    nodes: dict
    plant_nodes: dict
    graph_nodes: dict
    capture_s: float


def _recorded(counts: dict, before: dict) -> dict:
    return {name: c - before[name] for name, c in counts.items()
            if c > before[name]}


def capture(span: str, device, body: Callable,
            second: Optional[Callable] = None) -> Capture:
    """``body`` (then ``second``) warmed up on a side stream of ``device``,
    then each captured as a graph, ``second``'s in ``body``'s pool, timed
    by the span ``span`` (``capture_s``, whether or not tracing is on).
    The warm-up computes one call of the bodies and a replay writes the
    same buffers, so a caller loads its inputs again after a capture.
    ``body``'s graph is kept, so that its nodes are read
    (``graph_node_kinds``), and instantiated here, not at its first
    replay; the capture ends in one sync of the device's stream."""
    with tracing.timed(span) as timed, torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            warm = body()
            if second is not None:
                second()
        torch.cuda.current_stream().wait_stream(side)
        before = dict(_launch.captured_counts)
        before_plant = dict(plant.captured_counts)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph):
            out = body()
        graph2 = None
        if second is not None:
            graph2 = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph2, pool=graph.pool()):
                second()
        nodes = _recorded(_launch.captured_counts, before)
        plant_nodes = _recorded(plant.captured_counts, before_plant)
        kinds = graph_node_kinds(graph)
        graph.instantiate()
        torch.cuda.current_stream().synchronize()
    return Capture(warm, out, graph, graph2, nodes, plant_nodes, kinds,
                   timed.seconds)


def add_replays(nodes: dict, plant_nodes: dict, replays: int) -> None:
    """Add the launches of ``replays`` replays of a graph whose capture
    recorded ``nodes`` and ``plant_nodes`` (``Capture``) to the solve's
    and the plant's ``launch_counts``."""
    _launch.count_replays(nodes, replays)
    _launch.count_replays(plant_nodes, replays, plant.launch_counts)
