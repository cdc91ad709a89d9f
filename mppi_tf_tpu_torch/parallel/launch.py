"""Multi-process launch glue: one controller, K sharded across processes.

Counterpart of ``mppi_tf_tpu/parallel/launch.py``. Every process runs the
same program: ``initialize()`` joins the processes into one
``torch.distributed`` group, ``global_mesh()`` builds a mesh with one
shard a rank (or ``devices`` shards a rank), and the sharded solves of
``parallel/sharded.py`` and ``parallel/fused.py`` run with their
collectives over that group.

The backend is NCCL when every rank of this host has a GPU of its own
(``torch.cuda.device_count()`` at least the host's ranks), and gloo
otherwise: on the CPU, and for ranks that share a card (NCCL refuses two
ranks on one GPU). gloo reduces CUDA tensors through host memory. A
``backend=`` argument forces either.

Typical launch (the same command on every worker, with ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` in the environment,
as ``torchrun`` sets them)::

    python -m my_experiment   # calls initialize() first thing
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence, Tuple

import torch

#: the environment that marks a launched cluster (torchrun, a scheduler)
CLUSTER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def _local_ranks(num_processes: Optional[int]) -> int:
    """The ranks on this host: LOCAL_WORLD_SIZE when the launcher set it,
    else every rank (one host)."""
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local is not None:
        return int(local)
    if num_processes is not None:
        return int(num_processes)
    return int(os.environ.get("WORLD_SIZE", "1"))


def _local_rank(process_id: Optional[int]) -> int:
    local = os.environ.get("LOCAL_RANK")
    if local is not None:
        return int(local)
    if process_id is not None:
        return int(process_id)
    return int(os.environ.get("RANK", "0"))


def default_backend(num_processes: Optional[int] = None) -> str:
    """"nccl" when every rank of this host has a GPU of its own, else
    "gloo"."""
    if (torch.cuda.is_available()
            and torch.cuda.device_count() >= _local_ranks(num_processes)):
        return "nccl"
    return "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Join the process group (idempotent).

    With no arguments and no cluster environment (``CLUSTER_ENV``) it is a
    no-op: safe to call unconditionally at program start. With the
    environment set it joins over ``env://`` and re-raises a failure, so
    that a real cluster never degrades silently into single-process runs
    (JAX launch.py:49-67). ``coordinator_address`` is ``host:port`` (a
    TCP rendezvous), or an ``init_method`` URL such as
    ``file:///path/store`` (a file store, what the local cluster uses).
    For NCCL the rank's GPU becomes the current device first.
    """
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if coordinator_address is None and num_processes is None:
        if not any(os.environ.get(v) for v in CLUSTER_ENV):
            logging.getLogger(__name__).info(
                "no cluster environment, running single-process")
            return
        init_method, world, rank = "env://", None, None
    else:
        init_method = coordinator_address or "env://"
        if "://" not in init_method:
            init_method = f"tcp://{init_method}"
        world, rank = num_processes, process_id
    backend = backend or default_backend(world)
    if backend == "nccl":
        torch.cuda.set_device(_local_rank(rank) % torch.cuda.device_count())
    kw = {} if world is None else {"world_size": int(world),
                                   "rank": int(rank)}
    dist.init_process_group(backend=backend, init_method=init_method, **kw)


def rank_device() -> torch.device:
    """The device of this rank's shards: the current GPU for NCCL, and
    for gloo the one card the ranks share. Raises ``RuntimeError``
    without a GPU: a mesh of CPU shards is asked for by name
    (``global_mesh(devices=["cpu"] * n)``)."""
    import torch.distributed as dist

    if not torch.cuda.is_available():
        raise RuntimeError(
            "no GPU is present; pass devices=['cpu'] * n for a mesh of "
            "CPU shards")
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cuda")


def global_mesh(axis_names: Sequence[str] = ("k",),
                axis_shape: Optional[Tuple[int, ...]] = None,
                devices=None):
    """A mesh over every rank of the group, ``devices`` a rank (default:
    one shard on ``rank_device()``, which raises without a GPU); without
    a group, over this process's ``devices``. ``axis_shape`` factors the
    global shards, e.g. (("dp", "tp"), (4, 2)); raises ``ValueError``
    when it does not match their number."""
    import torch.distributed as dist

    from .mesh import Mesh

    devices = [rank_device()] if devices is None else list(devices)
    group = dist.group.WORLD if dist.is_initialized() else None
    return Mesh(devices, axis_names, axis_shape, group=group)


def process_info(mesh=None) -> dict:
    """Host-level topology facts for logging and debugging; with a
    ``mesh``, also its shards: ``local_devices`` (this process's) and
    ``global_devices`` (every rank's)."""
    import torch.distributed as dist

    init = dist.is_initialized()
    info = {
        "process_index": dist.get_rank() if init else 0,
        "process_count": dist.get_world_size() if init else 1,
        "backend": dist.get_backend() if init else None,
    }
    if mesh is not None:
        info.update(local_devices=mesh.n_local, global_devices=mesh.size)
    return info
