"""The port's device mesh: the shards of the K samples axis (or of a
fleet, or a dp x tp training grid) and the collectives between them.

Counterpart of ``mppi_tf_tpu/parallel/mesh.py``. A JAX mesh names every
device of every process; a port ``Mesh`` holds

- the **shard devices this process drives**, a list of ``torch.device``
  in which a device may repeat: ``[cpu] * 8`` is the counterpart of the
  JAX tests' 8 virtual XLA devices, ``[cuda:0] * 4`` the same on one card;
- an optional ``torch.distributed`` process group whose ranks each drive
  as many shards: global shard index = rank * (local shards) + local index;
- ``axis_names`` and the global ``shape`` ({axis: size}, as JAX's).

The collectives are named after JAX's: ``pmin``, ``pmax``, ``psum`` and
``pmean`` over a list of per-shard tensors (one a local shard), each
returning the reduced tensor on the lead device (``devices[0]``). All of
them rest on one ``all_gather``: every shard's rows into one
[size, ...] tensor, by global index (across ranks a zeroed buffer in
which each rank writes its own rows, summed by ``dist.all_reduce``: a sum
with zeros is exact, and gloo reduces CUDA tensors with SUM), then the
reduction over that axis in index order. Every rank therefore gets the
same bits, and a layout of ranks and local shards gives the bits of a
local mesh of the same size.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

# the canonical mesh-axis name for the samples (K) axis
SAMPLE_AXIS = "k"


def sample_axis() -> str:
    return SAMPLE_AXIS


class Mesh:
    """Shards over local devices and, optionally, the ranks of a process
    group (module docstring). ``axis_shape`` factors the global size over
    ``axis_names`` (default: one axis of every shard, or ``_factor``)."""

    def __init__(self, devices: Sequence, axis_names: Sequence[str] = (
            SAMPLE_AXIS,), axis_shape: Optional[Sequence[int]] = None,
                 group=None):
        import torch.distributed as dist

        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one shard device")
        self.group = group
        if group is not None:
            self.rank = dist.get_rank(group)
            self.world = dist.get_world_size(group)
        else:
            self.rank, self.world = 0, 1
        self.n_local = len(self.devices)
        self.size = self.n_local * self.world
        self.axis_names = tuple(axis_names)
        if axis_shape is None:
            axis_shape = (self.size,) if len(self.axis_names) == 1 else \
                _factor(self.size, len(self.axis_names))
        axis_shape = tuple(int(s) for s in axis_shape)
        if len(axis_shape) != len(self.axis_names):
            raise ValueError(f"axis_shape {axis_shape} does not match the "
                             f"axes {self.axis_names}")
        prod = 1
        for s in axis_shape:
            prod *= s
        if prod != self.size:
            raise ValueError(f"axis_shape {axis_shape} != {self.size} "
                             "shards")
        self.shape = dict(zip(self.axis_names, axis_shape))

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices={[str(d) for d in self.devices]}"
                f", rank={self.rank}/{self.world})")

    @property
    def device(self) -> torch.device:
        """The lead device: where the collectives leave their results."""
        return self.devices[0]

    @property
    def local_indices(self) -> list:
        """The global shard index of each local shard."""
        return [self.axis_index(i) for i in range(self.n_local)]

    def axis_index(self, local: int, axis: Optional[str] = None) -> int:
        """The global index of local shard ``local`` (JAX
        ``lax.axis_index``); with ``axis``, its coordinate along that
        axis of the row-major grid ``shape``."""
        g = self.rank * self.n_local + int(local)
        if axis is None:
            return g
        names = self.axis_names
        stride = 1
        for name in names[names.index(axis) + 1:]:
            stride *= self.shape[name]
        return (g // stride) % self.shape[axis]

    def one_device(self, what: str) -> torch.device:
        """The device of every local shard; raises ``ValueError`` when
        this process's shards lie on more than one (``what`` needs them
        on one)."""
        if len(set(self.devices)) != 1:
            raise ValueError(
                f"{what} runs a process's shards on one device, got "
                f"{[str(d) for d in self.devices]}: run one process a GPU "
                "(parallel/launch.py) with its shards on that GPU")
        return self.device

    @property
    def backend(self) -> Optional[str]:
        import torch.distributed as dist

        return None if self.group is None else dist.get_backend(self.group)

    # --- collectives ------------------------------------------------------
    def all_gather(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """Every shard's tensor, stacked by global shard index: [size,
        *shape] on the lead device, the same bits on every rank."""
        if len(xs) != self.n_local:
            raise ValueError(f"{len(xs)} tensors for {self.n_local} local "
                             "shards")
        lead = self.device
        local = torch.stack([x.to(lead) for x in xs])
        if self.group is None:
            return local
        import torch.distributed as dist

        out = torch.zeros((self.size, *local.shape[1:]), dtype=local.dtype,
                          device=lead)
        start = self.rank * self.n_local
        out[start:start + self.n_local] = local
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out

    def psum(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return self.all_gather(xs).sum(dim=0)

    def pmean(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return self.psum(xs) / self.size

    def pmin(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return self.all_gather(xs).min(dim=0).values

    def pmax(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return self.all_gather(xs).max(dim=0).values


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = (SAMPLE_AXIS,),
              devices=None, group=None) -> Mesh:
    """A mesh over the first ``n_devices`` of ``devices`` (JAX
    ``make_mesh``). Without ``devices`` it takes every visible CUDA
    device and raises ``RuntimeError`` when there is none; a repeat is a
    second shard on the same device (``["cpu"] * 8``). With one axis name
    the mesh is 1-D; with several, the shards are factored over them as
    evenly as possible, largest first (``_factor``)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh(): no GPU is present; pass devices=['cpu'] * n "
                "for a mesh of CPU shards")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is None:
        n_devices = len(devices)
    if not 1 <= n_devices <= len(devices):
        raise ValueError(f"n_devices={n_devices} of {len(devices)} devices")
    return Mesh(devices[:n_devices], axis_names, group=group)


def _factor(n: int, dims: int):
    """Factor n into `dims` integers, largest first."""
    shape = [1] * dims
    remaining = n
    for i in range(dims - 1):
        f = _largest_factor_leq(remaining,
                                int(round(remaining ** (1.0 / (dims - i)))))
        shape[i] = f
        remaining //= f
    shape[-1] = remaining
    shape.sort(reverse=True)
    return tuple(shape)


def _largest_factor_leq(n: int, target: int) -> int:
    for f in range(max(target, 1), 0, -1):
        if n % f == 0:
            return f
    return 1
