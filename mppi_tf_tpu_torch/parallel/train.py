"""Mesh-sharded training step for learned dynamics models.

Counterpart of ``mppi_tf_tpu/parallel/train.py``: the learner's step (MSE
on normalized targets, Adam at optax's defaults, as ``learning.Learner``)
over a 2-D ("dp", "tp") mesh:

- the transition batch is split over "dp";
- the MLP's layers alternate column- and row-parallel over "tp" (the
  Megatron pattern JAX expresses through shardings): even layers shard
  their output features (w [in, out/tp], b [out/tp]), odd layers their
  input features (w [in/tp, out], b replicated), so the activations stay
  sharded between a pair and one psum over "tp" closes it;
- the gradients are summed over the shards that hold a copy of each
  weight ("dp", and "tp" too for a replicated bias); Adam's moments live
  with the weight pieces, so they are sharded like the weights.

Every shard keeps its own copy of its pieces. The psum of a row-parallel
layer is a ``Mesh.all_gather`` of the shards' partial products, summed in
shard order over the shard's "tp" row; across ranks the gather is a
``torch.autograd.Function`` whose backward all-reduces the gradient of
the gathered rows (the adjoint of a gather), so autograd of the sum of
the shards' losses is the gradient of the global loss. Each shard weighs
its loss by the share of its outputs it holds (1/tp where the last layer
leaves its output replicated over "tp"). A local mesh stacks the shards
and autograd sums the adjoint itself.
"""

from __future__ import annotations

import torch

from .mesh import Mesh


def mlp_param_specs(net, tp_axis: str = "tp") -> list:
    """Column / row-parallel specs of an MLP's layers, as tuples of mesh
    axes a dimension (None: not split), JAX's PartitionSpecs."""
    specs = []
    for i, _layer in enumerate(net):
        if i % 2 == 0:   # column parallel: shard the output features
            specs.append({"w": (None, tp_axis), "b": (tp_axis,)})
        else:            # row parallel: shard the input features
            specs.append({"w": (tp_axis, None), "b": ()})
    return specs


def model_param_specs(params: dict, tp_axis: str = "tp") -> dict:
    """Specs of an NN model's params (``MPPI.model_params``'s layout: the
    net and its normalisers); the normalisers are replicated."""
    specs = {name: () for name in params if name != "net"}
    specs["net"] = mlp_param_specs(params["net"], tp_axis)
    return specs


def _coord(mesh: Mesh, g: int, axis: str) -> int:
    """Global shard ``g``'s coordinate along ``axis`` of the row-major
    grid."""
    names = mesh.axis_names
    stride = 1
    for name in names[names.index(axis) + 1:]:
        stride *= mesh.shape[name]
    return (g // stride) % mesh.shape[axis]


class _Gather(torch.autograd.Function):
    """``Mesh.all_gather`` across ranks, with the adjoint: the gathered
    rows' gradients summed over the ranks, each rank keeping its own."""

    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        return mesh.all_gather(list(xs))

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        mesh = ctx.mesh
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=mesh.group)
        start = mesh.rank * mesh.n_local
        return (None, *grad[start:start + mesh.n_local].unbind(0))


def _gather(mesh: Mesh, xs: list) -> torch.Tensor:
    if mesh.group is None:
        return torch.stack(xs)
    return _Gather.apply(mesh, *xs)


class ShardedNet:
    """The local shards' pieces of an MLP (``shards[i][layer]`` = {"w",
    "b"}, leaf tensors) on a (dp, tp) mesh. ``full()`` assembles the
    whole network on every rank."""

    def __init__(self, mesh: Mesh, dp_axis: str, tp_axis: str, shards):
        self.mesh, self.dp_axis, self.tp_axis = mesh, dp_axis, tp_axis
        self.shards = shards

    def tensors(self, i: int) -> list:
        """Local shard ``i``'s pieces in layer order (w, b)."""
        return [p[a] for p in self.shards[i] for a in ("w", "b")]

    def full(self) -> list:
        """[{"w": [in, out], "b": [out]}] of the whole network, gathered
        from tp coordinate 0..tp-1 of dp row 0."""
        mesh, tp = self.mesh, self.mesh.shape[self.tp_axis]
        flat = [torch.cat([t.detach().reshape(-1) for t in self.tensors(i)])
                for i in range(mesh.n_local)]
        g = mesh.all_gather(flat)
        pieces = [[] for _ in range(tp)]
        for s in range(mesh.size):
            if _coord(mesh, s, self.dp_axis) == 0:
                pieces[_coord(mesh, s, self.tp_axis)] = g[s]
        shapes = [(p["w"].shape, p["b"].shape) for p in self.shards[0]]
        out, start = [], 0
        for i, (sw, sb) in enumerate(shapes):
            ws, bs = [], []
            for t in range(tp):
                w = pieces[t][start:start + sw.numel()].reshape(sw)
                b = pieces[t][start + sw.numel():start + sw.numel()
                              + sb.numel()].reshape(sb)
                ws.append(w)
                bs.append(b)
            if i % 2 == 0:
                out.append({"w": torch.cat(ws, dim=1),
                            "b": torch.cat(bs, dim=0)})
            else:
                out.append({"w": torch.cat(ws, dim=0), "b": bs[0]})
            start += sw.numel() + sb.numel()
        return out


def make_sharded_train_step(model, mesh: Mesh, learning_rate: float = 1e-3,
                            dp_axis: str = "dp", tp_axis: str = "tp"):
    """``(init, step_fn, place_batch)`` over ``mesh``:

    - ``init()`` -> (params, opt_state): the model's current network as
      a ``ShardedNet`` and Adam over its pieces;
    - ``place_batch(X, Y)`` -> (X, Y) split over dp, one pair a local
      shard, on the mesh's device in the model's dtype;
    - ``step_fn(params, opt_state, X, Y)`` -> (params, opt_state, loss):
      one Adam step on the global mean squared error (the pieces are
      updated in place), loss the value before the update.

    ``X``, ``Y`` are normalized training pairs
    (``model.prepare_training_data``). The hidden widths must divide by
    tp, the batch by dp."""
    if set(mesh.axis_names) != {dp_axis, tp_axis}:
        raise ValueError(f"the train step needs a ({dp_axis}, {tp_axis}) "
                         f"mesh, got axes {mesh.axis_names}")
    device = mesh.one_device("make_sharded_train_step")
    dp, tp = mesh.shape[dp_axis], mesh.shape[tp_axis]
    dtype = model.dtype
    local = [(_coord(mesh, g, dp_axis), _coord(mesh, g, tp_axis))
             for g in mesh.local_indices]
    net = model.trainable()
    n_layers = len(net)
    for i, layer in enumerate(net):
        dim = layer.w.shape[1] if i % 2 == 0 else layer.w.shape[0]
        if dim % tp != 0:
            raise ValueError(f"layer {i}'s split dimension {dim} does not "
                             f"divide by tp={tp}")
    # the last layer's output is replicated over tp when it is row
    # parallel: each of the tp copies carries 1/tp of its loss
    out_share = 1.0 / tp if (n_layers - 1) % 2 == 1 else 1.0

    def piece(i: int, layer, t: int) -> dict:
        w, b = layer.w.detach(), layer.b.detach()
        if i % 2 == 0:
            c = w.shape[1] // tp
            w, b = w[:, t * c:(t + 1) * c], b[t * c:(t + 1) * c]
        else:
            r = w.shape[0] // tp
            w = w[t * r:(t + 1) * r]
        return {name: v.to(device=device, dtype=dtype).clone()
                .requires_grad_(True) for name, v in (("w", w), ("b", b))}

    def init():
        shards = [[piece(i, layer, t) for i, layer in enumerate(net)]
                  for _, t in local]
        params = ShardedNet(mesh, dp_axis, tp_axis, shards)
        leaves = [x for i in range(mesh.n_local) for x in params.tensors(i)]
        opt = torch.optim.Adam(leaves, lr=learning_rate, betas=(0.9, 0.999),
                               eps=1e-8)
        return params, opt

    def place_batch(X, Y):
        X = torch.as_tensor(X).to(device=device, dtype=dtype)
        Y = torch.as_tensor(Y).to(device=device, dtype=dtype)
        if X.shape[0] % dp != 0:
            raise ValueError(f"batch {X.shape[0]} does not divide by dp={dp}")
        b = X.shape[0] // dp
        return ([X[d * b:(d + 1) * b] for d, _ in local],
                [Y[d * b:(d + 1) * b] for d, _ in local])

    def tp_row(g: torch.Tensor, d: int) -> torch.Tensor:
        """The sum over tp of dp row ``d``'s gathered partials, in tp
        order."""
        rows = [s for s in range(mesh.size) if _coord(mesh, s, dp_axis) == d]
        acc = g[rows[0]]
        for s in rows[1:]:
            acc = acc + g[s]
        return acc

    def forward(params, X):
        hs = list(X)
        for i in range(n_layers):
            last = i == n_layers - 1
            layers = [params.shards[j][i] for j in range(mesh.n_local)]
            if i % 2 == 0:
                hs = [h @ p["w"] + p["b"] for h, p in zip(hs, layers)]
            else:
                g = _gather(mesh, [h @ p["w"] for h, p in zip(hs, layers)])
                hs = [tp_row(g, d) + p["b"] for (d, _), p in zip(local,
                                                                 layers)]
            if not last:
                hs = [torch.relu(h) for h in hs]
        return hs

    def step_fn(params, opt, X, Y):
        n_out = net[-1].w.shape[1]
        n_rows = X[0].shape[0] * dp
        opt.zero_grad()
        outs = forward(params, X)
        losses = []
        for (_, t), out, y in zip(local, outs, Y):
            if out.shape[1] != y.shape[1]:    # the output sharded over tp
                c = out.shape[1]
                y = y[:, t * c:(t + 1) * c]
            losses.append(out_share * torch.sum((out - y) ** 2)
                          / (n_rows * n_out))
        torch.stack(losses).sum().backward()
        _reduce_grads(params)
        opt.step()
        loss = mesh.psum([x.detach() for x in losses])
        return params, opt, loss

    def _reduce_grads(params):
        """Each piece's gradient summed over the shards holding a copy:
        the dp column of its tp coordinate, every shard for a replicated
        bias."""
        flat = [torch.cat([x.grad.reshape(-1) for x in params.tensors(j)])
                for j in range(mesh.n_local)]
        g = mesh.all_gather(flat)
        same_t = {t: [s for s in range(mesh.size)
                      if _coord(mesh, s, tp_axis) == t] for t in range(tp)}
        every = list(range(mesh.size))
        for j, (_, t) in enumerate(local):
            start = 0
            for i, x in enumerate(params.tensors(j)):
                n = x.numel()
                shards = every if (i % 2 == 1 and i // 2 % 2 == 1) \
                    else same_t[t]
                acc = g[shards[0], start:start + n]
                for s in shards[1:]:
                    acc = acc + g[s, start:start + n]
                x.grad.copy_(acc.reshape(x.shape))
                start += n

    return init, step_fn, place_batch
