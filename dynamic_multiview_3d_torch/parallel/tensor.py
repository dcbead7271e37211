"""Tensor parallelism over the 'model' mesh axis.

The JAX package gets it from GSPMD: ``parallel/mesh.py``
``model_axis_rules`` places the output-channel dim of the wide conv and
dense kernels on 'model', and ``train/step.py`` ``mode="auto"`` lets XLA
partition the step around them. This module is their port, by hand:
``shard_module_`` gives each chosen ``layers.Conv`` / ``layers.Dense``
(``parallel.mesh.model_axis_rules``) its model rank's contiguous block of
output channels ``[m * O / M, (m + 1) * O / M)`` and keeps its bias whole
(the JAX rule leaves 1-D params replicated). Its forward:

1. ``_ToModel``: the identity; in the backward, the input's gradient
   summed over the model peers (each holds the part its block
   contributes), in f32;
2. the conv or linear with the block and no bias;
3. ``_GatherModel``: the peers' blocks gathered in rank order along the
   channel dim; in the backward, the rank's block of the gradient,
   unreduced: downstream of the gather every peer computes the same
   thing, so the gradient is already the same on every peer
   (``torch.distributed.nn.functional.all_gather`` sums every rank's
   gradient, which would multiply it by M);
4. the bias added.

So GroupNorm, ``depth_to_space2``, the GRU's gate split, the heads and the
kernels always read whole activations, and the sharded model is the same
function as the unsharded one, up to rounding. ``full_state`` /
``shard_state`` convert a ``train.step.TrainState`` to and from the
one-process layout (params, both Adam moments, the EMA), which the
checkpoints keep.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from dynamic_multiview_3d_torch.models import layers
from dynamic_multiview_3d_torch.parallel import mesh as mesh_lib


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return mesh_lib.all_reduce_model(ctx.mesh, grad), None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh_lib.all_gather_model(mesh, block, dim)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        return (grad.chunk(mesh.model_size, ctx.dim)[mesh.model_rank]
                .contiguous(), None, None)


def _block(mesh, t: torch.Tensor) -> torch.Tensor:
    """This model rank's block of ``t``'s output channels (dim 0)."""
    if t.shape[0] % mesh.model_size:
        raise ValueError(f"{t.shape[0]} output channels do not split over "
                         f"model={mesh.model_size}")
    return t.detach().chunk(mesh.model_size, 0)[mesh.model_rank].clone()


class ShardedConv(layers.Conv):
    """A ``layers.Conv`` holding its model rank's block of output channels
    and its whole bias; its output is whole on every model peer."""

    def __init__(self, conv: layers.Conv, mesh):
        nn.Module.__init__(self)
        self.kernel, self.stride, self.dtype = conv.kernel, conv.stride, \
            conv.dtype
        self.mesh = mesh
        self.weight = nn.Parameter(_block(mesh, conv.weight))
        self.bias = conv.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._conv(_ToModel.apply(x.to(self.dtype), self.mesh), None)
        y = _GatherModel.apply(y, self.mesh, 1)
        if self.bias is None:
            return y
        return y + self.bias.to(self.dtype)[:, None, None]

    def whole(self) -> layers.Conv:
        """The unsharded layer (every model peer calls it)."""
        out, inp = self.weight.shape[0] * self.mesh.model_size, \
            self.weight.shape[1]
        conv = layers.Conv(inp, out, self.kernel, self.stride,
                           use_bias=self.bias is not None, dtype=self.dtype)
        conv.weight = nn.Parameter(mesh_lib.all_gather_model(
            self.mesh, self.weight.detach(), 0))
        conv.bias = self.bias
        return conv


class ShardedDense(layers.Dense):
    """A ``layers.Dense`` holding its model rank's block of output
    features and its whole bias; its output is whole on every model
    peer."""

    def __init__(self, dense: layers.Dense, mesh):
        nn.Module.__init__(self)
        self.dtype, self.mesh = dense.dtype, mesh
        self.weight = nn.Parameter(_block(mesh, dense.weight))
        self.bias = dense.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.linear(_ToModel.apply(x.to(dt), self.mesh), self.weight.to(dt))
        return _GatherModel.apply(y, self.mesh, -1) + self.bias.to(dt)

    def whole(self) -> layers.Dense:
        """The unsharded layer (every model peer calls it)."""
        dense = layers.Dense(self.weight.shape[1],
                             self.weight.shape[0] * self.mesh.model_size,
                             dtype=self.dtype)
        dense.weight = nn.Parameter(mesh_lib.all_gather_model(
            self.mesh, self.weight.detach(), 0))
        dense.bias = self.bias
        return dense


_SHARDED = {layers.Conv: ShardedConv, layers.Dense: ShardedDense}


def _swap(module: nn.Module, name: str, layer: nn.Module) -> None:
    parent, _, attr = name.rpartition(".")
    setattr(module.get_submodule(parent), attr, layer)


def shard_module_(module: nn.Module, mesh, rules) -> nn.Module:
    """Split, in place, the layers whose weights ``rules`` names (the
    parameter names of ``parallel.mesh.model_axis_rules``): each becomes a
    ``ShardedConv`` / ``ShardedDense`` under the same name, so parameter
    names and order stay. Every rank holds the same ``module`` (replicated)
    when it is called."""
    for name in sorted(rules):
        owner, _, leaf = name.rpartition(".")
        layer = module.get_submodule(owner)
        kind = _SHARDED.get(type(layer))
        if leaf != "weight" or kind is None:
            raise ValueError(f"{name}: the 'model' axis splits the weights "
                             "of layers.Conv and layers.Dense only")
        _swap(module, owner, kind(layer, mesh))
    return module


def block_names(module: nn.Module) -> set[str]:
    """The parameter names of ``module`` that hold a block."""
    return {f"{n}.weight" for n, m in module.named_modules()
            if isinstance(m, (ShardedConv, ShardedDense))}


def whole_module(module: nn.Module) -> nn.Module:
    """An unsharded copy of ``module`` (itself where nothing is split):
    every model peer calls it, since each split layer gathers its
    weight."""
    if not block_names(module):
        return module
    whole = copy.deepcopy(module)
    split = [(n, m) for n, m in whole.named_modules()
             if isinstance(m, (ShardedConv, ShardedDense))]
    with torch.no_grad():
        for name, layer in split:
            _swap(whole, name, layer.whole())
    return whole


def full_tensors(module: nn.Module, mesh, named: dict) -> dict:
    """``named`` ({parameter name: tensor of its shape}, such as gradients
    or an EMA) with every block gathered whole along dim 0; every model
    peer calls it with the same names in the same order."""
    blocks = block_names(module)
    return {n: mesh_lib.all_gather_model(mesh, t.detach(), 0)
            if n in blocks else t for n, t in named.items()}


def _optimizer(optimizer, params, state: dict):
    """An optimizer of ``optimizer``'s kind over ``params`` holding
    ``state`` (a ``state_dict``, which carries the groups' settings)."""
    out = type(optimizer)(params, lr=optimizer.defaults["lr"])
    out.load_state_dict(state)
    return out


def _map_moments(state, fn) -> dict:
    """``state.optimizer.state_dict()`` with ``fn(name, t)`` applied to
    each per-parameter tensor of a parameter's shape (the moments; not
    Adam's 0-d step), parameter by parameter in order."""
    named = list(state.module.named_parameters())
    osd = state.optimizer.state_dict()
    osd["state"] = {
        i: {k: fn(named[i][0], v) if torch.is_tensor(v)
            and v.shape == named[i][1].shape else v for k, v in s.items()}
        for i, s in sorted(osd["state"].items())}
    return osd


def full_state(state, mesh):
    """The one-process layout of a ``train.step.TrainState`` whose module
    ``shard_module_`` split (the state itself where nothing is split), on
    every rank: every rank takes part in the gathers. An unsharded copy of
    the module, an optimizer of the same kind over it with the gathered
    moments, the gathered EMA, the step."""
    if not block_names(state.module):
        return state
    with torch.no_grad():
        osd = _map_moments(state, lambda n, t: full_tensors(
            state.module, mesh, {n: t})[n])
        module = whole_module(state.module)
        ema = (None if state.ema is None
               else full_tensors(state.module, mesh, state.ema))
    return dataclasses.replace(
        state, module=module,
        optimizer=_optimizer(state.optimizer, module.parameters(), osd),
        ema=ema)


def shard_state(state, mesh, rules):
    """A ``train.step.TrainState`` in the one-process layout, the same on
    every rank, with the weights ``rules`` names split over the model axis:
    its module split in place (``shard_module_``), an optimizer of the same
    kind over it holding the moments' blocks, the EMA's blocks."""
    if not rules:
        return state
    with torch.no_grad():
        osd = _map_moments(state, lambda n, t: _block(mesh, t)
                           if n in rules else t)
        shard_module_(state.module, mesh, rules)
        ema = (None if state.ema is None else
               {n: _block(mesh, t) if n in rules else t
                for n, t in state.ema.items()})
    return dataclasses.replace(
        state, optimizer=_optimizer(state.optimizer,
                                    state.module.parameters(), osd),
        ema=ema)


def average_gradients_(mesh, module: nn.Module) -> None:
    """Average ``module``'s gradients over the data axis, in place. Under a
    model axis the blocks are averaged over their data group, and the
    replicated params over every rank: their model peers compute the same
    gradients, and one reduction over the world keeps their copies bitwise
    equal where a kernel is not deterministic."""
    named = [(n, p.grad) for n, p in module.named_parameters()
             if p.grad is not None]
    if mesh.model_size == 1:
        mesh_lib.all_reduce_mean_(mesh, [g for _, g in named])
        return
    blocks = block_names(module)
    mesh_lib.all_reduce_mean_(mesh, [g for n, g in named if n in blocks])
    mesh_lib.all_reduce_mean_(mesh, [g for n, g in named if n not in blocks],
                              world=True)
