"""The ('data', 'model') mesh over processes (port of parallel/mesh.py).

The JAX package lays its devices out as a ('data', 'model') mesh and runs
one program over it. The port runs one process per device of that mesh,
launched by ``python -m torch.distributed.run --nproc-per-node N`` (or
any launcher that sets its environment: RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT). ``make_mesh(cfg.mesh)`` joins the process
group and returns a ``Mesh``: the rank, the world size, the rank's device,
the backend and, with ``mesh.model`` > 1, the rank's place on each axis
and a process group for each. NCCL where each rank has a GPU of its own;
gloo on the CPU and where ranks share a card (NCCL refuses two ranks on
one device), its collectives then staged through host memory.

Ranks are laid out as ``jax.make_mesh`` orders devices, row-major over
(data, model): global rank = data_rank * model + model_rank, so the
model peers of a data rank are adjacent ranks. The global batch is split
into contiguous rows by data rank (``shard_batch``; model peers take the
same rows), and after the backward the gradients are averaged over the
data axis (``all_reduce_mean_``, the counterpart of ``lax.pmean``).
``model_axis_rules`` picks the weights whose output channels the 'model'
axis splits, as the JAX rule does; ``parallel/tensor.py`` splits them and
runs the channel collectives (``all_gather_model``,
``all_reduce_model``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any

import torch
import torch.distributed as dist

from dynamic_multiview_3d_torch.api import resolve_device
from dynamic_multiview_3d_torch.config import MeshConfig

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on the (data, model) mesh. ``backend`` is None
    for a single process with no process group. ``data_group`` and
    ``model_group`` are the process groups of the rank's data and model
    axes; both None without a 'model' axis (``model_size`` 1), where the
    data axis is the world."""

    rank: int = 0
    world_size: int = 1
    device: torch.device = torch.device("cpu")
    backend: str | None = None
    model_size: int = 1
    data_group: Any = None
    model_group: Any = None

    @property
    def distributed(self) -> bool:
        return self.backend is not None

    @property
    def data_size(self) -> int:
        return self.world_size // self.model_size

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_size

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_size

    @property
    def host_staged(self) -> bool:
        """gloo on the card: collectives go through host copies."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def __deepcopy__(self, memo):
        # names processes and their groups: a copied module shares it
        return self


def _rank_device(device) -> torch.device:
    """``device`` for this rank: "cuda" resolves to the card LOCAL_RANK
    names (modulo the cards there are: ranks share cards when there are
    fewer)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def _backend(dev: torch.device) -> str:
    if dev.type != "cuda":
        return "gloo"
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     os.environ.get("WORLD_SIZE", "1")))
    return "nccl" if torch.cuda.device_count() >= local_world else "gloo"


def make_mesh(cfg: MeshConfig | None = None, device=None,
              timeout_s: float = 600.0) -> Mesh:
    """The mesh of ``cfg`` (counterpart of the JAX ``make_mesh``).

    Joins the process group from the launcher's environment when
    ``mesh.multihost`` is set, ``mesh.data`` or ``mesh.model`` > 1 or
    WORLD_SIZE > 1, unless this process has joined it already. The world
    must hold data x model processes; ``mesh.data`` 0 or less means world
    // model. With ``mesh.model`` > 1 every rank creates every data group
    and every model group, in one order. ``device`` defaults to "cuda"
    (raises without a GPU). The backend is NCCL where each rank has a
    card, else gloo."""
    cfg = cfg or MeshConfig()
    model = max(1, cfg.model)
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if not dist.is_initialized() and (cfg.multihost or cfg.data > 1
                                      or model > 1 or env_world > 1):
        missing = [k for k in _ENV if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"mesh.data={cfg.data} mesh.model={cfg.model} (multihost="
                f"{cfg.multihost}) needs one process per rank, and "
                f"{missing} are not set: launch with python -m "
                "torch.distributed.run --nproc-per-node N")
        dev = _rank_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(_backend(dev),
                                init_method="env://",
                                timeout=datetime.timedelta(seconds=timeout_s))
    if dist.is_initialized():
        dev = _rank_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        rank, world = dist.get_rank(), dist.get_world_size()
        backend = dist.get_backend()
    else:
        dev, rank, world, backend = resolve_device(device), 0, 1, None
    data = cfg.data if cfg.data > 0 else world // model
    if data * model != world:
        raise ValueError(f"mesh.data={cfg.data} x mesh.model={cfg.model} "
                         f"needs {data * model} processes, but {world} were "
                         "launched")
    groups = {}
    if model > 1:
        # every rank makes every group, in one order (dist.new_group)
        data_groups = [dist.new_group([d * model + m for d in range(data)])
                       for m in range(model)]
        model_groups = [dist.new_group([d * model + m
                                        for m in range(model)])
                        for d in range(data)]
        groups = {"data_group": data_groups[rank % model],
                  "model_group": model_groups[rank // model]}
    return Mesh(rank, world, dev, backend, model, **groups)


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def local_rows(mesh: Mesh, n: int) -> tuple[int, int]:
    """[lo, hi) of this data rank's contiguous share of ``n`` global rows
    (model peers share their rows)."""
    if n % mesh.data_size:
        raise ValueError(f"global batch {n} not divisible by "
                         f"data={mesh.data_size}")
    per = n // mesh.data_size
    return mesh.data_rank * per, (mesh.data_rank + 1) * per


def shard_batch(mesh: Mesh, batch: dict, axis: int = 0) -> dict:
    """This data rank's rows of a global batch (numpy arrays or tensors):
    contiguous along ``axis`` (1 for steps_per_dispatch batches, whose
    leading axis is the dispatch's)."""
    out = {}
    for k, x in batch.items():
        lo, hi = local_rows(mesh, x.shape[axis])
        index = (slice(None),) * axis + (slice(lo, hi),)
        out[k] = x[index]
    return out


def _collective(mesh: Mesh, flat: torch.Tensor, fn) -> None:
    if mesh.host_staged:
        host = flat.cpu()
        fn(host)
        flat.copy_(host)
    else:
        fn(flat)


def all_reduce_mean_(mesh: Mesh, tensors: list[torch.Tensor],
                     world: bool = False) -> None:
    """Average ``tensors`` (one dtype, one device) over the data axis, in
    place (with ``world``, over every rank): one all-reduce of one flat
    buffer. Every rank of the group ends with the same bits."""
    size = mesh.world_size if world else mesh.data_size
    if size == 1 or not tensors:
        return
    group = None if world else mesh.data_group
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _collective(mesh, flat, lambda x: dist.all_reduce(x, group=group))
    flat /= size
    torch._foreach_copy_(tensors, [v.view_as(t) for v, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)])


def broadcast_(mesh: Mesh, tensors: list[torch.Tensor]) -> None:
    """Rank 0's values of ``tensors`` on every rank, in place."""
    if not mesh.distributed or not tensors:
        return
    for dtype in {t.dtype for t in tensors}:
        group = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in group])
        _collective(mesh, flat, lambda x: dist.broadcast(x, 0))
        torch._foreach_copy_(group, [v.view_as(t) for v, t in zip(
            flat.split([t.numel() for t in group]), group)])


def replicate(mesh: Mesh, state) -> None:
    """Rank 0's parameters, buffers and EMA on every rank (the counterpart
    of placing the state with ``replicate``): ``state`` is a
    ``train.step.TrainState`` or an ``nn.Module``."""
    module = getattr(state, "module", state)
    tensors = [t.data for t in module.parameters()] + list(module.buffers())
    ema = getattr(state, "ema", None)
    if ema is not None:
        tensors += list(ema.values())
    with torch.no_grad():
        broadcast_(mesh, tensors)


def _all_gather(mesh: Mesh, x: torch.Tensor, size: int, group,
                dim: int) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along ``dim`` in rank
    order."""
    src = x.contiguous()
    if mesh.host_staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim).to(x.device)


def all_gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every data rank's ``x`` (one shape on every rank) concatenated along
    the leading axis, in rank order, on every rank."""
    if mesh.data_size == 1:
        return x
    return _all_gather(mesh, x, mesh.data_size, mesh.data_group, 0)


def all_gather_model(mesh: Mesh, x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model peers' blocks ``x`` concatenated along ``dim`` in model
    rank order, on every peer: a channel-split activation made whole."""
    return _all_gather(mesh, x, mesh.model_size, mesh.model_group, dim)


def all_reduce_model(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the model peers, in f32 and cast back to ``x``'s
    dtype (so bf16 partial sums round once): a new tensor."""
    flat = x.to(torch.float32, copy=True)
    _collective(mesh, flat, lambda v: dist.all_reduce(v,
                                                      group=mesh.model_group))
    return flat.to(x.dtype)


def broadcast_object(mesh: Mesh, obj):
    """Rank 0's picklable ``obj`` on every rank."""
    if not mesh.distributed:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, 0, device=None if mesh.backend == "gloo"
                               else mesh.device)
    return box[0]


def barrier(mesh: Mesh) -> None:
    if mesh.distributed:
        if mesh.backend == "nccl":
            dist.barrier(device_ids=[mesh.device.index])
        else:
            dist.barrier()


def model_axis_rules(module, mesh: Mesh, min_size: int = 128) -> set[str]:
    """The names of the weights the 'model' axis splits (the JAX package's
    ``model_axis_rules``): every parameter of ``ndim >= 2`` whose output
    dimension (dim 0: OIHW conv weights, [out, in] dense weights; flax's
    last) is at least ``min_size`` and divisible by ``mesh.model_size``.
    Biases and GroupNorm params (1-D) stay replicated. Empty when the mesh
    has no model axis."""
    m = mesh.model_size
    if m == 1:
        return set()
    return {name for name, p in module.named_parameters()
            if p.dim() >= 2 and p.shape[0] >= min_size
            and p.shape[0] % m == 0}
