"""Data parallelism over processes (port of parallel/mesh.py).

The JAX package lays its devices out as a ('data', 'model') mesh and runs
one program over it. The port runs one process per rank of the 'data'
axis, launched by ``python -m torch.distributed.run --nproc-per-node N``
(or any launcher that sets its environment: RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT). ``make_mesh(cfg.mesh)`` joins the
process group and returns a ``Mesh``: the rank, the world size, the
rank's device and the backend. NCCL where each rank has a GPU of its own;
gloo on the CPU and where ranks share a card (NCCL refuses two ranks on
one device), its collectives then staged through host memory.

Every rank holds the whole model; the global batch is split into
contiguous rows (``shard_batch``), and after the backward the gradients
are averaged over ranks (``all_reduce_mean_``), the counterpart of
``lax.pmean`` in the JAX step. The 'model' axis (channel-sharded wide
convs under GSPMD) is not ported: ``mesh.model > 1`` and
``model_axis_rules`` raise, naming ROADMAP.md queue 1 item 11b.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from dynamic_multiview_3d_torch.api import resolve_device
from dynamic_multiview_3d_torch.config import MeshConfig

MODEL_AXIS = ("the 'model' mesh axis (channel-sharded params, JAX's "
              "mode='auto' on a (data, model) mesh) is not ported yet: "
              "ROADMAP.md queue 1 item 11b")
_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on the data axis. ``backend`` is None for a
    single process with no process group."""

    rank: int = 0
    world_size: int = 1
    device: torch.device = torch.device("cpu")
    backend: str | None = None

    @property
    def distributed(self) -> bool:
        return self.backend is not None

    @property
    def host_staged(self) -> bool:
        """gloo on the card: collectives go through host copies."""
        return self.backend == "gloo" and self.device.type == "cuda"


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
    ``mesh.multihost`` is set, ``mesh.data`` > 1 or WORLD_SIZE > 1, unless
    this process has joined it already. ``mesh.data`` must equal the world
    size; 0 or less means the world size. ``device`` defaults to "cuda"
    (raises without a GPU). The backend is NCCL where each rank has a
    card, else gloo."""
    cfg = cfg or MeshConfig()
    if cfg.model > 1:
        raise NotImplementedError(MODEL_AXIS)
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if not dist.is_initialized() and (cfg.multihost or cfg.data > 1
                                      or env_world > 1):
        missing = [k for k in _ENV if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"mesh.data={cfg.data} (multihost={cfg.multihost}) needs "
                f"one process per rank, and {missing} are not set: launch "
                "with python -m torch.distributed.run --nproc-per-node N")
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
        mesh = Mesh(dist.get_rank(), dist.get_world_size(), dev,
                    dist.get_backend())
    else:
        mesh = Mesh(device=resolve_device(device))
    if cfg.data > 0 and cfg.data != mesh.world_size:
        raise ValueError(f"mesh.data={cfg.data} but {mesh.world_size} "
                         "processes were launched")
    return mesh


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def local_rows(mesh: Mesh, n: int) -> tuple[int, int]:
    """[lo, hi) of this rank's contiguous share of ``n`` global rows."""
    if n % mesh.world_size:
        raise ValueError(f"global batch {n} not divisible by "
                         f"data={mesh.world_size}")
    per = n // mesh.world_size
    return mesh.rank * per, (mesh.rank + 1) * per


def shard_batch(mesh: Mesh, batch: dict, axis: int = 0) -> dict:
    """This rank's rows of a global batch (numpy arrays or tensors):
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


def all_reduce_mean_(mesh: Mesh, tensors: list[torch.Tensor]) -> None:
    """Average ``tensors`` (one dtype, one device) over the ranks, in
    place: one all-reduce of one flat buffer. Every rank ends with the
    same bits."""
    if not mesh.distributed or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _collective(mesh, flat, lambda x: dist.all_reduce(x))
    flat /= mesh.world_size
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


def all_gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (one shape on every rank) concatenated along the
    leading axis, in rank order, on every rank."""
    if not mesh.distributed:
        return x
    src = x.contiguous()
    if mesh.host_staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.world_size)]
    dist.all_gather(parts, src)
    return torch.cat(parts).to(x.device)


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


def model_axis_rules(params, mesh: Mesh, min_size: int = 128):
    """Channel sharding of wide params over the 'model' axis: not
    ported."""
    raise NotImplementedError(MODEL_AXIS)

