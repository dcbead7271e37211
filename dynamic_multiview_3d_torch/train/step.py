"""The train step (port of train/step.py).

One step: preprocess the batch on the device (uint8 -> [-1, 1], optional
target subsampling), forward, ``total_loss``, backward (on CUDA through the
backward kernel of the fused warp + composite, or of the multi-source one),
the optimizer update, then the EMA of the params. The JAX package compiles this into one XLA program;
PyTorch runs it eagerly, and the state is updated in place.

Optimizers match optax's: ``adam`` -> ``torch.optim.Adam`` (eps 1e-8),
``adamw`` or ``adam`` with weight_decay > 0 -> ``torch.optim.AdamW``
(decoupled decay scaled by the learning rate, as ``optax.adamw``), ``sgd``
-> ``torch.optim.SGD``. A schedule sets each group's lr before the update
from the number of updates done so far, as optax evaluates it.

With a device-resident bank (``resident``, ``data/resident.py``) the step
takes an index batch and gathers its pixels on the device; with
``data.device_sampling`` it takes no batch at all and draws each sub-step's
examples on the device. Both draws, the examples and the target subsets,
are the JAX step's own: its key chain (``fold_in(key(data.seed), step)``,
split once for device sampling; ``utils.jax_random.step_keys``) in the
port's copy of ``jax.random``, so a JAX run moved to the card trains on the
examples the JAX run would have drawn.

Data parallelism (``mesh``, a ``parallel.mesh.Mesh``): each rank steps on
its contiguous rows of the global batch, and every random draw is keyed
by the global example index (``index_offset`` = rank x local batch, for
the target subsampling and the device draw), so the ranks together draw
what one process draws on the global batch. After the backward the
gradients are averaged over the ranks by one all-reduce of one flat
buffer (``parallel.mesh.all_reduce_mean_``, the counterpart of
``lax.pmean``): every rank then applies the same update to the same
params, so the replicas, and their EMAs, stay bitwise equal. Not
``DistributedDataParallel``: its bucketed reduction overlaps the backward
but fires from autograd hooks once per backward, where an explicit
reduction after it keeps the step's order (one reduction, then the
update) under every path of this step (steps_per_dispatch, device
sampling, the kernels' autograd ops) and under gloo and NCCL alike.

On one CUDA device (``graph_engages``: a mesh of one process, autograd
on) the forward, the loss and the backward of an optimizer step run as one
``torch.cuda.CUDAGraph`` (``StepGraph``): the first two steps of a batch
signature (each preprocessed leaf's shape, dtype and strides) run
eagerly, warming cuDNN's plans and creating the optimizer's state; the
third captures them and replays the graph, and every later step of that
signature copies its batch into the captured inputs and replays it. The
same kernels run in the same order on the same data, so the update does
not change; the host no longer issues each launch. The draw, the
preprocessing, the learning rate, the gradients' average, the optimizer,
the EMA and the metrics' fetch stay eager, in their order, so hooks on
the optimizer and patches of the data path fire every step. One graph is
kept: a batch of another signature runs eagerly. Python-side launch
counters (``_build.stage.copies``, the kernels' ``*_launches``) count
the launches Python issues: a replay issues none.

A 'model' axis (``mesh.model_size`` > 1; the JAX package's ``mode="auto"``
with ``model_axis_rules``): ``init_state(mesh=)`` splits the output
channels of the wide convs over the model peers (``parallel/tensor.py``),
which take the same rows; the step then averages each weight block's
gradient over its data group and the replicated params' over every rank
(``tensor.average_gradients_``), and the optimizer and the EMA hold the
blocks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from dynamic_multiview_3d_torch import weights
from dynamic_multiview_3d_torch.api import resolve_device
from dynamic_multiview_3d_torch.config import Config
from dynamic_multiview_3d_torch.data import pipeline
from dynamic_multiview_3d_torch.models import DMV3D
from dynamic_multiview_3d_torch.parallel import mesh as mesh_lib
from dynamic_multiview_3d_torch.parallel import tensor as tensor_lib
from dynamic_multiview_3d_torch.train import losses as losses_lib
from dynamic_multiview_3d_torch.train import metrics as metrics_lib
from dynamic_multiview_3d_torch.utils import jax_random as jr
from dynamic_multiview_3d_torch.utils import profiling


def make_lr(cfg: Config):
    """Learning rate: a float for "constant", else a function of the number
    of updates done, equal to the JAX package's optax schedule at every
    step ("cosine" over train.num_steps with optional linear warmup)."""
    t = cfg.train
    if t.lr_schedule == "constant":
        return t.lr
    if t.lr_schedule != "cosine":
        raise ValueError(f"unknown lr_schedule: {t.lr_schedule}")
    decay_steps = max(t.num_steps - t.warmup_steps, 1)
    alpha = t.lr_final / t.lr if t.lr else 0.0

    def cosine(count: int) -> float:          # optax.cosine_decay_schedule
        count = min(count, decay_steps)
        decay = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return t.lr * ((1.0 - alpha) * decay + alpha)

    if not t.warmup_steps:
        return cosine
    warm = t.warmup_steps

    def schedule(step: int) -> float:         # optax.join_schedules
        if step < warm:                       # optax.linear_schedule(0, lr)
            frac = 1.0 - min(max(step, 0), warm) / warm
            return -t.lr * frac + t.lr
        return cosine(step - warm)
    return schedule


def make_optimizer(cfg: Config, params) -> torch.optim.Optimizer:
    t = cfg.train
    lr = make_lr(cfg)
    lr0 = lr(0) if callable(lr) else lr
    if t.optimizer == "sgd":
        return torch.optim.SGD(params, lr=lr0)
    betas = (t.beta1, t.beta2)
    if t.optimizer == "adamw" or (t.optimizer == "adam"
                                  and t.weight_decay > 0):
        return torch.optim.AdamW(params, lr=lr0, betas=betas, eps=1e-8,
                                 weight_decay=t.weight_decay)
    if t.optimizer == "adam":
        return torch.optim.Adam(params, lr=lr0, betas=betas, eps=1e-8)
    raise ValueError(f"unknown optimizer: {t.optimizer}")


@dataclasses.dataclass
class TrainState:
    """The module (its params), the optimizer, the number of updates done
    and, with train.ema_decay > 0, an EMA copy of the params by name."""

    module: DMV3D
    optimizer: torch.optim.Optimizer
    step: int = 0
    ema: dict[str, torch.Tensor] | None = None


def init_state(cfg: Config, seed: int | None = None, device=None,
               mesh: mesh_lib.Mesh | None = None, min_size: int = 128
               ) -> TrainState:
    """A fresh state on ``device`` (default "cuda"; raises without a GPU):
    flax's default init drawn from a ``torch.Generator`` seeded with
    ``seed`` (default train.seed; not JAX's numbers); baked multi-source
    heads are made for ``data.seq_len`` sources.

    With a ``mesh`` (on its device): global rank 0's state on every rank
    (``parallel.mesh.replicate``), then, under a 'model' axis, the weights
    of ``model_axis_rules(module, mesh, min_size)`` split over the model
    peers (``parallel.tensor.shard_state``)."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    module = DMV3D(cfg.model, num_sources=cfg.data.seq_len)
    weights.init_flax_defaults_(module, torch.Generator().manual_seed(
        cfg.train.seed if seed is None else seed))
    module.to(dev).train()
    ema = ({n: p.detach().clone() for n, p in module.named_parameters()}
           if cfg.train.ema_decay > 0 else None)
    state = TrainState(module, make_optimizer(cfg, module.parameters()),
                       ema=ema)
    if mesh is None:
        return state
    mesh_lib.replicate(mesh, state)
    return tensor_lib.shard_state(state, mesh, mesh_lib.model_axis_rules(
        module, mesh, min_size))


def graph_engages(device: torch.device, mesh: mesh_lib.Mesh) -> bool:
    """Whether a train step on ``device`` and ``mesh`` may replay its
    forward, loss and backward as a CUDA graph: a CUDA device, a mesh of
    one process (on a larger one the forward holds collectives, or the
    gradients' average would run inside), and autograd on."""
    return (device.type == "cuda" and mesh.world_size == 1
            and mesh.model_size == 1 and torch.is_grad_enabled())


def signature(batch: dict) -> tuple:
    """What a captured graph fixes of a preprocessed batch: each leaf's
    name, shape, dtype and strides."""
    return tuple((k, tuple(v.shape), v.dtype, v.stride())
                 for k, v in batch.items())


class StepGraph:
    """The forward, the loss and the backward of one optimizer step as one
    CUDA graph: ``plan`` decides each step's path, ``run`` captures and
    replays. The graph's inputs are tensors of the batch's signature,
    its outputs the parameters' gradients and the step's metrics. It is
    captured with the gradients set to None, so the backward writes them
    rather than adding to them: a graphed step needs no ``zero_grad``, and
    before each replay any parameter whose ``grad`` is no longer the
    captured tensor gets it back. Its private memory pool keeps the step's
    temporaries for the life of the graph."""

    WARM = 2            # eager steps of a signature before its capture

    def __init__(self, device: torch.device, mesh: mesh_lib.Mesh):
        self.device, self.mesh = device, mesh
        self.calls: dict[tuple, int] = {}   # steps a signature has taken
        self.graph = None
        self.module = None
        self.sig = None

    def plan(self, module: DMV3D, batch: dict) -> str:
        """The path of one step of ``module`` on the preprocessed
        ``batch``: "eager", "capture" (the signature's ``WARM`` + 1-th
        step, while no graph is kept) or "replay" (the captured module and
        signature, its parameters where they were)."""
        if not graph_engages(self.device, self.mesh):
            return "eager"
        sig = signature(batch)
        if self.graph is not None:
            same = (module is self.module and sig == self.sig
                    and all(p.data_ptr() == ptr for p, ptr in
                            zip(self.params, self.ptrs)))
            return "replay" if same else "eager"
        n = self.calls[sig] = self.calls.get(sig, 0) + 1
        return "capture" if n > self.WARM else "eager"

    def run(self, how: str, state: TrainState, batch: dict,
            forward_backward: Callable) -> dict:
        """One step's metrics from the graph (``how`` from ``plan``):
        ``forward_backward(state, batch) -> metrics`` is captured on
        "capture", then the graph replays on ``batch``."""
        if how == "capture":
            self._capture(state, batch, forward_backward)
        else:
            for k, v in batch.items():
                self.inputs[k].copy_(v)
            for p, g in zip(self.params, self.grads):
                if p.grad is not g:
                    p.grad = g
        self.graph.replay()
        profiling.count("dmv3d.train.graph.replays")
        # the next replay overwrites the graph's outputs
        return {k: v.clone() for k, v in self.metrics.items()}

    def _capture(self, state: TrainState, batch: dict,
                 forward_backward: Callable) -> None:
        self.inputs = {k: torch.empty_strided(v.shape, v.stride(),
                                              dtype=v.dtype, device=v.device)
                       for k, v in batch.items()}
        for k, v in batch.items():
            self.inputs[k].copy_(v)
        state.optimizer.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            metrics = forward_backward(state, self.inputs)
        self.metrics = {k: v.detach() for k, v in metrics.items()}
        self.params = list(state.module.parameters())
        self.ptrs = [p.data_ptr() for p in self.params]
        self.grads = [p.grad for p in self.params]
        self.graph, self.module, self.sig = graph, state.module, \
            signature(batch)
        profiling.count("dmv3d.train.graph.captures")


def make_train_step(cfg: Config, device=None, mesh=None,
                    resident=None) -> Callable:
    """-> step(state, batch) -> (state, metrics): one optimizer update per
    call (``train.steps_per_dispatch`` > 1: that many, over the leading
    axis of every batch leaf, metrics averaged). ``batch`` holds numpy
    arrays or tensors (uint8 or float images, as the data sources give
    them; with ``resident``, a ``ResidentFrames``, the int32 row indices
    of its ``index_batch``; with ``data.device_sampling``, None);
    ``metrics`` are floats under the JAX package's names (``loss/l1``,
    ``loss/mask``, ``loss/total``, ...). The state is updated in place and
    returned.

    With ``mesh`` the step runs on the mesh's device, ``batch`` is this
    rank's rows of the global batch (``parallel.mesh.shard_batch``; None
    under device sampling, which draws the rank's rows of
    ``data.batch_size``), and the gradients and metrics are averaged over
    the data ranks. It is the step of both of the JAX package's modes,
    "shard_map" and "auto": on a mesh with a 'model' axis, ``state`` comes
    from ``init_state(mesh=)`` (or ``parallel.tensor.shard_state``)."""
    if mesh is not None and not isinstance(mesh, mesh_lib.Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, not "
                        f"{type(mesh).__name__}")
    if cfg.data.device_sampling and resident is None:
        raise ValueError("data.device_sampling requires a device-resident "
                         "dataset (pass resident=)")
    if resident is not None and getattr(resident, "num_shards", 1) > 1 \
            and not cfg.data.device_sampling:
        raise ValueError("a scene-sharded bank needs data.device_sampling "
                         "(a rank can only address its own scenes' rows)")
    mesh = mesh or mesh_lib.Mesh(device=resolve_device(device))
    dev = mesh.device
    tcfg = cfg.train
    lr = make_lr(cfg)
    spd = tcfg.steps_per_dispatch
    device_sampling = cfg.data.device_sampling
    sample_meta = resident.sample_meta() if device_sampling else None
    # device sampling: the data rank's rows [lo, hi) of the global batch
    lo, hi = (mesh_lib.local_rows(mesh, cfg.data.batch_size)
              if device_sampling else (0, 0))

    def to_device(batch: dict | None) -> dict | None:
        if batch is None:           # one host-to-device copy per leaf
            return None
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    graph = StepGraph(dev, mesh)

    def forward_backward(state: TrainState, batch: dict) -> dict:
        """The forward, the loss and its backward -> the metrics."""
        out = state.module(batch["image_seq"], batch["src_poses"],
                           batch["tgt_poses"])
        with profiling.span("dmv3d.train.loss"):
            loss, metrics = losses_lib.total_loss(
                out, batch, tcfg, synthesis=cfg.model.synthesis)
        # adopting: a CUDA backward runs on autograd's own thread, where
        # the encoder's recomputation opens its span
        with profiling.span("dmv3d.train.backward", adopt=True):
            loss.backward()
        return metrics

    def one_step(state: TrainState, batch: dict | None) -> dict:
        with profiling.span("dmv3d.train.inputs"):
            key, k_samp = jr.step_keys(cfg.data.seed, state.step,
                                       device_sampling)
            batch = to_device(batch)
            if device_sampling:
                batch = resident.device_sample(sample_meta, k_samp, hi - lo,
                                               index_offset=lo)
            elif resident is not None:
                batch = resident.gather(resident.frames, resident.poses,
                                        batch)
            # the data rank's first row in the global batch keys its draws
            offset = mesh.data_rank * batch["tgt_poses"].shape[0]
            batch = pipeline.preprocess(
                batch, device=dev, key=key,
                targets_per_step=cfg.data.targets_per_step,
                index_offset=offset)
        how = graph.plan(state.module, batch)
        with profiling.span("dmv3d.train.optimizer"):
            if callable(lr):
                for group in state.optimizer.param_groups:
                    group["lr"] = lr(state.step)
            if how == "eager":
                state.optimizer.zero_grad(set_to_none=True)
        if how == "eager":
            profiling.count("dmv3d.train.graph.eager_steps")
            metrics = forward_backward(state, batch)
        else:
            with profiling.span("dmv3d.train.graph"):
                metrics = graph.run(how, state, batch, forward_backward)
        with profiling.span("dmv3d.train.optimizer"):
            tensor_lib.average_gradients_(mesh, state.module)
            state.optimizer.step()
            state.step += 1
            if state.ema is not None:
                d = tcfg.ema_decay
                with torch.no_grad():
                    ema = [state.ema[n] for n, _ in
                           state.module.named_parameters()]
                    torch._foreach_mul_(ema, d)
                    torch._foreach_add_(ema, list(state.module.parameters()),
                                        alpha=1.0 - d)
        return {k: v.detach() for k, v in metrics.items()}

    def step(state: TrainState, batch: dict | None = None):
        with profiling.unit():
            if spd > 1:
                with profiling.span("dmv3d.train.inputs"):
                    batch = to_device(batch)
                ms = [one_step(state, None if batch is None
                               else {k: v[i] for k, v in batch.items()})
                      for i in range(spd)]
            else:
                ms = [one_step(state, batch)]
            with profiling.span("dmv3d.train.sync"):
                metrics = ms[0] if spd == 1 else {
                    k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
                names = list(metrics)
                values = torch.stack([metrics[k] for k in names])
                mesh_lib.all_reduce_mean_(mesh, [values])
                return state, dict(zip(names, values.tolist()))  # 1 sync

    return step


def make_eval_step(cfg: Config, device=None) -> Callable:
    """-> eval_step(module, batch) -> {"eval/psnr", "eval/ssim"} floats: the
    forward under inference mode, scored against batch["tgt_images"]."""
    dev = resolve_device(device)

    def eval_step(module: DMV3D, batch: dict) -> dict:
        with torch.inference_mode():
            batch = pipeline.preprocess(batch, device=dev)
            out = module(batch["image_seq"], batch["src_poses"],
                         batch["tgt_poses"])
            return {
                "eval/psnr": float(metrics_lib.psnr(out["view"],
                                                    batch["tgt_images"])),
                "eval/ssim": float(metrics_lib.ssim(out["view"],
                                                    batch["tgt_images"])),
            }
    return eval_step
