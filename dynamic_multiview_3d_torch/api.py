"""Public inference API (port of api.py).

``Model`` holds a config and a ``DMV3D`` module on one device and answers
``predict(image_seq, target_poses)`` with novel views, with the JAX
package's semantics (unbatched inputs, the canonical source pose, NHWC
outputs). Entry points run on CUDA unless the caller passes
``device="cpu"``; without a GPU they raise instead of falling back.
``from_checkpoint`` loads a model directory (``train/checkpoint.py``):
one the port wrote, or one the JAX package wrote (Orbax, read by the
port's own reader); ``save_checkpoint`` writes either format.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from dynamic_multiview_3d_torch import config as config_lib
from dynamic_multiview_3d_torch import weights
from dynamic_multiview_3d_torch.models import DMV3D
from dynamic_multiview_3d_torch.train import checkpoint as ckpt_lib
from dynamic_multiview_3d_torch.utils import profiling

DEFAULT_POSE = (0.0, 0.3, 2.0)   # canonical source pose when none is given


def _f32(x, device) -> torch.Tensor:
    if not torch.is_tensor(x):
        x = np.array(x, np.float32)          # a writable copy for torch
    return torch.as_tensor(x, dtype=torch.float32, device=device)


_VIEWABLE = tuple(np.dtype(t) for t in (np.float16, np.float32, np.float64))


def _host_f32(x, pin_memory: bool) -> torch.Tensor:
    """``x`` (an array, a list, a tensor on the host) as float32 in a new
    host block, pinned where ``pin_memory``: one pass over ``x``, with
    ``np.array(x, np.float32)``'s conversion. Torch's copy, on its
    intra-op threads, fills it where torch can view ``x`` (a tensor, a
    writable float array in native byte order with no negative stride);
    ``np.copyto``, on one thread, where it cannot. A pinned block comes
    from PyTorch's caching host allocator."""
    if isinstance(x, np.ndarray) and x.dtype in _VIEWABLE \
            and x.flags.writeable and min(x.strides, default=0) >= 0:
        x = torch.from_numpy(x)
    if torch.is_tensor(x):
        block = torch.empty(x.shape, dtype=torch.float32,
                            pin_memory=pin_memory)
        return block.copy_(x)
    if not isinstance(x, np.ndarray):
        x = np.array(x, np.float32)          # a list or a number: small
    block = torch.empty(x.shape, dtype=torch.float32, pin_memory=pin_memory)
    np.copyto(block.numpy(), x, casting="unsafe")
    return block


def _sent(x, device) -> tuple[torch.Tensor, int]:
    """``x`` as float32 on ``device`` with no wait on the card -> (it, the
    bytes staged, 0 where ``x`` was not staged). On a CUDA device a host
    input is staged: filled into a pinned block (``_host_f32``), then
    copied on the current stream without blocking. The copy records an
    event on the block, and the allocator hands the block out again only
    once the copy has run, so back-to-back calls never share a block in
    flight. A pinned contiguous float32 tensor is sent as it is; an input
    already on a device is converted there. On the CPU: ``_f32``."""
    if device.type != "cuda":
        return _f32(x, device), 0
    if torch.is_tensor(x):
        if x.device.type != "cpu":
            return torch.as_tensor(x, dtype=torch.float32, device=device), 0
        if x.dtype == torch.float32 and x.is_contiguous() and x.is_pinned():
            return x.to(device, non_blocking=True), 0
    block = _host_f32(x, pin_memory=True)
    return block.to(device, non_blocking=True), block.nbytes


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, "cuda" when None; raises if CUDA is
    asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


class Model:
    """DMV3D model on one device with an inference-mode ``predict``."""

    def __init__(self, cfg: config_lib.Config, module: DMV3D):
        self.cfg = cfg
        self.module = module

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    # -- construction --------------------------------------------------------
    @classmethod
    def init_random(cls, cfg: config_lib.Config, seed: int = 0,
                    device=None) -> "Model":
        """Random weights from flax's default initialisers, drawn from a
        ``torch.Generator`` seeded with ``seed`` (not JAX's numbers).
        Baked multi-source heads are made for ``cfg.data.seq_len``
        sources."""
        dev = resolve_device(device)
        module = DMV3D(cfg.model, num_sources=cfg.data.seq_len)
        weights.init_flax_defaults_(module, torch.Generator().manual_seed(seed))
        return cls(cfg, module.to(dev).eval())

    @classmethod
    def from_flax_params(cls, cfg: config_lib.Config, params: Mapping,
                         device=None) -> "Model":
        """Weights from a flax param tree (nested or flat, see
        ``weights.from_flax``). Baked multi-source heads take their source
        count from the tree's ``heads_multi`` kernel."""
        dev = resolve_device(device)
        module = DMV3D(cfg.model,
                       num_sources=weights.baked_num_sources(params, cfg.model))
        module.load_state_dict(weights.from_flax(params, module))
        return cls(cfg, module.to(dev).eval())

    @classmethod
    def from_checkpoint(cls, path: str, device=None) -> "Model":
        """The model directory ``path`` (``checkpoint.save_model``'s, or
        the JAX package's Orbax one). Baked multi-source heads take their
        source count from the weights."""
        params, cfg, _ = ckpt_lib.load_model(path)
        if any("/" in k for k in params):            # a flax tree: JAX's
            return cls.from_flax_params(cfg, params, device=device)
        dev = resolve_device(device)
        module = DMV3D(cfg.model,
                       num_sources=weights.baked_num_sources(params, cfg.model))
        module.load_state_dict(params)
        return cls(cfg, module.to(dev).eval())

    def save_checkpoint(self, path: str, step: int = 0,
                        fmt: str = "pt") -> None:
        """Write the model directory ``path``: ``params_{step}.pt``
        (``fmt="pt"``) or the JAX package's Orbax ``params_{step}/``
        (``fmt="orbax"``)."""
        ckpt_lib.save_model(path, self.module, self.cfg, step, fmt=fmt)

    # -- inference ------------------------------------------------------------
    def predict(self, image_seq, target_poses, source_poses=None,
                return_aux: bool = False):
        """Novel views for each target pose.

        image_seq    [B,T,H,W,3] or [T,H,W,3], values in [-1, 1]
        target_poses [B,K,3] or [K,3] (azimuth, elevation, radius)
        source_poses optional [B,T,3] / [T,3]; single-source models default
                     to a canonical pose. Multi-source models (synthesis
                     multiflow/multidepth) require it.

        Returns views [B,K,H,W,3] (or [K,H,W,3] if inputs were unbatched) as
        a float32 tensor on the model's device; with ``return_aux`` the dict
        of every output.

        Host inputs (numpy arrays, lists, CPU tensors) are copied before
        ``predict`` returns, so the caller may overwrite them at once. On
        a CUDA device ``predict`` never waits for the card: each host input
        goes through a pinned block and a non-blocking copy on the current
        stream, and the views returned are computed in stream order after
        the call, as a CUDA operation's output is. A pinned contiguous
        float32 CPU tensor is sent as it is, so the card reads it after the
        call: leave it unchanged until the current stream has run the call.
        """
        with torch.inference_mode(), profiling.unit():
            with profiling.span("dmv3d.predict.inputs"):
                image_seq, target_poses, source_poses, unbatched = \
                    self._inputs(image_seq, target_poses, source_poses)
            out = self.module(image_seq, source_poses, target_poses)
            if not return_aux:
                out = out["view"]
                return out[0] if unbatched else out
            return {k: v[0] for k, v in out.items()} if unbatched else out

    def _inputs(self, image_seq, target_poses, source_poses):
        """``predict``'s inputs as batched float32 tensors on the model's
        device (the canonical source pose where none is given) ->
        image_seq, target_poses, source_poses, whether they came
        unbatched. On a CUDA device no input waits on the card (``_sent``),
        and while the program records, the staging is counted
        (``dmv3d.predict.inputs.*`` in ``utils/profiling.py``)."""
        dev = self.device
        counting = dev.type == "cuda" and profiling.on()
        allocs = _host_allocs() if counting else 0
        staged = []

        def sent(x):
            x, nbytes = _sent(x, dev)
            if nbytes:
                staged.append(nbytes)
            return x

        image_seq = sent(image_seq)
        target_poses = sent(target_poses)
        unbatched = image_seq.dim() == 4
        if unbatched:
            image_seq = image_seq[None]
            target_poses = target_poses[None]
        b, t = image_seq.shape[:2]
        if source_poses is None:
            synthesis = self.cfg.model.synthesis
            if synthesis in ("multiflow", "multidepth"):
                raise ValueError(
                    f"synthesis={synthesis!r} checkpoints blend EVERY "
                    "source frame by its own camera; predict() needs "
                    "source_poses ([B,T,3] az/el/radius, the cameras the "
                    "frames were shot from) — the canonical-pose default "
                    f"would claim all {t} sources sit at the same camera "
                    "and silently degrade the render")
            source_poses = sent(DEFAULT_POSE).expand(b, t, 3)
        else:
            source_poses = sent(source_poses)
            if source_poses.dim() == 2:
                source_poses = source_poses[None]
        if counting:
            profiling.count("dmv3d.predict.inputs.staged", len(staged))
            profiling.count("dmv3d.predict.inputs.staged_bytes", sum(staged))
            profiling.count("dmv3d.predict.inputs.host_allocs",
                            _host_allocs() - allocs)
        return image_seq, target_poses, source_poses, unbatched


def _host_allocs() -> int:
    """Pinned blocks the caching host allocator has taken from CUDA."""
    return torch.cuda.host_memory_stats()["num_host_alloc"]


def predict(checkpoint_path: str, image_seq, target_poses, device=None, **kw):
    """One-shot functional form: load ``checkpoint_path`` on ``device`` and
    predict."""
    return Model.from_checkpoint(checkpoint_path, device=device).predict(
        image_seq, target_poses, **kw)
