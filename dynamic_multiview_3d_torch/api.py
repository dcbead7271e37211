"""Public inference API (port of api.py).

``Model`` holds a config and a ``DMV3D`` module on one device and answers
``predict(image_seq, target_poses)`` with novel views, with the JAX
package's semantics (unbatched inputs, the canonical source pose, NHWC
outputs). Entry points run on CUDA unless the caller passes
``device="cpu"``; without a GPU they raise instead of falling back.
``from_checkpoint`` loads a model directory (``train/checkpoint.py``):
one the port wrote, or one the JAX package wrote (read through
``tensorstore``); ``save_checkpoint`` writes the port's.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from dynamic_multiview_3d_torch import config as config_lib
from dynamic_multiview_3d_torch import weights
from dynamic_multiview_3d_torch.models import DMV3D
from dynamic_multiview_3d_torch.train import checkpoint as ckpt_lib

DEFAULT_POSE = (0.0, 0.3, 2.0)   # canonical source pose when none is given


def _f32(x, device) -> torch.Tensor:
    if not torch.is_tensor(x):
        x = np.array(x, np.float32)          # a writable copy for torch
    return torch.as_tensor(x, dtype=torch.float32, device=device)


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

    def save_checkpoint(self, path: str, step: int = 0) -> None:
        ckpt_lib.save_model(path, self.module, self.cfg, step)

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
        """
        dev = self.device
        with torch.inference_mode():
            image_seq = _f32(image_seq, dev)
            target_poses = _f32(target_poses, dev)
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
                source_poses = torch.tensor(
                    DEFAULT_POSE, dtype=torch.float32,
                    device=dev).expand(b, t, 3)
            else:
                source_poses = _f32(source_poses, dev)
                if source_poses.dim() == 2:
                    source_poses = source_poses[None]
            out = self.module(image_seq, source_poses, target_poses)
            if not return_aux:
                out = out["view"]
                return out[0] if unbatched else out
            return {k: v[0] for k, v in out.items()} if unbatched else out


def predict(checkpoint_path: str, image_seq, target_poses, device=None, **kw):
    """One-shot functional form: load ``checkpoint_path`` on ``device`` and
    predict."""
    return Model.from_checkpoint(checkpoint_path, device=device).predict(
        image_seq, target_poses, **kw)
