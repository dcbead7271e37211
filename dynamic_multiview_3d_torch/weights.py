"""Weights: flax param tree <-> torch ``state_dict``, and flax's default init.

The port's modules carry the flax names, so a flax path maps to a torch key
by joining with "." and renaming the leaf (``kernel`` -> ``weight``; ``bias``
and GroupNorm ``scale`` keep their names). Conv kernels go HWIO -> OIHW and
dense kernels [in, out] -> [out, in]; the recurrent step's params sit under
``recurrent/`` in both trees.
"""

from __future__ import annotations

import math
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

_LEAF = {"kernel": "weight", "bias": "bias", "scale": "scale"}


def flatten(params: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """A nested param tree as ``{"a/b/c": ndarray}``."""
    out = {}
    for k, v in params.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def from_flax(params: Mapping, module: nn.Module) -> dict[str, torch.Tensor]:
    """Convert a flax param tree for ``module``'s architecture.

    ``params`` is either the nested dict of arrays (``variables["params"]``)
    or its flat ``{"a/b/c": ndarray}`` form. Strict: every flax leaf must
    land on exactly one state_dict entry of matching shape and every entry
    must be filled; otherwise raises ``ValueError`` naming the paths.
    """
    flat = flatten(params)
    expected = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    out: dict[str, torch.Tensor] = {}
    unmatched, bad_shape = [], []
    for path, arr in sorted(flat.items()):
        *parents, leaf = path.split("/")
        key = ".".join(parents + [_LEAF.get(leaf, leaf)])
        if leaf not in _LEAF or key not in expected or key in out:
            unmatched.append(path)
            continue
        if leaf == "kernel" and arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)                  # HWIO -> OIHW
        elif leaf == "kernel" and arr.ndim == 2:
            arr = arr.T                                       # [in,out] -> [out,in]
        if tuple(arr.shape) != expected[key]:
            bad_shape.append(f"{path} {tuple(arr.shape)} != {key} "
                             f"{expected[key]}")
            continue
        out[key] = torch.tensor(np.ascontiguousarray(arr), dtype=torch.float32)
    missing = sorted(set(expected) - set(out))
    if unmatched or bad_shape or missing:
        raise ValueError(
            "flax params do not match the module: "
            f"unmatched flax leaves {unmatched}; shape mismatches {bad_shape}; "
            f"state_dict entries not filled {missing}")
    return out


def baked_num_sources(params: Mapping, cfg) -> int | None:
    """The source count T baked into a multi-source checkpoint's heads
    (``decoder/heads_multi/kernel`` has 3T+4 output channels for multiflow,
    T+4 for multidepth); None when ``cfg`` (a ModelConfig) has no baked
    heads or the weights have no such kernel. ``params`` is a flax tree
    (nested or flat) or a ``state_dict``."""
    if cfg.synthesis not in ("multiflow", "multidepth") \
            or cfg.multi_head_mode != "baked":
        return None
    if "decoder.heads_multi.weight" in params:               # OIHW
        out = params["decoder.heads_multi.weight"].shape[0] - 4
    else:
        kernel = flatten(params).get("decoder/heads_multi/kernel")
        if kernel is None:
            return None
        out = kernel.shape[-1] - 4
    return out // 3 if cfg.synthesis == "multiflow" else out


def to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of ``from_flax``: a nested flax param tree of numpy
    arrays (f32 as stored) from a ``state_dict`` or any mapping of the same
    keys, such as a module's gradients by parameter name."""
    tree: dict = {}
    for key, t in state_dict.items():
        *parents, leaf = key.split(".")
        a = t.detach().cpu().numpy()
        if leaf == "weight":
            leaf = "kernel"
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T  # OIHW->HWIO
        node = tree
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = a
    return tree


@torch.no_grad()
def init_flax_defaults_(module: nn.Module, generator: torch.Generator) -> None:
    """flax's default initialisers, drawn in parameter order: conv and dense
    kernels truncated-normal lecun (variance 1/fan_in, cut at 2 std), biases
    0, GroupNorm scale 1."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight":
            fan_in = math.prod(p.shape[1:])
            # the unit truncated normal on (-2, 2) has std 0.87962566...
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
        elif leaf == "scale":
            p.fill_(1.0)
        else:
            p.zero_()
