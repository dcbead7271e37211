"""The one generator of every traffic mix: a pool of inputs from the seed.

A traffic file (``traffic/<name>.json``) gives the mix's parameters:
``kind`` (the driver ``kinds/<kind>.py`` that offers the load:
``serve_closed``, ``Model.predict`` requests from closed-loop clients;
``train_hostbatch``, train steps on host batches), ``batch``, ``seq_len``
(frames a request or example), ``targets``, ``pool`` (distinct inputs,
cycled), ``src_views`` (``fixed``: every frame from one camera;
``orbit``: each frame from its own camera, sorted by azimuth), ``trace``
(``[first, count]``: after the window, a ``--trace 1`` run runs ``first``
units unprofiled, then profiles ``count``) and what the kind reads
besides (``serve_closed``: ``clients``, ``compare``, the requests kept
for the check); ``frames`` (``float32`` in [-1, 1], as a user passes
them to ``predict``, or ``uint8``, as the data sources give them) and
``target_images`` (whether an input carries the targets' frames, as a
train batch does).

Frames are smooth: sums of four random sinusoids of up to 3 cycles an
image. Poses are those the
program's synthetic sources draw: azimuth uniform in [0, 2 pi), elevation
in [0.1, 0.6], radius 2. Every seed gives the same shapes; only the
values change.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent


def load(name: str) -> dict:
    return json.loads((ROOT / "traffic" / f"{name}.json").read_text())


def _smooth(gen, shape, hw: int, device) -> torch.Tensor:
    """[*shape, hw, hw, 3] sums of 4 sinusoids, each 0.25 in amplitude."""
    y, x = torch.meshgrid(torch.arange(hw, device=device) / hw,
                          torch.arange(hw, device=device) / hw, indexing="ij")
    out = torch.zeros(*shape, hw, hw, 3, device=device)
    lead = (*shape, 1, 1, 3)
    for _ in range(4):
        fx = torch.rand(lead, generator=gen, device=device) * 6 - 3
        fy = torch.rand(lead, generator=gen, device=device) * 6 - 3
        phase = torch.rand(lead, generator=gen, device=device) * 2 * math.pi
        out += 0.25 * torch.sin(2 * math.pi * (fx * x[..., None]
                                               + fy * y[..., None]) + phase)
    return out


def _poses(rng: np.random.Generator, shape) -> np.ndarray:
    return np.stack([rng.uniform(0, 2 * np.pi, shape),
                     rng.uniform(0.1, 0.6, shape),
                     np.full(shape, 2.0)], -1).astype(np.float32)


def _src_poses(rng, traffic: dict, b: int) -> np.ndarray:
    t = traffic["seq_len"]
    if traffic["src_views"] == "orbit":
        poses = _poses(rng, (b, t))
        order = np.argsort(poses[..., 0], axis=1)
        return np.take_along_axis(poses, order[..., None], axis=1)
    if traffic["src_views"] != "fixed":
        raise ValueError(f"unknown src_views {traffic['src_views']!r}")
    return np.repeat(_poses(rng, (b, 1)), t, axis=1)


def pool(traffic: dict, image_size: int, seed: int, device) -> list[dict]:
    """``traffic["pool"]`` distinct inputs of the mix, as host numpy
    arrays ``{image_seq, src_poses, tgt_poses}``, and ``tgt_images`` where
    the mix has ``target_images``."""
    n, b, t, k = (traffic[key] for key in ("pool", "batch", "seq_len",
                                             "targets"))
    rng = np.random.default_rng([seed, 1])
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    targets = traffic["target_images"]
    out = []
    for _ in range(n):
        frames = _smooth(gen, (b, t + (k if targets else 0)), image_size,
                         device)
        if traffic["frames"] == "uint8":
            frames = ((frames + 1.0) * 127.5).round().clamp(0, 255) \
                .to(torch.uint8)
        elif traffic["frames"] != "float32":
            raise ValueError(f"unknown frames {traffic['frames']!r}")
        frames = frames.cpu().numpy()
        item = {"image_seq": np.ascontiguousarray(frames[:, :t]),
                "src_poses": _src_poses(rng, traffic, b),
                "tgt_poses": _poses(rng, (b, k))}
        if targets:
            item["tgt_images"] = np.ascontiguousarray(frames[:, t:])
        out.append(item)
    return out
