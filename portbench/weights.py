"""Weights drawn from the run's seed, by name and shape.

One normal draw on the device for every parameter together, cut into the
parameters in the order of ``reference.dmv3d.param_shapes``: a weight
(two or more axes) scaled by 1 / sqrt(fan-in), a GroupNorm scale 1 + 0.1 n,
any other vector (biases) 0.1 n. The benchmark loads the same tensors into
the program and into the reference.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import dmv3d


def draw(shapes: dict, seed: int, device) -> dict:
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        x = flat[at:at + n].view(shape)
        at += n
        if len(shape) > 1:
            x.mul_(1.0 / math.sqrt(dmv3d.fan_in(shape)))
        elif name.endswith(".scale"):
            x.mul_(0.1).add_(1.0)
        else:
            x.mul_(0.1)
        out[name] = x
    return out
