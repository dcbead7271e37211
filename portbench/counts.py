"""Work a cell's shapes ask for, counted by the benchmark's own code.

FLOPs: ``FlopCounterMode`` over the plain reference on the ``meta``
device (a request: the forward; a train step: forward and backward of the
loss), so the count is the same whatever implements the model.

A kernel's bound: the least time the chip could take for its bytes and
operations, the larger of bytes over HBM bandwidth and operations over
the float32 rate. Each roofline metric's reader
(``metrics/<kernel>_roofline.py``) holds its kernel's bytes and
operations (each input read once and each output written once, in
float32, frozen from the port's kernel table); its share is the bound
over the kernel's mean device time.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import dmv3d
from portbench.reference import train as ref_train

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core peak, float32 outside
# the tensor cores, HBM3 bandwidth (at the 700 W power limit)
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def _meta_inputs(model_cfg: dict, b: int, t: int, k: int, train: bool):
    hw = model_cfg["image_size"]
    dt = torch.uint8 if train else torch.float32
    out = {"image_seq": torch.empty(b, t, hw, hw, 3, dtype=dt, device="meta"),
           "src_poses": torch.empty(b, t, 3, device="meta"),
           "tgt_poses": torch.empty(b, k, 3, device="meta")}
    if train:
        out["tgt_images"] = torch.empty(b, k, hw, hw, 3, dtype=dt,
                                        device="meta")
    return out


def _params(model_cfg: dict, grad: bool) -> dict:
    return {n: torch.empty(s, device="meta", requires_grad=grad)
            for n, s in dmv3d.param_shapes(model_cfg).items()}


def forward_flops(model_cfg: dict, b: int, t: int, k: int) -> float:
    """FLOPs of the forward of ``b`` examples of ``t`` frames and ``k``
    targets."""
    x = _meta_inputs(model_cfg, b, t, k, train=False)
    with FlopCounterMode(display=False) as counter:
        dmv3d.Net(model_cfg, _params(model_cfg, False)).forward(
            x["image_seq"], x["src_poses"], x["tgt_poses"])
    return float(counter.get_total_flops())


def step_flops(config: dict, b: int, t: int, k: int) -> float:
    """FLOPs of the forward and backward of the training loss (the
    ``model`` and ``train`` sections of a configuration ``config``)."""
    m = config["model"]
    x = _meta_inputs(m, b, t, k, train=True)
    with FlopCounterMode(display=False) as counter:
        ref_train.loss(dmv3d.Net(m, _params(m, True)), x,
                       config["train"]).backward()
    return float(counter.get_total_flops())


def bound_s(work: tuple[int, int]) -> float:
    """The least time of a launch moving ``work`` = (bytes, operations)."""
    nbytes, ops = work
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS)
