"""The plain reference's train step (``train.py``) over a batch too large
to keep the activations of at once: the loss and its gradient over equal
blocks of the batch's examples, one block's graph at a time, the blocks'
mean taken before the optimizer's one update.

The losses of the flow synthesis mode (``synthesis/flow.py``: the view's
L1 and the mask's cross-entropy) are means over the batch's pixels, and
every layer treats each example alone, so the mean of equal blocks' losses
is the batch's loss and the mean of their gradients its gradient, to
float32 rounding. A loss that is not such a mean (the masked L1 of the
depth modes) is refused.
"""

from __future__ import annotations

import torch

from portbench import byname
from portbench.reference import dmv3d
from portbench.reference import train as ref_train

# the synthesis modes whose loss is a mean over the examples
MEAN_LOSSES = ("flow",)


def loss_and_grads(model_cfg: dict, train_cfg: dict, p: dict, batch: dict,
                   block: int, quant=None) -> tuple[float, dict]:
    """The batch's loss and its gradient by name, from ``block`` examples
    at a time."""
    n = len(batch["tgt_poses"])
    if n % block:
        raise ValueError(f"a batch of {n} does not split into blocks of "
                         f"{block}")
    parts = n // block
    total = 0.0
    grads = {k: torch.zeros_like(v) for k, v in p.items()}
    for lo in range(0, n, block):
        part = {k: v[lo:lo + block] for k, v in batch.items()}
        out = ref_train.loss(dmv3d.Net(model_cfg, p, quant), part,
                             train_cfg) / parts
        for k, g in zip(p, torch.autograd.grad(out, list(p.values()),
                                               allow_unused=True)):
            if g is not None:
                grads[k] += g
        total += float(out.detach())
    return total, grads


def run_steps(model_cfg: dict, train_cfg: dict, params: dict, batches,
              block: int, quant=None, state=None,
              keep_state=False) -> dict:
    """``train.run_steps`` with each step's loss and gradient taken over
    blocks of ``block`` examples."""
    name = dmv3d.synthesis_name(model_cfg)
    if name not in MEAN_LOSSES:
        raise ValueError(f"the loss of {name!r} is no mean over the "
                         "examples: its blocks do not add up to the batch")
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    opt = byname.load("reference/optimizer", train_cfg["optimizer"]) \
        .Optimizer(p, train_cfg, state)
    schedule = byname.load("reference/schedule", train_cfg["lr_schedule"])
    losses, first_grads = [], None
    with dmv3d.exact_f32():
        for batch in batches:
            total, grads = loss_and_grads(model_cfg, train_cfg, p, batch,
                                          block, quant)
            if first_grads is None:
                first_grads = grads
            opt.update(p, grads, schedule.lr(train_cfg, opt.count))
            losses.append(total)
    out = {"losses": losses, "first_grads": first_grads,
           "change": {k: (p[k].detach() - params[k]) for k in p}}
    if keep_state:
        out["state"] = opt.state()
    return out
