"""Plain reference of the train step: the synthesis mode's loss, its
gradient by autograd through ``reference.dmv3d``, and the optimizer's
update at the schedule's learning rate, everything in float32.

The loss is the synthesis module's (``reference/synthesis/<name>.py``);
the learning rate ``reference/schedule/<lr_schedule>.py``'s and the
update ``reference/optimizer/<optimizer>.py``'s, each found by the train
config.
"""

from __future__ import annotations

import torch

from portbench import byname
from portbench.reference import dmv3d


def loss(net: dmv3d.Net, batch: dict, train_cfg: dict) -> torch.Tensor:
    """The total loss of ``batch`` (uint8 images, f32 poses, as tensors)."""
    image_seq = batch["image_seq"].to(torch.float32) / 127.5 - 1.0
    target = batch["tgt_images"].to(torch.float32) / 127.5 - 1.0
    out = net.forward(image_seq, batch["src_poses"], batch["tgt_poses"])
    return net.synth.loss(out, target, train_cfg)


def run_steps(model_cfg: dict, train_cfg: dict, params: dict, batches,
              quant=None, state=None, keep_state=False) -> dict:
    """Steps from ``params`` (copied, not changed) over ``batches``: each
    step's loss, the first step's gradient by name, the change of every
    parameter over all the steps by name and, with ``keep_state``, the
    optimizer's state they leave. ``state``: the optimizer's state to go
    on from (``optimizer/<name>.py``'s, with ``"count"`` the updates done
    before)."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    opt = byname.load("reference/optimizer", train_cfg["optimizer"]) \
        .Optimizer(p, train_cfg, state)
    schedule = byname.load("reference/schedule", train_cfg["lr_schedule"])
    losses, first_grads = [], None
    with dmv3d.exact_f32():
        for batch in batches:
            total = loss(dmv3d.Net(model_cfg, p, quant), batch, train_cfg)
            grads = dict(zip(p, torch.autograd.grad(total, list(p.values()),
                                                    allow_unused=True)))
            grads = {k: torch.zeros_like(p[k]) if g is None else g
                     for k, g in grads.items()}
            if first_grads is None:
                first_grads = grads
            opt.update(p, grads, schedule.lr(train_cfg, opt.count))
            losses.append(float(total.detach()))
    out = {"losses": losses, "first_grads": first_grads,
           "change": {k: (p[k].detach() - params[k]) for k in p}}
    if keep_state:
        out["state"] = opt.state()
    return out
