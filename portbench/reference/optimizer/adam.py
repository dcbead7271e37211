"""Adam without weight decay, as PyTorch's and optax's: bias-corrected
moments, eps 1e-8 outside the square root. Over a ``{name: tensor}`` dict,
updated in place."""

from __future__ import annotations

import torch


class Optimizer:
    def __init__(self, params: dict, train_cfg: dict, state=None):
        """``state``, where given: ``{"exp_avg", "exp_avg_sq"}`` by name and
        ``"count"``, the updates done, to go on from."""
        if train_cfg["weight_decay"]:
            raise ValueError("the reference's adam has no weight decay")
        self.b1, self.b2 = train_cfg["beta1"], train_cfg["beta2"]
        if state is None:
            self.m = {k: torch.zeros_like(v) for k, v in params.items()}
            self.v = {k: torch.zeros_like(v) for k, v in params.items()}
            self.count = 0
        else:
            self.m = {k: state["exp_avg"][k].to(v).clone()
                      for k, v in params.items()}
            self.v = {k: state["exp_avg_sq"][k].to(v).clone()
                      for k, v in params.items()}
            self.count = state["count"]

    @torch.no_grad()
    def update(self, params: dict, grads: dict, lr: float) -> None:
        self.count += 1
        c1, c2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = self.v[k].sqrt() / c2 ** 0.5 + 1e-8
            p.addcdiv_(self.m[k], denom, value=-lr / c1)

    def state(self) -> dict:
        """What ``state`` takes to go on from here."""
        return {"exp_avg": self.m, "exp_avg_sq": self.v, "count": self.count}
