"""The terms the synthesis modes' training losses are made of, in float32."""

from __future__ import annotations

import torch


def l1(view, target):
    return (view - target).abs().mean()


def mask_bce(mask, valid):
    """Binary cross-entropy of the mask (clipped to [1e-6, 1 - 1e-6])
    against its target."""
    m = mask.clamp(1e-6, 1.0 - 1e-6)
    return -(valid * torch.log(m) + (1.0 - valid) * torch.log1p(-m)).mean()


def masked_l1(view, target, valid):
    """L1 over the pixels where ``valid`` [B,K,H,W] is 1, over their
    count times the channels (at least 1)."""
    v = valid[..., None]
    return ((view - target).abs() * v).sum() \
        / torch.clamp_min(v.sum() * view.shape[-1], 1.0)


def require_zero(train_cfg: dict, *names) -> None:
    """Raise where a loss weight this reference does not implement is set."""
    bad = {n: train_cfg[n] for n in names if train_cfg[n]}
    if bad:
        raise ValueError(f"the reference's loss has no term for {bad}")
