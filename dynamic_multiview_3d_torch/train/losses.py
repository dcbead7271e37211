"""Losses (port of train/losses.py): L1 photometric + mask BCE (+ optional
flow smoothness and DSSIM, and the masked geometric L1 wherever the model
predicts depth), computed in f32 on the head outputs, with the JAX
package's metric names."""

from __future__ import annotations

import torch

from dynamic_multiview_3d_torch.config import TrainConfig
from dynamic_multiview_3d_torch.ops import sampling


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred.to(torch.float32)
                                - target.to(torch.float32)))


def flow_validity(flow: torch.Tensor) -> torch.Tensor:
    """1 where the flow lands inside the source image: flow [B,K,H,W,2] ->
    [B,K,H,W,1] (the mask head's target when the model gives none)."""
    b, k, h, w, _ = flow.shape
    return sampling.in_bounds_mask(
        flow.reshape(b * k, h, w, 2), h, w).reshape(b, k, h, w, 1)


def mask_loss(mask: torch.Tensor, validity: torch.Tensor) -> torch.Tensor:
    """BCE(mask, validity), the mask clipped to [1e-6, 1 - 1e-6]."""
    target = validity.to(torch.float32)
    m = torch.clamp(mask.to(torch.float32), 1e-6, 1.0 - 1e-6)
    bce = -(target * torch.log(m) + (1.0 - target) * torch.log1p(-m))
    return torch.mean(bce)


def smoothness_loss(flow: torch.Tensor) -> torch.Tensor:
    """Total-variation smoothness of a [..., H, W, 2] flow field."""
    dx = torch.abs(flow[..., :, 1:, :] - flow[..., :, :-1, :])
    dy = torch.abs(flow[..., 1:, :, :] - flow[..., :-1, :, :])
    return torch.mean(dx) + torch.mean(dy)


def total_loss(out: dict, batch: dict, cfg: TrainConfig,
               synthesis: str = "flow") -> tuple[torch.Tensor, dict]:
    """Combined objective and per-term metrics (0-d tensors).

    out: model outputs (view/flow/mask/flow_valid/geo_view/geo_valid/depth,
    NHWC); batch: has 'tgt_images' [B,K,H,W,3]. ``synthesis`` selects the
    mask's validity target: reprojection validity (``geo_valid``) for
    "depth" and "multidepth", else the warp's in-bounds validity.
    """
    target = batch["tgt_images"]
    l1 = l1_loss(out["view"], target)
    if synthesis in ("depth", "multidepth"):
        validity = out["geo_valid"][..., None]
    elif "flow_valid" in out:
        validity = out["flow_valid"][..., None]     # from the fused kernel
    else:
        validity = flow_validity(out["flow"])
    lm = mask_loss(out["mask"], validity)
    loss = cfg.l1_weight * l1 + cfg.mask_weight * lm
    metrics = {"loss/l1": l1, "loss/mask": lm}
    if cfg.ssim_weight > 0:
        from dynamic_multiview_3d_torch.train import metrics as metrics_lib
        ls = 1.0 - metrics_lib.ssim(out["view"], target)
        loss = loss + cfg.ssim_weight * ls
        metrics["loss/dssim"] = ls
    if cfg.smooth_weight > 0 and "flow" in out:
        # any [..., H, W, 2] flow: [B,K,H,W,2], or multiflow's [B,K,T,H,W,2]
        ls = smoothness_loss(out["flow"])
        loss = loss + cfg.smooth_weight * ls
        metrics["loss/smooth"] = ls
    if "depth" in out:
        # the depth head's photometric supervision: L1 of the reprojected
        # view where the reprojection is valid (invalid pixels are ignored,
        # not pulled to 0)
        channels = out["geo_view"].shape[-1]
        valid = out["geo_valid"][..., None].to(torch.float32)
        resid = torch.abs(out["geo_view"].to(torch.float32)
                          - target.to(torch.float32)) * valid
        geo_l1 = resid.sum() / torch.clamp_min(valid.sum() * channels, 1.0)
        loss = loss + cfg.geo_weight * geo_l1
        metrics["loss/geo_l1"] = geo_l1
    metrics["loss/total"] = loss
    return loss, metrics
