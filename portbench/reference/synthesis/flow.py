"""Flow synthesis: one head gives a flow, a mask and an RGB guess per
target pixel; the view is the last source frame warped by the flow
(bilinear, border padding), composited with the guess by the mask. The
mask's target is the warp's validity (the flow lands inside the frame).
Loss: L1 of the view plus ``mask_weight`` times the mask's cross-entropy.
"""

from __future__ import annotations

import torch

from portbench.reference import dmv3d, losses


def add_params(m, f_in, conv, dense):
    conv("decoder.heads", f_in, 6, 3)


def pose_code(src_poses, tgt_poses):
    """The last source's pose against each target's: [B*K, 8]."""
    k = tgt_poses.shape[1]
    return dmv3d.encode_view_pair(src_poses[:, -1].repeat_interleave(k, 0),
                                  tgt_poses.reshape(-1, 3))


def view(net, x, code, image_seq, src_poses, tgt_poses):
    m = net.m
    b, _, hh, ww, _ = image_seq.shape
    k = tgt_poses.shape[1]
    y = net.conv("decoder.heads", x)
    flow = torch.tanh(y[:, 0:2]) * (m["max_flow"] * m["image_size"])
    mask = torch.sigmoid(y[:, 2:3])
    rgb = torch.tanh(y[:, 3:6])
    xs = torch.arange(ww, dtype=x.dtype, device=x.device)
    ys = torch.arange(hh, dtype=x.dtype, device=x.device)[:, None]
    ix, iy = xs + flow[:, 0], ys + flow[:, 1]                   # [BK,H,W]
    frame = image_seq[:, -1].permute(0, 3, 1, 2).repeat_interleave(k, 0)
    warped = dmv3d.bilinear_border(net.q(frame), ix, iy)
    v = mask * warped + (1.0 - mask) * rgb
    return {"view": dmv3d.nhwc(v, b, k),
            "valid": dmv3d.in_bounds(ix, iy, hh, ww).reshape(b, k, hh, ww),
            "mask": mask.reshape(b, k, hh, ww)}


def loss(out, target, train_cfg):
    losses.require_zero(train_cfg, "ssim_weight", "smooth_weight")
    return train_cfg["l1_weight"] * losses.l1(out["view"], target) \
        + train_cfg["mask_weight"] * losses.mask_bce(out["mask"],
                                                      out["valid"])
