"""Multidepth synthesis with shared per-source heads: one depth map per
target pixel, reprojected into every source camera; the sources' samples
(bilinear, border padding) are blended by a softmax over per-source
confidences (a source behind the camera or out of bounds biased by -30),
and composited with an RGB guess by the mask. The mask's target is
whether some source sees the point in front and in bounds. Loss: L1 of
the view, ``mask_weight`` times the mask's cross-entropy, and
``geo_weight`` times the blended samples' L1 where the mask's target is 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import dmv3d, losses


def add_params(m, f_in, conv, dense):
    fs = m["src_head_features"]
    conv("decoder.heads_base", f_in, 4, 3)
    conv("decoder.srchead_trunk", f_in, fs, 3)
    dense("decoder.srchead_emb", dmv3d.POSE_DIMS[m["pose_mode"]], fs)
    dense("decoder.srchead_pose", fs, fs)
    conv("decoder.srchead_mix", fs, fs, 1)
    conv("decoder.srchead_out", fs, 1, 1)
    conv("decoder.depth_head", f_in, 1, 3)


def pose_code(src_poses, tgt_poses):
    """Each source's pose against each target's: [B*K, T, 8]."""
    k = tgt_poses.shape[1]
    src = src_poses.repeat_interleave(k, 0)                     # [BK,T,3]
    return dmv3d.encode_view_pair(
        src, tgt_poses.reshape(-1, 1, 3).expand_as(src))


def view(net, x, code, image_seq, src_poses, tgt_poses):
    b, t, hh, ww, _ = image_seq.shape
    k = tgt_poses.shape[1]
    n = b * k
    base = net.conv("decoder.heads_base", x)
    mask, rgb = torch.sigmoid(base[:, 0:1]), torch.tanh(base[:, 1:4])
    trunk = net.conv("decoder.srchead_trunk", x)                # [N,F,H,W]
    emb = net.dense("decoder.srchead_pose",
                    F.relu(net.dense("decoder.srchead_emb", code)))
    u = F.relu(trunk[:, None] + emb[:, :, :, None, None]).flatten(0, 1)
    u = F.relu(net.conv("decoder.srchead_mix", u))
    conf = net.conv("decoder.srchead_out", u).reshape(n, t, hh, ww)
    depth = F.softplus(net.conv("decoder.depth_head", x))[:, 0] + 0.1
    # target camera (b, k) -> source camera (b, t)
    rel = dmv3d.relative_transform(
        dmv3d.look_at(src_poses)[:, None].expand(b, k, t, 4, 4),
        dmv3d.look_at(tgt_poses)[:, :, None].expand(b, k, t, 4, 4))
    ix, iy, z_ok = dmv3d.reproject(depth.reshape(b, k, 1, hh, ww), rel,
                                   float(max(hh, ww)), (ww - 1) / 2.0,
                                   (hh - 1) / 2.0)              # [B,K,T,H,W]
    valid = dmv3d.in_bounds(ix, iy, hh, ww)
    logits = conf.reshape(b, k, t, hh, ww) + (z_ok - 1.0) * 30.0 \
        + (valid - 1.0) * 30.0
    wts = torch.softmax(logits, dim=2)
    multi = 0.0
    for ti in range(t):
        img = image_seq[:, ti].permute(0, 3, 1, 2).repeat_interleave(k, 0)
        sample = dmv3d.bilinear_border(net.q(img),
                                       ix[:, :, ti].flatten(0, 1),
                                       iy[:, :, ti].flatten(0, 1))
        multi = multi + wts[:, :, ti].flatten(0, 1)[:, None] * sample
    v = mask * multi + (1.0 - mask) * rgb
    return {"view": dmv3d.nhwc(v, b, k),
            "valid": (z_ok * valid).amax(2),
            "mask": mask.reshape(b, k, hh, ww),
            "geo_view": dmv3d.nhwc(multi, b, k)}


def loss(out, target, train_cfg):
    losses.require_zero(train_cfg, "ssim_weight", "smooth_weight")
    return train_cfg["l1_weight"] * losses.l1(out["view"], target) \
        + train_cfg["mask_weight"] * losses.mask_bce(out["mask"],
                                                      out["valid"]) \
        + train_cfg["geo_weight"] * losses.masked_l1(out["geo_view"],
                                                     target, out["valid"])
