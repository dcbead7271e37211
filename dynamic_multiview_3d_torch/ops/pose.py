"""Camera pose encoding + extrinsics/intrinsics math (port of ops/pose.py).

Conventions match the JAX package:
- pose vector: ``[azimuth, elevation, radius]`` (radians, radians, world units)
- extrinsics: world->camera, right-handed, camera looks down +z (OpenCV style)
- all functions broadcast over leading batch dims.

Everything here computes in float32 whatever the model's compute dtype: the
camera math is tiny but precision-critical (the reference forces f32 matmuls
for the same reason), so inputs are cast up front and the 3x3/4x4 products
are written out as elementwise sums rather than going through TF32 matmuls.
"""

from __future__ import annotations

import numbers

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def _like(x, ref: torch.Tensor) -> torch.Tensor:
    """``x`` (a number or a tensor) as float32 broadcast to ``ref``: a
    number is filled in on ``ref``'s device, with no host-to-device copy."""
    if isinstance(x, numbers.Number):
        return torch.full_like(ref, float(x))
    return _f32(x).to(ref.device).expand_as(ref)


def _bottom_row(top: torch.Tensor) -> torch.Tensor:
    """The rigid transform's last row (0, 0, 0, 1) for a top [..., 3, 4],
    filled in on its device (no host-to-device copy): [..., 1, 4]."""
    row = torch.zeros_like(top[..., :1, :])
    row[..., 3] = 1.0
    return row


def pose_to_features(pose: torch.Tensor) -> torch.Tensor:
    """(az, el, r) -> (sin az, cos az, sin el, cos el, r). [..., 3] -> [..., 5]."""
    pose = _f32(pose)
    az, el, r = pose[..., 0], pose[..., 1], pose[..., 2]
    return torch.stack(
        [torch.sin(az), torch.cos(az), torch.sin(el), torch.cos(el), r], dim=-1)


def encode_view_pair(src_pose: torch.Tensor, tgt_pose: torch.Tensor
                     ) -> torch.Tensor:
    """Relative view-change encoding: azimuth as a difference, elevation and
    radius absolutely for both views. [..., 3] x2 -> [..., 8]."""
    src_pose, tgt_pose = _f32(src_pose), _f32(tgt_pose)
    d_az = tgt_pose[..., 0] - src_pose[..., 0]
    return torch.stack(
        [
            torch.sin(d_az), torch.cos(d_az),
            torch.sin(src_pose[..., 1]), torch.cos(src_pose[..., 1]),
            torch.sin(tgt_pose[..., 1]), torch.cos(tgt_pose[..., 1]),
            src_pose[..., 2], tgt_pose[..., 2],
        ],
        dim=-1,
    )


def encode_pose(src_pose: torch.Tensor, tgt_pose: torch.Tensor,
                mode: str = "sincos") -> torch.Tensor:
    """Pose conditioning feature for the bottleneck.

    mode="sincos": relative angle encoding (8 dims).
    mode="mat":    flattened relative extrinsics tgt->src (12 dims, top 3x4).
    """
    if mode == "sincos":
        return encode_view_pair(src_pose, tgt_pose)
    if mode == "mat":
        t_src = look_at_extrinsics(src_pose)
        t_tgt = look_at_extrinsics(tgt_pose)
        rel = relative_transform(t_src, t_tgt)          # tgt cam -> src cam
        return rel[..., :3, :].reshape(*rel.shape[:-2], 12)
    raise ValueError(f"unknown pose mode: {mode}")


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[..., i, j] x [..., j] -> [..., i] in exact f32 (no TF32)."""
    return (m * v[..., None, :]).sum(-1)


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., i, j] x [..., j, k] -> [..., i, k] in exact f32 (no TF32)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def look_at_extrinsics(pose: torch.Tensor, center: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """World->camera 4x4 for a camera on a sphere looking at ``center``.

    pose [..., 3] = (azimuth, elevation, radius). Camera +z points at the
    center (OpenCV), +x right, +y down. Returns [..., 4, 4].
    """
    pose = _f32(pose)
    az, el, r = pose[..., 0], pose[..., 1], pose[..., 2]
    cos_el, sin_el = torch.cos(el), torch.sin(el)
    eye = torch.stack(
        [r * cos_el * torch.cos(az), r * cos_el * torch.sin(az), r * sin_el],
        dim=-1)
    if center is None:
        center = torch.zeros_like(eye)
    else:
        center = _f32(center).to(eye.device)
        eye = eye + center

    fwd = center - eye
    fwd = fwd / (torch.linalg.vector_norm(fwd, dim=-1, keepdim=True) + 1e-9)
    world_up = torch.zeros_like(fwd)
    world_up[..., 2] = 1.0
    right = torch.linalg.cross(fwd, world_up, dim=-1)
    right = right / (torch.linalg.vector_norm(right, dim=-1, keepdim=True)
                     + 1e-9)
    down = torch.linalg.cross(fwd, right, dim=-1)  # +y down: v grows downward

    rot = torch.stack([right, down, fwd], dim=-2)            # [..., 3, 3] rows
    trans = -_matvec(rot, eye)                               # [..., 3]
    top = torch.cat([rot, trans[..., :, None]], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def intrinsics_matrix(focal, cx, cy) -> torch.Tensor:
    """Pinhole K [..., 3, 3] from (broadcastable) focal length + principal point."""
    focal = _f32(focal)
    cx, cy = _like(cx, focal), _like(cy, focal)
    zero = torch.zeros_like(focal)
    one = torch.ones_like(focal)
    rows = [
        torch.stack([focal, zero, cx], dim=-1),
        torch.stack([zero, focal, cy], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def relative_transform(t_src_w2c: torch.Tensor, t_tgt_w2c: torch.Tensor
                       ) -> torch.Tensor:
    """Transform taking target-camera coords to source-camera coords.

    X_src = T_rel @ X_tgt with T_rel = T_src_w2c @ inv(T_tgt_w2c), using the
    closed-form rigid inverse (R^T, -R^T t) — no general 4x4 solve.
    """
    t_src_w2c, t_tgt_w2c = _f32(t_src_w2c), _f32(t_tgt_w2c)
    r_tgt = t_tgt_w2c[..., :3, :3]
    t_tgt = t_tgt_w2c[..., :3, 3]
    r_inv = r_tgt.transpose(-1, -2)
    t_inv = -_matvec(r_inv, t_tgt)
    inv_top = torch.cat([r_inv, t_inv[..., :, None]], dim=-1)
    t_tgt_inv = torch.cat([inv_top, _bottom_row(inv_top)], dim=-2)
    return _matmul(t_src_w2c, t_tgt_inv)
