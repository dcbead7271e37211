"""Depth unprojection + reprojection (port of ops/reproject.py).

Given a depth map in the *target* camera, camera intrinsics and the rigid
transform taking target-camera coords to source-camera coords, compute for
every target pixel its continuous source-pixel correspondence; sampling the
source image there synthesizes the target view geometrically.

The 3x3 products are written out as elementwise sums in f32 (no TF32), as
in ``ops/pose.py``: the reference forces f32 on this math.
"""

from __future__ import annotations

import torch

from dynamic_multiview_3d_torch.ops import sampling
from dynamic_multiview_3d_torch.ops.pose import _matvec


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate) inverse of batched 3x3 matrices [..., 3, 3].

    Not ``torch.linalg.inv``: the reference uses the adjugate (pure
    arithmetic, no LAPACK call), and the port computes the same products in
    the same order."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = f * g - d * i
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    adj = torch.stack([
        torch.stack([co_a, c * h - b * i, b * f - c * e], -1),
        torch.stack([co_b, a * i - c * g, c * d - a * f], -1),
        torch.stack([co_c, b * g - a * h, a * e - b * d], -1),
    ], -2)
    return adj / det[..., None, None]


def reproject_coords(depth: torch.Tensor, intrinsics: torch.Tensor,
                     t_tgt2src: torch.Tensor, eps: float = 1e-6
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pixel correspondences from the target view into the source view.

    depth      [N, H, W]  depth along +z in the target camera
    intrinsics [N, 3, 3]  shared pinhole K for both views
    t_tgt2src  [N, 4, 4]  rigid transform target-cam -> source-cam

    Returns (coords [N, H, W, 2] continuous source pixels (x, y),
             valid  [N, H, W]    1.0 where the reprojected depth > eps).
    A point at or behind the source camera divides by 1 instead of its z,
    so its coordinate stays finite (and so does its gradient).
    """
    n, h, w = depth.shape
    grid = sampling.base_grid(h, w, dtype=depth.dtype, device=depth.device)
    pix_h = torch.cat([grid, torch.ones_like(grid[..., :1])], -1)  # [H,W,3]

    k_inv = inv3x3(intrinsics)[:, None, None]                    # [N,1,1,3,3]
    rays = _matvec(k_inv, pix_h)                                 # [N,H,W,3]
    pts_tgt = rays * depth[..., None]                            # X_tgt

    rot = t_tgt2src[:, None, None, :3, :3]
    trans = t_tgt2src[:, None, None, :3, 3]
    pts_src = _matvec(rot, pts_tgt) + trans

    z = pts_src[..., 2]
    valid = (z > eps).to(depth.dtype)
    z_safe = torch.where(z > eps, z, torch.ones_like(z))
    proj = _matvec(intrinsics[:, None, None], pts_src / z_safe[..., None])
    return proj[..., :2], valid


def depth_reproject_sample(src_image: torch.Tensor, depth: torch.Tensor,
                           intrinsics: torch.Tensor, t_tgt2src: torch.Tensor,
                           *, padding_mode: str = "zeros"
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Synthesize the target view by sampling ``src_image`` at the
    reprojections: src_image [N, H, W, C] -> (view [N, H, W, C] zeroed where
    invalid, valid [N, H, W]). Plain bilinear sampling, differentiable in
    depth and image through autograd."""
    _, h, w, _ = src_image.shape
    coords, valid = reproject_coords(depth, intrinsics, t_tgt2src)
    grid = sampling.normalize_coords(coords, h, w, align_corners=True)
    out = sampling.grid_sample(src_image, grid, align_corners=True,
                               padding_mode=padding_mode)
    return out * valid[..., None].to(out.dtype), valid
