"""Plain bilinear grid sampling + appearance-flow warp (port of ops/sampling.py).

Plain PyTorch, gather-based: the correctness oracle for the hand-written
kernels in ``kernels/``. Conventions match the JAX package:
- images are NHWC at these public functions
- ``grid`` holds normalized (x, y) in [-1, 1]; x indexes width, y height
- ``align_corners=True``: -1/+1 map to corner pixel *centers*; ``False``:
  torch's default mapping
- ``padding_mode``: "zeros" (out-of-bounds reads 0) or "border" (clamp)
"""

from __future__ import annotations

import torch


def base_grid(height: int, width: int, dtype=torch.float32,
              device=None) -> torch.Tensor:
    """Identity pixel-coordinate grid [H, W, 2] holding (x, y)."""
    ys = torch.arange(height, dtype=dtype, device=device)
    xs = torch.arange(width, dtype=dtype, device=device)
    grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([grid_x, grid_y], dim=-1)


def normalize_coords(pix: torch.Tensor, height: int, width: int,
                     align_corners: bool = True) -> torch.Tensor:
    """Pixel (x, y) -> normalized [-1, 1] (x, y)."""
    x, y = pix[..., 0], pix[..., 1]
    if align_corners:
        x = 2.0 * x / (width - 1) - 1.0
        y = 2.0 * y / (height - 1) - 1.0
    else:
        x = (2.0 * x + 1.0) / width - 1.0
        y = (2.0 * y + 1.0) / height - 1.0
    return torch.stack([x, y], dim=-1)


def unnormalize_coords(grid: torch.Tensor, height: int, width: int,
                       align_corners: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalized grid -> continuous source pixel coords (ix, iy)."""
    x, y = grid[..., 0], grid[..., 1]
    if align_corners:
        ix = (x + 1.0) * 0.5 * (width - 1)
        iy = (y + 1.0) * 0.5 * (height - 1)
    else:
        ix = ((x + 1.0) * width - 1.0) * 0.5
        iy = ((y + 1.0) * height - 1.0) * 0.5
    return ix, iy


def grid_sample(image: torch.Tensor, grid: torch.Tensor, *,
                align_corners: bool = True,
                padding_mode: str = "zeros") -> torch.Tensor:
    """Bilinear sample ``image`` [N,H,W,C] at normalized ``grid`` [N,Ho,Wo,2].

    The counterpart of the JAX package's gather reference
    (``_grid_sample_jnp``): four floor/floor+1 taps, clamped indices, and in
    "zeros" mode each out-of-range tap multiplied by 0.
    """
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unknown padding_mode: {padding_mode}")
    n, h, w, c = image.shape
    ix, iy = unnormalize_coords(grid.to(torch.float32), h, w, align_corners)
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    x1, y1 = x0 + 1.0, y0 + 1.0
    wx1 = ix - x0
    wy1 = iy - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    flat = image.reshape(n, h * w, c)

    def gather(xi, yi):
        xc = xi.clamp(0, w - 1).to(torch.int64)
        yc = yi.clamp(0, h - 1).to(torch.int64)
        idx = (yc * w + xc).reshape(n, -1, 1).expand(-1, -1, c)
        vals = torch.gather(flat, 1, idx).reshape(*xi.shape, c)
        if padding_mode == "zeros":
            inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            vals = vals * inside[..., None].to(vals.dtype)
        return vals

    out = (
        gather(x0, y0) * (wx0 * wy0)[..., None]
        + gather(x1, y0) * (wx1 * wy0)[..., None]
        + gather(x0, y1) * (wx0 * wy1)[..., None]
        + gather(x1, y1) * (wx1 * wy1)[..., None]
    )
    return out.to(image.dtype)


def grid_sample_nchw(image: torch.Tensor, grid: torch.Tensor,
                     **kw) -> torch.Tensor:
    """Torch-layout convenience wrapper of ``grid_sample``: image
    [N,C,H,W] -> out [N,C,Ho,Wo]."""
    out = grid_sample(image.permute(0, 2, 3, 1), grid, **kw)
    return out.permute(0, 3, 1, 2)


def flow_warp(image: torch.Tensor, flow: torch.Tensor, *,
              padding_mode: str = "border") -> torch.Tensor:
    """Appearance-flow warp: sample ``image`` [N,H,W,C] at (base grid + flow).

    flow [N,H,W,2] is in *pixel* displacement units (x, y);
    out(p) = image(p + flow(p)), bilinear.
    """
    n, h, w, _ = image.shape
    coords = base_grid(h, w, device=flow.device)[None] + flow.to(torch.float32)
    grid = normalize_coords(coords, h, w, align_corners=True)
    return grid_sample(image, grid, align_corners=True,
                       padding_mode=padding_mode)


def in_bounds_mask(flow: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """1.0 where base+flow lands inside the image — supervises the mask head."""
    coords = base_grid(height, width, dtype=flow.dtype,
                       device=flow.device)[None] + flow
    x, y = coords[..., 0], coords[..., 1]
    inside = (x >= 0) & (x <= width - 1) & (y >= 0) & (y <= height - 1)
    return inside.to(flow.dtype)
