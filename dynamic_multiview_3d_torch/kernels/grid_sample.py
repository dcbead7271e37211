"""Fused flow warp + mask composite + validity (port of grid_sample_pallas.py).

This slice ports the forward of ``flow_warp_composite`` /
``_warp_composite_pix`` — the TPU kernel ``_fwd_composite_kernel`` — as a
hand-written CUDA kernel (``csrc/warp_composite.cu``; design and bound in
its header). The TPU formulation (tent-weight matmuls, the VMEM pixel-block
planner) does not carry over: the CUDA kernel gathers the four taps of each
output pixel directly.

``warp_composite_pix`` dispatches on the tensors' device: CPU tensors run
``warp_composite_pix_plain`` (plain PyTorch, the kernel's oracle, same
arithmetic in the same order); CUDA tensors launch the kernel or raise.
There is no backward yet: on CUDA with grad enabled, an input that requires
grad is refused rather than silently detached.
"""

from __future__ import annotations

import ctypes

import torch

from dynamic_multiview_3d_torch.kernels import _build
from dynamic_multiview_3d_torch.ops import sampling

_MAX_IMAGES = 65535          # the kernel's grid.y extent


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _taps(coord: torch.Tensor, size: int, padding_mode: str):
    """Clamped tap indices (i0, i1) and weights (w0, w1) of each coordinate,
    exactly as the kernel computes them."""
    hi = float(size - 1)
    if padding_mode == "border":
        coord = coord.clamp(0.0, hi)
    c0 = torch.floor(coord)
    c1 = c0 + 1.0
    w1 = coord - c0
    w0 = 1.0 - w1
    if padding_mode == "zeros":
        w0 = torch.where((c0 < 0) | (c0 > hi), 0.0, w0)
        w1 = torch.where((c1 < 0) | (c1 > hi), 0.0, w1)
    i0 = c0.clamp(0.0, hi).to(torch.int64)
    i1 = c1.clamp(0.0, hi).to(torch.int64)
    return i0, i1, w0, w1


def warp_composite_pix_plain(img_nchw, ix, iy, mask, rgb,
                             padding_mode="border", precision="exact"):
    """Plain PyTorch version of the kernel: same contract and arithmetic."""
    n, c, h, w = img_nchw.shape
    p = ix.shape[1]
    valid = ((ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)) \
        .to(torch.float32)
    x0, x1, wx0, wx1 = _taps(ix, w, padding_mode)
    y0, y1, wy0, wy1 = _taps(iy, h, padding_mode)
    flat = img_nchw.reshape(n, c, h * w)
    if precision == "fast":
        wy0, wy1 = _round_bf16(wy0), _round_bf16(wy1)
        flat = _round_bf16(flat)

    def tap(yi, xi):                                     # -> [N, C, P]
        idx = (yi * w + xi)[:, None, :].expand(n, c, p)
        return torch.gather(flat, 2, idx)

    wx0, wx1, wy0, wy1 = (t[:, None, :] for t in (wx0, wx1, wy0, wy1))
    t0 = wy0 * tap(y0, x0) + wy1 * tap(y1, x0)          # column x0
    t1 = wy0 * tap(y0, x1) + wy1 * tap(y1, x1)          # column x1
    warped = wx0 * t0 + wx1 * t1
    m = mask[:, None, :]
    view = m * warped + (1.0 - m) * rgb
    return view, warped, valid


def _check(img_nchw, ix, iy, mask, rgb, padding_mode, precision):
    if padding_mode not in ("border", "zeros"):
        raise ValueError(f"unknown padding_mode: {padding_mode!r}")
    if precision not in ("exact", "fast"):
        raise ValueError(f"unknown precision: {precision!r}")
    if img_nchw.dim() != 4:
        raise ValueError(f"img_nchw must be [N,C,H,W], got {tuple(img_nchw.shape)}")
    n, c, h, w = img_nchw.shape
    p = ix.shape[-1] if ix.dim() == 2 else -1
    shapes = {"ix": (ix, (n, p)), "iy": (iy, (n, p)), "mask": (mask, (n, p)),
              "rgb": (rgb, (n, c, p))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")
    for name, t in [("img_nchw", img_nchw), ("ix", ix), ("iy", iy),
                    ("mask", mask), ("rgb", rgb)]:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != img_nchw.device:
            raise ValueError(f"{name} is on {t.device}, img_nchw on "
                             f"{img_nchw.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _lib():
    lib = _build.load("warp_composite")
    fn = lib.dmv3d_warp_composite_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def warp_composite_pix(img_nchw, ix, iy, mask, rgb, padding_mode="border",
                       precision="exact"):
    """Fused (view, warped, valid) at pixel coordinates.

    img_nchw [N,C,H,W]; ix, iy, mask [N,P]; rgb [N,C,P]; all float32 and
    contiguous on one device. Returns view, warped [N,C,P] and valid [N,P]:
    view = mask * sample(img, ix, iy) + (1 - mask) * rgb; valid = 1 where
    (ix, iy) lands inside the image. ``precision`` "exact" is f32 throughout;
    "fast" rounds image values and y-tap weights to bf16 (the model default).
    Counts each kernel launch in ``warp_composite_pix.launches``.
    """
    _check(img_nchw, ix, iy, mask, rgb, padding_mode, precision)
    dev = img_nchw.device
    if dev.type == "cpu":
        return warp_composite_pix_plain(img_nchw, ix, iy, mask, rgb,
                                        padding_mode, precision)
    if dev.type != "cuda":
        raise ValueError(f"warp_composite_pix runs on cpu or cuda, not {dev}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (img_nchw, ix, iy, mask, rgb)):
        raise NotImplementedError(
            "warp_composite_pix has no backward kernel yet (it lands with the "
            "training slice); call it under torch.no_grad() or "
            "torch.inference_mode()")
    n, c, h, w = img_nchw.shape
    p = ix.shape[1]
    if n > _MAX_IMAGES:
        raise ValueError(f"at most {_MAX_IMAGES} images per launch, got {n}")
    view = torch.empty((n, c, p), dtype=torch.float32, device=dev)
    warped = torch.empty_like(view)
    valid = torch.empty((n, p), dtype=torch.float32, device=dev)
    fn = _lib()
    # the C entry launches on the current GPU: make it the tensors' GPU
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(img_nchw.data_ptr(), ix.data_ptr(), iy.data_ptr(),
                 mask.data_ptr(), rgb.data_ptr(), view.data_ptr(),
                 warped.data_ptr(), valid.data_ptr(), n, c, h, w, p,
                 int(padding_mode == "border"), int(precision == "fast"),
                 stream)
    if err != 0:
        raise RuntimeError(f"warp_composite kernel launch failed: CUDA error "
                           f"{err}")
    warp_composite_pix.launches += 1
    return view, warped, valid


warp_composite_pix.launches = 0


def _composite_nhwc(fn, image, flow, mask, rgb, padding_mode, precision):
    n, h, w, c = image.shape
    coords = sampling.base_grid(h, w, device=flow.device)[None] \
        + flow.to(torch.float32)
    img_nchw = image.to(torch.float32).permute(0, 3, 1, 2).contiguous()
    rgb_ncp = rgb.to(torch.float32).permute(0, 3, 1, 2).reshape(n, c, h * w) \
        .contiguous()
    view, warped, valid = fn(
        img_nchw, coords[..., 0].reshape(n, h * w).contiguous(),
        coords[..., 1].reshape(n, h * w).contiguous(),
        mask.to(torch.float32).reshape(n, h * w).contiguous(), rgb_ncp,
        padding_mode, precision)

    def back(x):
        return x.reshape(n, c, h, w).permute(0, 2, 3, 1)
    return back(view), back(warped), valid.reshape(n, h, w)


def flow_warp_composite(image, flow, mask, rgb, *, padding_mode="border",
                        precision="exact"):
    """Fused appearance-flow synthesis (NHWC):

        warped = bilinear(image, base_grid + flow)
        view   = mask * warped + (1 - mask) * rgb
        valid  = in-bounds(base_grid + flow)     # the mask-loss target

    image [N,H,W,C]; flow [N,H,W,2] (pixel units); mask [N,H,W,1];
    rgb [N,H,W,C] -> (view, warped [N,H,W,C], valid [N,H,W]), float32.
    Runs the kernel on CUDA tensors, the plain version on CPU tensors.
    """
    return _composite_nhwc(warp_composite_pix, image, flow, mask, rgb,
                           padding_mode, precision)


def flow_warp_composite_plain(image, flow, mask, rgb, *,
                              padding_mode="border", precision="exact"):
    """``flow_warp_composite`` through the plain version on any device."""
    return _composite_nhwc(warp_composite_pix_plain, image, flow, mask, rgb,
                           padding_mode, precision)
