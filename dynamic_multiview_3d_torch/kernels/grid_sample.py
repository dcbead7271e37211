"""Bilinear sampling at pixel coordinates (port of grid_sample_pallas.py).

Ports two ops with their custom VJPs:

- ``flow_warp_composite`` / ``_warp_composite_pix``, the fused flow warp +
  mask composite + validity: the forward is the TPU kernel
  ``_fwd_composite_kernel`` as a hand-written CUDA kernel
  (``csrc/warp_composite.cu``), the backward is ``_wc_bwd`` (the chain rule
  through the composite) around ``_bwd_kernel`` (the sampler's backward),
  as one CUDA kernel (``csrc/warp_composite_bwd.cu``);
- ``sample_pixel_coords``, the plain sampler behind the public
  ``grid_sample`` and ``flow_warp``: the forward is ``_fwd_kernel`` as
  ``csrc/sample.cu``, the backward ``_sample_bwd`` around ``_bwd_kernel``,
  i.e. the no-composite launch of ``csrc/warp_composite_bwd.cu``.

Design and bound are in each source's header. The TPU formulation
(tent-weight matmuls, the VMEM pixel-block planner) does not carry over:
each CUDA thread handles the four taps of one output pixel directly. Every
kernel here reads channels-last images, three channels ``staged`` as
[N,H,W,4] (one 16-byte load per tap): the wrappers take contiguous,
channels-last or staged images and, on CUDA, copy any other into that
layout once (``_build.stage``); the autograd ops keep the staged image for
their backward. Flow synthesis hands ``warp_composite_pix`` one frame per
example for its K targets (N / K frames for N targets, target n reads
frame n // K); depth synthesis hands ``sample_pixel_coords`` the same
frames, each sampled at its K targets' pixels. Both get the model's NHWC
frames as a channels-last view, with no copy per target.

``warp_composite_pix`` and ``sample_pixel_coords`` are
``torch.autograd.Function``s on either device whose forwards call the
registered operators ``dmv3d::warp_composite_fwd`` and
``dmv3d::sample_fwd`` (``_build``: traced by ``torch.export``, served by
``serving.py``). On CPU tensors their forwards and backwards are the
plain PyTorch versions
(``warp_composite_pix_plain``, ``warp_composite_pix_bwd_plain``,
``sample_pixel_coords_plain``, ``sample_pixel_coords_bwd_plain``), the
kernels' oracles, written out by hand with the kernels' arithmetic in the
kernels' order; on CUDA tensors each launches its kernel or raises. The
backward is not autograd through the plain forward: at a coordinate exactly
on the far edge that would give 0 where the reference's floor-tap
subgradient gives ``-v(edge)``, and in "fast" mode it would round the
operands of the forward instead of those of the reference's backward.
"""

from __future__ import annotations

import torch

from dynamic_multiview_3d_torch.kernels import _build
from dynamic_multiview_3d_torch.ops import sampling

def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _taps(coord: torch.Tensor, size: int, padding_mode: str):
    """Clamped tap indices (i0, i1) and weights (w0, w1) of each coordinate,
    exactly as the kernels compute them."""
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


def in_bounds(ix: torch.Tensor, iy: torch.Tensor, h: int, w: int):
    """1.0 where the unclamped coordinate (ix, iy) lies in the h x w image,
    else 0.0 (``bilinear.cuh``'s ``in_bounds``)."""
    return ((ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)) \
        .to(torch.float32)


def tap_grads(coord: torch.Tensor, size: int, padding_mode: str):
    """d w0 / d coord and d w1 / d coord under the reference's floor-tap
    subgradient (``_tent_grad_t``): -1 and +1 where the tap lies in the
    image, else 0; in border mode both are 0 where the unclamped coordinate
    is outside [0, size - 1]."""
    hi = float(size - 1)
    inside = (coord >= 0) & (coord <= hi)
    if padding_mode == "border":
        coord = coord.clamp(0.0, hi)
    c0 = torch.floor(coord)
    u0 = torch.where((c0 >= 0) & (c0 <= hi), -1.0, 0.0)
    u1 = torch.where((c0 + 1.0 >= 0) & (c0 + 1.0 <= hi), 1.0, 0.0)
    if padding_mode == "border":
        u0 = torch.where(inside, u0, 0.0)
        u1 = torch.where(inside, u1, 0.0)
    return u0, u1


def channel_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of [N, C, P] over C, from 0 in channel order (the kernel's)."""
    acc = torch.zeros_like(x[:, 0])
    for ch in range(x.shape[1]):
        acc = acc + x[:, ch]
    return acc


def per_target(img_nchw, n):
    """The image of each of the n targets: the N / K frames of
    ``img_nchw`` repeated K times each (no copy where K = 1)."""
    k = n // img_nchw.shape[0]
    return img_nchw if k == 1 else img_nchw.repeat_interleave(k, dim=0)


def per_frame(d_img, n_src):
    """A per-target image gradient [N, C, H*W] summed over each frame's K
    targets -> [N / K, C, H*W] (as is where K = 1)."""
    n = d_img.shape[0]
    return d_img if n == n_src else \
        d_img.reshape(n_src, n // n_src, *d_img.shape[1:]).sum(1)


def sample_taps(img_nchw, ix, iy, padding_mode, precision):
    """Everything the plain forwards and backwards (here and in
    ``kernels/multiflow.py``) share: tap indices, weights ([N, 1, P]), the
    four tap values, the y-lerped columns t0, t1 and the sample ``warped``
    ([N, C, P]), rounded as "fast" rounds them."""
    n, c, h, w = img_nchw.shape
    p = ix.shape[1]
    x0, x1, wx0, wx1 = _taps(ix, w, padding_mode)
    y0, y1, wy0, wy1 = _taps(iy, h, padding_mode)
    flat = img_nchw.reshape(n, c, h * w)
    wy0s, wy1s = wy0, wy1                # the y-weights of the samples
    if precision == "fast":
        wy0s, wy1s = _round_bf16(wy0), _round_bf16(wy1)
        flat = _round_bf16(flat)

    def tap(yi, xi):                                     # -> [N, C, P]
        idx = (yi * w + xi)[:, None, :].expand(n, c, p)
        return torch.gather(flat, 2, idx)

    wx0, wx1, wy0, wy1, wy0s, wy1s = (
        t[:, None, :] for t in (wx0, wx1, wy0, wy1, wy0s, wy1s))
    v00, v10, v01, v11 = tap(y0, x0), tap(y1, x0), tap(y0, x1), tap(y1, x1)
    t0 = wy0s * v00 + wy1s * v10                        # column x0
    t1 = wy0s * v01 + wy1s * v11                        # column x1
    return dict(x=(x0, x1), y=(y0, y1), wx=(wx0, wx1), wy=(wy0, wy1),
                v=(v00, v10, v01, v11), t=(t0, t1), h=h, w=w,
                warped=wx0 * t0 + wx1 * t1)


def warp_composite_pix_plain(img_nchw, ix, iy, mask, rgb,
                             padding_mode="border", precision="exact"):
    """Plain PyTorch version of the forward kernel: same contract (N / K
    frames for N targets: the frames are repeated per target) and
    arithmetic. Autograd through it differentiates its gathers, which is
    not the reference's backward; ``warp_composite_pix`` is the
    differentiable op."""
    h, w = img_nchw.shape[2:]
    valid = in_bounds(ix, iy, h, w)
    warped = sample_taps(per_target(img_nchw, ix.shape[0]), ix, iy,
                         padding_mode, precision)["warped"]
    m = mask[:, None, :]
    view = m * warped + (1.0 - m) * rgb
    return view, warped, valid


def warp_composite_pix_bwd_plain(img_nchw, ix, iy, mask, rgb, d_view,
                                 d_warped=None, padding_mode="border",
                                 precision="exact", need_img=True):
    """Plain PyTorch version of the backward kernel: what ``_wc_bwd`` and
    ``_bwd_kernel`` compute, in the kernel's order.

    d_view and d_warped (None: zero) are the cotangents of view and warped,
    [N, C, P]. Returns (d_img or None, d_ix, d_iy, d_mask, d_rgb):

        ds     = d_view * mask + d_warped          # the sample's cotangent
        d_mask = sum_c d_view * (warped - rgb)
        d_rgb  = d_view * (1 - mask)
        d_ix   = sum_c ds * (u_x0 * t0 + u_x1 * t1)            # t: y-lerped
        d_iy   = sum_c ds * (w_x0 * (u_y0 v00 + u_y1 v10)      #    columns
                             + w_x1 * (u_y0 v01 + u_y1 v11))
        d_img  = the four taps' scatter-add of (w_y * ds) * w_x

    with u the floor-tap subgradient (``tap_grads``). "fast" rounds what
    the reference's fast backward rounds: the image and the y-weights of
    t0/t1 (as the forward does; u is exact in bf16, w_x stays f32 in d_iy),
    and in d_img both factors, bf16(w_y * ds) x bf16(w_x), where the
    forward keeps w_x in f32. With N / K frames for N targets, d_img is
    [N / K, C, H, W], each frame's gradient summed over its K targets.
    """
    n_src, c, h, w = img_nchw.shape
    s = sample_taps(per_target(img_nchw, ix.shape[0]), ix, iy, padding_mode,
                    precision)

    m = mask[:, None, :]
    ds = d_view * m
    if d_warped is not None:
        ds = ds + d_warped
    d_rgb = d_view * (1.0 - m)
    d_mask = channel_sum(d_view * (s["warped"] - rgb))
    d_img, d_ix, d_iy = sampler_grads(s, ix, iy, ds, padding_mode,
                                      precision, need_img)
    if d_img is not None:
        d_img = per_frame(d_img, n_src).reshape(n_src, c, h, w)
    return d_img, d_ix, d_iy, d_mask, d_rgb


def sampler_grads(s: dict, ix, iy, ds, padding_mode, precision, need_img):
    """The sampler's backward (the TPU's ``_bwd_kernel``) for the samples
    ``s`` (``sample_taps``'s entries, of an image of ``s["h"]`` x
    ``s["w"]``) and their cotangent ``ds`` [N, C, P]: (d_img [N, C, H*W] or
    None, d_ix, d_iy [N, P]) with the floor-tap subgradient, in the
    kernels' order."""
    (wx0, wx1), (t0, t1) = s["wx"], s["t"]
    v00, v10, v01, v11 = s["v"]
    h, w = s["h"], s["w"]
    ux0, ux1 = (u[:, None, :] for u in tap_grads(ix, w, padding_mode))
    uy0, uy1 = (u[:, None, :] for u in tap_grads(iy, h, padding_mode))
    sx = ux0 * t0 + ux1 * t1
    sy = wx0 * (uy0 * v00 + uy1 * v10) + wx1 * (uy0 * v01 + uy1 * v11)
    d_ix = channel_sum(sx * ds)
    d_iy = channel_sum(sy * ds)
    d_img = scatter_taps(s, ds, h, w, precision == "fast") \
        if need_img else None
    return d_img, d_ix, d_iy


def scatter_taps(s: dict, ds: torch.Tensor, h: int, w: int, fast: bool):
    """The image gradient [N, C, H*W] of samples ``s`` (``sample_taps``'s
    entries) with cotangent ``ds`` [N, C, P]: the four taps' scatter-add of
    (w_y * ds) * w_x; "fast" rounds both factors to bf16, as the
    reference's fast backward does."""
    (wx0, wx1), (wy0, wy1) = s["wx"], s["wy"]
    (x0, x1), (y0, y1) = s["x"], s["y"]
    a0, a1 = wy0 * ds, wy1 * ds
    bx0, bx1 = wx0, wx1
    if fast:
        a0, a1 = _round_bf16(a0), _round_bf16(a1)
        bx0, bx1 = _round_bf16(wx0), _round_bf16(wx1)
    n, c, p = ds.shape
    d_img = torch.zeros((n, c, h * w), dtype=torch.float32, device=ds.device)
    for a, yi in ((a0, y0), (a1, y1)):
        for b, xi in ((bx0, x0), (bx1, x1)):
            idx = (yi * w + xi)[:, None, :].expand(n, c, p)
            d_img.scatter_add_(2, idx, a * b)
    return d_img


def _check(img_nchw, ix, iy, mask, rgb, padding_mode, precision,
           shared=True, **grads):
    """Modes, and shapes, dtype, device and layout of the forward's inputs
    and of any cotangent given by name ([N, C, P] each; N the rows of ix);
    a mask, rgb or cotangent of None (the plain sampler has no mask or
    rgb) is skipped. All contiguous, except the image, which may also be
    channels-last or staged, and holds N / K frames for some whole K where
    ``shared`` (else one per row of ix)."""
    if padding_mode not in ("border", "zeros"):
        raise ValueError(f"unknown padding_mode: {padding_mode!r}")
    if precision not in ("exact", "fast"):
        raise ValueError(f"unknown precision: {precision!r}")
    if img_nchw.dim() != 4 or ix.dim() != 2:
        raise ValueError(f"img_nchw must be [N/K,C,H,W] and ix [N,P], got "
                         f"{tuple(img_nchw.shape)}, {tuple(ix.shape)}")
    n_src, c, h, w = img_nchw.shape
    n, p = ix.shape
    if n_src == 0 or n % n_src or (not shared and n != n_src):
        raise ValueError(f"{n} targets do not share {n_src} frames evenly"
                         if shared else f"{n} rows of coordinates for "
                         f"{n_src} images")
    tensors = {"img_nchw": (img_nchw, (n_src, c, h, w)), "ix": (ix, (n, p)),
               "iy": (iy, (n, p)), "mask": (mask, (n, p)),
               "rgb": (rgb, (n, c, p))}
    tensors.update({k: (t, (n, c, p)) for k, t in grads.items()})
    # one grid.y row per target: check_inputs bounds ix's first dimension
    _build.check_inputs("the bilinear sampler", ix, tensors, ("img_nchw",))


def _image_grad(img_nchw):
    """A zeroed image gradient for the kernels' atomics: channels-last
    [N, C, H, W] (its memory [N, H, W, C])."""
    n, c, h, w = img_nchw.shape
    return img_nchw.new_zeros((n, h, w, c)).movedim(-1, 1)


def _as_layout_of(d_img, img_nchw):
    """The kernels' channels-last image gradient, contiguous where the
    caller's image is."""
    return d_img.contiguous() if img_nchw.is_contiguous() else d_img


def _modes(padding_mode, precision):
    """The C entries' mode ints: border, fast."""
    return int(padding_mode == "border"), int(precision == "fast")


@torch.library.custom_op("dmv3d::warp_composite_fwd", mutates_args=(),
                         device_types="cpu")
def warp_composite_fwd(img_nchw: torch.Tensor, ix: torch.Tensor,
                       iy: torch.Tensor, mask: torch.Tensor,
                       rgb: torch.Tensor, padding_mode: str, precision: str
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward of ``warp_composite_pix`` as an operator: (view, warped,
    valid), inputs checked by the wrapper. Its CPU implementation is the
    plain version, its CUDA one the kernel (the image staged,
    ``_build.stage``; counted in ``warp_composite_pix.launches``)."""
    _build.check_aligned(img_nchw, "img_nchw")
    return warp_composite_pix_plain(img_nchw, ix, iy, mask, rgb,
                                    padding_mode, precision)


@warp_composite_fwd.register_kernel("cuda")
def _warp_composite_fwd_cuda(img_nchw, ix, iy, mask, rgb, padding_mode,
                             precision):
    n_src, c, h, w = img_nchw.shape
    n, p = ix.shape
    dev = img_nchw.device
    frames = _build.stage(img_nchw)
    _build.check_aligned(frames, "img_nchw")
    view = torch.empty((n, c, p), dtype=torch.float32, device=dev)
    warped = torch.empty_like(view)
    valid = torch.empty((n, p), dtype=torch.float32, device=dev)
    fn = _build.entry("warp_composite", "dmv3d_warp_composite_fwd", 8, 8)
    _build.launch(fn, "warp_composite", dev,
                  [_build.ptr(t) for t in (frames, ix, iy, mask, rgb, view,
                                           warped, valid)],
                  (n, c, h, w, p, n // n_src,
                   *_modes(padding_mode, precision)))
    warp_composite_pix.launches += 1
    return view, warped, valid


@warp_composite_fwd.register_fake
def _(img_nchw, ix, iy, mask, rgb, padding_mode, precision):
    view = ix.new_empty((ix.shape[0], img_nchw.shape[1], ix.shape[1]))
    return view, torch.empty_like(view), torch.empty_like(ix)


def warp_composite_pix_bwd(img_nchw, ix, iy, mask, rgb, d_view,
                           d_warped=None, padding_mode="border",
                           precision="exact", need_img=True):
    """The backward of ``warp_composite_pix``: (d_img or None, d_ix, d_iy,
    d_mask, d_rgb) for the cotangents d_view and d_warped (None: zero),
    [N, C, P] float32 and contiguous like the forward's inputs (the image
    N / K frames, contiguous, channels-last or staged). CPU tensors run
    ``warp_composite_pix_bwd_plain``; CUDA tensors launch the kernel
    (d_img only when ``need_img``: zeroed, then scatter-added with atomics,
    one gradient per frame summed over its K targets, contiguous where the
    image is, else channels-last) or raise. Counts each launch of the
    kernel in ``warp_composite_pix_bwd.launches``
    (``sample_pixel_coords_bwd``'s no-composite launches included), the
    launches that computed d_img in ``.img_launches`` and those with the
    composite in ``.composite_launches``."""
    _check(img_nchw, ix, iy, mask, rgb, padding_mode, precision,
           d_view=d_view, d_warped=d_warped)
    _build.check_aligned(img_nchw, "img_nchw")
    if img_nchw.device.type == "cpu":
        return warp_composite_pix_bwd_plain(
            img_nchw, ix, iy, mask, rgb, d_view, d_warped, padding_mode,
            precision, need_img)
    d_ix = torch.empty_like(ix)
    d_iy = torch.empty_like(ix)
    d_mask = torch.empty_like(ix)
    d_rgb = torch.empty_like(d_view)
    d_img = _image_grad(img_nchw) if need_img else None
    _launch_bwd(img_nchw, ix, iy, mask, rgb, d_view, d_warped, d_img, d_ix,
                d_iy, d_mask, d_rgb, padding_mode, precision)
    if need_img:
        d_img = _as_layout_of(d_img, img_nchw)
    return d_img, d_ix, d_iy, d_mask, d_rgb


def _launch_bwd(img_nchw, ix, iy, mask, rgb, d_view, d_warped, d_img, d_ix,
                d_iy, d_mask, d_rgb, padding_mode, precision):
    """One launch of ``csrc/warp_composite_bwd.cu`` (a null mask: the
    no-composite launch) on the image staged (``_build.stage``), d_img (or
    None) channels-last; counted in ``warp_composite_pix_bwd``."""
    n_src, c, h, w = img_nchw.shape
    n, p = ix.shape
    fn = _build.entry("warp_composite_bwd", "dmv3d_warp_composite_bwd", 12,
                      8)
    _build.launch(fn, "warp_composite_bwd", img_nchw.device,
                  [_build.ptr(t) for t in (_build.stage(img_nchw), ix, iy,
                                           mask, rgb, d_view, d_warped,
                                           d_img, d_ix, d_iy, d_mask,
                                           d_rgb)],
                  (n, c, h, w, p, n // n_src,
                   *_modes(padding_mode, precision)))
    warp_composite_pix_bwd.launches += 1
    warp_composite_pix_bwd.img_launches += int(d_img is not None)
    warp_composite_pix_bwd.composite_launches += int(mask is not None)


warp_composite_pix_bwd.launches = 0
warp_composite_pix_bwd.img_launches = 0
warp_composite_pix_bwd.composite_launches = 0


class _WarpComposite(torch.autograd.Function):
    """``_warp_composite_pix``'s custom VJP around ``dmv3d::
    warp_composite_fwd``: valid has no gradient, a cotangent autograd
    leaves as None is zero, and d_img is computed only when the image
    requires grad (on the model's path it never does). On CUDA the image
    is staged once (``_build.stage``) and kept so for the backward."""

    @staticmethod
    def forward(ctx, img_nchw, ix, iy, mask, rgb, padding_mode, precision):
        ctx.set_materialize_grads(False)
        ctx.modes = (padding_mode, precision)
        if img_nchw.is_cuda:
            img_nchw = _build.stage(img_nchw)
        ctx.save_for_backward(img_nchw, ix, iy, mask, rgb)
        view, warped, valid = warp_composite_fwd(img_nchw, ix, iy, mask,
                                                 rgb, padding_mode, precision)
        ctx.mark_non_differentiable(valid)
        return view, warped, valid

    @staticmethod
    def backward(ctx, d_view, d_warped, _d_valid):
        if d_view is None and d_warped is None:
            return (None,) * 7
        img_nchw, ix, iy, mask, rgb = ctx.saved_tensors
        # the model's outputs are permuted views: their cotangents may be too
        d_view = (torch.zeros_like(rgb) if d_view is None
                  else d_view.contiguous())
        if d_warped is not None:
            d_warped = d_warped.contiguous()
        grads = warp_composite_pix_bwd(
            img_nchw, ix, iy, mask, rgb, d_view, d_warped, *ctx.modes,
            need_img=ctx.needs_input_grad[0])
        return grads + (None, None)


def warp_composite_pix(img_nchw, ix, iy, mask, rgb, padding_mode="border",
                       precision="exact"):
    """Fused (view, warped, valid) at pixel coordinates, differentiable in
    img_nchw, ix, iy, mask and rgb (valid has no gradient).

    img_nchw [N/K,C,H,W]: N / K frames for the N targets, target n reads
    frame n // K (K = 1: one image per target), contiguous, channels-last
    (the kernels' layout; the model's NHWC frames permuted, no copy) or
    ``staged``; ix, iy, mask [N,P]; rgb [N,C,P]; all float32 on one device,
    the others contiguous. On CUDA the image is copied into the kernels'
    layout where it is not in it (``_build.stage``). Returns view, warped
    [N,C,P] and valid [N,P]: view = mask * sample(img, ix, iy) + (1 - mask)
    * rgb; valid = 1 where (ix, iy) lands inside the image. The image's
    gradient is one per frame, summed over its K targets. ``precision``
    "exact" is f32 throughout; "fast" rounds image values and y-tap weights
    to bf16 (the model default).
    Counts each forward kernel launch in ``warp_composite_pix.launches``;
    the backward counts in ``warp_composite_pix_bwd.launches``.
    """
    _check(img_nchw, ix, iy, mask, rgb, padding_mode, precision)
    return _WarpComposite.apply(img_nchw, ix, iy, mask, rgb, padding_mode,
                                precision)


warp_composite_pix.launches = 0


def _composite_nhwc(fn, image, flow, mask, rgb, padding_mode, precision):
    n, h, w, c = image.shape
    coords = sampling.base_grid(h, w, device=flow.device)[None] \
        + flow.to(torch.float32)
    img_nchw = image.to(torch.float32).contiguous().permute(0, 3, 1, 2)
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
    rgb [N,H,W,C] -> (view, warped [N,H,W,C], valid [N,H,W]), float32,
    differentiable in image, flow, mask and rgb. Runs the kernels on CUDA
    tensors, the plain versions on CPU tensors.
    """
    return _composite_nhwc(warp_composite_pix, image, flow, mask, rgb,
                           padding_mode, precision)


def flow_warp_composite_plain(image, flow, mask, rgb, *,
                              padding_mode="border", precision="exact"):
    """``flow_warp_composite`` through the plain forward on any device (no
    custom backward: for comparing forwards)."""
    return _composite_nhwc(warp_composite_pix_plain, image, flow, mask, rgb,
                           padding_mode, precision)


# ------------------------------------------------------------ plain sampler
def sample_pixel_coords_plain(img_nchw, ix, iy, padding_mode="zeros",
                              precision="exact"):
    """Plain PyTorch version of ``csrc/sample.cu``: the bilinear sample
    [N, C, P] of ``img_nchw`` [N, C, H, W] at pixel coordinates ix, iy
    [N, P], with the kernel's arithmetic (``sample_taps``)."""
    return sample_taps(img_nchw, ix, iy, padding_mode, precision)["warped"]


def sample_pixel_coords_bwd_plain(img_nchw, ix, iy, dout,
                                  padding_mode="zeros", precision="exact",
                                  need_img=True):
    """Plain PyTorch version of the no-composite launch of
    ``csrc/warp_composite_bwd.cu``: what ``_sample_bwd`` and ``_bwd_kernel``
    compute for the cotangent ``dout`` [N, C, P] of the sample. Returns
    (d_img [N, C, H, W] or None, d_ix, d_iy)."""
    n, c, h, w = img_nchw.shape
    s = sample_taps(img_nchw, ix, iy, padding_mode, precision)
    d_img, d_ix, d_iy = sampler_grads(s, ix, iy, dout, padding_mode,
                                      precision, need_img)
    return (None if d_img is None else d_img.reshape(n, c, h, w), d_ix,
            d_iy)


@torch.library.custom_op("dmv3d::sample_fwd", mutates_args=(),
                         device_types="cpu")
def sample_fwd(img_nchw: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor,
               padding_mode: str, precision: str) -> torch.Tensor:
    """The forward of ``sample_pixel_coords`` as an operator, inputs
    checked by the wrapper. Its CPU implementation is the plain version,
    its CUDA one the kernel (the image staged, ``_build.stage``; counted in
    ``sample_pixel_coords.launches``)."""
    _build.check_aligned(img_nchw, "img_nchw")
    return sample_pixel_coords_plain(img_nchw, ix, iy, padding_mode,
                                     precision)


@sample_fwd.register_kernel("cuda")
def _sample_fwd_cuda(img_nchw, ix, iy, padding_mode, precision):
    n, c, h, w = img_nchw.shape
    p = ix.shape[1]
    out = torch.empty((n, c, p), dtype=torch.float32, device=img_nchw.device)
    frames = _build.stage(img_nchw)
    _build.check_aligned(frames, "img_nchw")
    fn = _build.entry("sample", "dmv3d_sample_fwd", 4, 7)
    _build.launch(fn, "sample", img_nchw.device,
                  [_build.ptr(t) for t in (frames, ix, iy, out)],
                  (n, c, h, w, p, *_modes(padding_mode, precision)))
    sample_pixel_coords.launches += 1
    return out


@sample_fwd.register_fake
def _(img_nchw, ix, iy, padding_mode, precision):
    return ix.new_empty((ix.shape[0], img_nchw.shape[1], ix.shape[1]))


def sample_pixel_coords_bwd(img_nchw, ix, iy, dout, padding_mode="zeros",
                            precision="exact", need_img=True):
    """The backward of ``sample_pixel_coords``: (d_img or None, d_ix, d_iy)
    for the cotangent ``dout`` [N, C, P] of the sample, float32 and
    contiguous like the forward's inputs (the image contiguous,
    channels-last or staged). CPU tensors run
    ``sample_pixel_coords_bwd_plain``; CUDA tensors launch site #3's kernel
    without its composite (counted in ``warp_composite_pix_bwd``; the image
    staged as for the forward, d_img contiguous where the image is, else
    channels-last) or raise."""
    _check(img_nchw, ix, iy, None, None, padding_mode, precision, False,
           dout=dout)
    _build.check_aligned(img_nchw, "img_nchw")
    if img_nchw.device.type == "cpu":
        return sample_pixel_coords_bwd_plain(img_nchw, ix, iy, dout,
                                             padding_mode, precision,
                                             need_img)
    d_ix = torch.empty_like(ix)
    d_iy = torch.empty_like(ix)
    d_img = _image_grad(img_nchw) if need_img else None
    _launch_bwd(img_nchw, ix, iy, None, None, None, dout, d_img, d_ix, d_iy,
                None, None, padding_mode, precision)
    if need_img:
        d_img = _as_layout_of(d_img, img_nchw)
    return d_img, d_ix, d_iy


class _SamplePixel(torch.autograd.Function):
    """``sample_pixel_coords``'s custom VJP (the reference's
    ``_sample_bwd``) around ``dmv3d::sample_fwd``: d_img is computed only
    when the image requires grad. On CUDA the image is staged once
    (``_build.stage``) and kept so for the backward."""

    @staticmethod
    def forward(ctx, img_nchw, ix, iy, padding_mode, precision):
        ctx.modes = (padding_mode, precision)
        if img_nchw.is_cuda:
            img_nchw = _build.stage(img_nchw)
        ctx.save_for_backward(img_nchw, ix, iy)
        return sample_fwd(img_nchw, ix, iy, padding_mode, precision)

    @staticmethod
    def backward(ctx, dout):
        img_nchw, ix, iy = ctx.saved_tensors
        grads = sample_pixel_coords_bwd(img_nchw, ix, iy, dout.contiguous(),
                                        *ctx.modes,
                                        need_img=ctx.needs_input_grad[0])
        return grads + (None, None)


def sample_pixel_coords(img_nchw, ix, iy, padding_mode="zeros",
                        precision="exact"):
    """Bilinear sample [N, C, P] of ``img_nchw`` [N, C, H, W] at pixel
    coordinates ix, iy [N, P] (float32, one device; the coordinates
    contiguous, the image contiguous or channels-last, the kernel's layout,
    into which a contiguous image is copied on CUDA; a 3-channel image is
    staged as [N, H, W, 4] either way), differentiable in the
    image and the coordinates. P need not be H*W: depth synthesis samples
    each example's frame at its K targets' pixels, P = K*H*W. ``padding_mode``
    "zeros" (a tap outside the image reads 0) or "border" (the coordinate
    is clamped into the image); ``precision`` "exact" is f32 throughout,
    "fast" rounds image values and y-tap weights to bf16. Counts each
    forward kernel launch in ``sample_pixel_coords.launches``; the backward
    counts in ``warp_composite_pix_bwd.launches``."""
    _check(img_nchw, ix, iy, None, None, padding_mode, precision, False)
    return _SamplePixel.apply(img_nchw, ix, iy, padding_mode, precision)


sample_pixel_coords.launches = 0


def grid_sample(image, grid, *, align_corners=True, padding_mode="zeros",
                precision="exact"):
    """Bilinear sample of ``image`` [N, H, W, C] at the normalized
    ``grid`` [N, Ho, Wo, 2] ((x, y) in [-1, 1]) -> [N, Ho, Wo, C] through
    ``sample_pixel_coords`` (``grid_sample_pallas.grid_sample``'s
    contract)."""
    n, h, w, c = image.shape
    ho, wo = grid.shape[1:3]
    ix, iy = sampling.unnormalize_coords(grid.to(torch.float32), h, w,
                                         align_corners)
    img_nchw = image.to(torch.float32).permute(0, 3, 1, 2).contiguous()
    out = sample_pixel_coords(img_nchw, ix.reshape(n, ho * wo).contiguous(),
                              iy.reshape(n, ho * wo).contiguous(),
                              padding_mode, precision)
    return out.reshape(n, c, ho, wo).permute(0, 2, 3, 1).to(image.dtype)


def flow_warp(image, flow, *, padding_mode="border", precision="exact"):
    """Appearance-flow warp through ``sample_pixel_coords``: ``image``
    [N, H, W, C] sampled at base grid + ``flow`` [N, H, W, 2] (pixel units,
    (x, y)) -> [N, H, W, C] (``grid_sample_pallas.flow_warp``'s
    contract)."""
    n, h, w, c = image.shape
    coords = sampling.base_grid(h, w, device=flow.device)[None] \
        + flow.to(torch.float32)
    img_nchw = image.to(torch.float32).permute(0, 3, 1, 2).contiguous()
    out = sample_pixel_coords(img_nchw,
                              coords[..., 0].reshape(n, h * w).contiguous(),
                              coords[..., 1].reshape(n, h * w).contiguous(),
                              padding_mode, precision)
    return out.reshape(n, c, h, w).permute(0, 2, 3, 1).to(image.dtype)
