"""Fused multi-source warp + confidence blend + composite (port of
multiflow_pallas.py).

Ports ``multiflow_composite_pix`` with its custom VJP. Per target pixel p of
example n, over the T source frames t:

    valid_t   = in-bounds(ix_t, iy_t)                  # unclamped coords
    wts_t     = softmax_t(conf_t + (valid_t - 1) * 30) # out-of-bounds ~excluded
    multi     = sum_t wts_t * bilinear(img_t, ix_t, iy_t)   # border or zeros
    view      = mask * multi + (1 - mask) * rgb
    any_valid = max_t valid_t

The forward is the TPU kernel ``_fwd_kernel`` as a hand-written CUDA kernel
(``csrc/multiflow_composite.cu``); the backward is ``_mf_bwd`` around
``_bwd_kernel`` as a second one (``csrc/multiflow_composite_bwd.cu``).
Design and bound are in each source's header. The TPU formulation (tent-
weight matmuls, the VMEM pixel-block planner, ``kernel_supported``) does not
carry over: one CUDA thread handles one target pixel, with the T sources'
coordinates and weights in registers: T and the padding are compile-time
constants of the kernels, and each (T, padding) pair is built into a
library of its own at its first use (``_defines``; cached by
``kernels/_build.py``), so any T runs. The kernels take channels-last
frames — the model passes its NHWC frames as a [N,T,C,H,W] view, whose
taps they gather a pixel's channels at a time; the wrappers also accept
contiguous frames and copy them into that layout first.

``multiflow_composite_pix`` is a ``torch.autograd.Function`` on either
device whose forward calls the registered operator
``dmv3d::multiflow_composite_fwd`` (``_build``: traced by
``torch.export``, served by ``serving.py``). On CPU tensors its forward
and backward are the plain PyTorch
versions (``multiflow_composite_pix_plain``,
``multiflow_composite_pix_bwd_plain``), the kernels' oracles, written out by
hand with the kernels' arithmetic in the kernels' order (the backward is not
autograd through the plain forward: see ``kernels/grid_sample.py`` for the
far-edge subgradient and the fast-mode rounding it would get wrong). On CUDA
tensors each launches its kernel or raises.
"""

from __future__ import annotations

import torch

from dynamic_multiview_3d_torch.kernels import _build
from dynamic_multiview_3d_torch.kernels.grid_sample import (
    channel_sum,
    in_bounds,
    sample_taps,
    scatter_taps,
    tap_grads,
)

MAX_CHANNELS = 16            # the kernels' per-thread channel registers


def _blend(ix, iy, conf, h: int, w: int):
    """Per-source validity and blend weights ([N, T, P] each), in the
    kernel's order: the max over t ascending, exp(z - max), the denominator
    summed in t order, one division per weight."""
    valid = in_bounds(ix, iy, h, w)
    z = conf + (valid - 1.0) * 30.0
    zmax = z[:, 0]
    for s in range(1, z.shape[1]):
        zmax = torch.maximum(zmax, z[:, s])
    ez = torch.exp(z - zmax[:, None])
    denom = ez[:, 0]
    for s in range(1, z.shape[1]):
        denom = denom + ez[:, s]
    return valid, ez / denom[:, None]


def _sources(imgs, ix, iy, padding_mode, precision):
    """``grid_sample.sample_taps`` of every source at its own coordinates,
    the T sources folded into the batch: [N*T, ...] entries."""
    n, t, c, h, w = imgs.shape
    p = ix.shape[-1]
    return sample_taps(imgs.reshape(n * t, c, h, w), ix.reshape(n * t, p),
                       iy.reshape(n * t, p), padding_mode, precision)


def _blend_sum(wts, val):
    """sum_t wts_t * val_t from 0 in t order: wts [N,T,P], val [N,T,C,P]."""
    acc = torch.zeros_like(val[:, 0])
    for s in range(val.shape[1]):
        acc = acc + wts[:, s, None] * val[:, s]
    return acc


def multiflow_composite_pix_plain(imgs, ix, iy, conf, mask, rgb,
                                  padding_mode="border", precision="exact"):
    """Plain PyTorch version of the forward kernel: same contract and
    arithmetic (see ``multiflow_composite_pix``). Autograd through it
    differentiates its gathers, which is not the reference's backward."""
    n, t, c, h, w = imgs.shape
    valid, wts = _blend(ix, iy, conf, h, w)
    val = _sources(imgs, ix, iy, padding_mode, precision)["warped"] \
        .reshape(n, t, c, -1)
    multi = _blend_sum(wts, val)
    m = mask[:, None, :]
    view = m * multi + (1.0 - m) * rgb
    return view, multi, valid.amax(1), wts


def multiflow_composite_pix_bwd_plain(imgs, ix, iy, conf, mask, rgb, d_view,
                                      d_multi=None, d_wts=None,
                                      padding_mode="border",
                                      precision="exact", need_imgs=True):
    """Plain PyTorch version of the backward kernel: what ``_mf_bwd`` and
    ``_bwd_kernel`` compute, in the kernel's order.

    d_view, d_multi [N, C, P] and d_wts [N, T, P] are the cotangents of
    view, multi and wts (d_multi, d_wts None: zero). Returns (d_imgs or
    None, d_ix, d_iy, d_conf, d_mask, d_rgb):

        dm_c    = d_view_c * mask + d_multi_c     # cotangent of multi
        ds_tc   = wts_t * dm_c                    # of source t's sample
        d_ix_t  = sum_c ds_tc * (u_x0 t0 + u_x1 t1)
        d_iy_t  = sum_c ds_tc * (w_x0 (u_y0 v00 + u_y1 v10)
                                 + w_x1 (u_y0 v01 + u_y1 v11))
        g_t     = d_wts_t + sum_c dm_c * val_tc   # cotangent of wts_t
        d_conf_t = wts_t * (g_t - sum_s wts_s g_s)   # softmax Jacobian
        d_mask  = sum_c d_view_c * (multi_c - rgb_c)
        d_rgb_c = d_view_c * (1 - mask)
        d_imgs  = the four taps' scatter-add of (w_y * ds) * w_x

    u is the floor-tap subgradient (``grid_sample.tap_grads``) under
    ``padding_mode``, as are the taps; the validity bias and any_valid
    have zero gradient. "fast" rounds what the reference's fast backward
    rounds: the image and the y-weights of t0/t1 (as the forward; w_x f32
    in val and d_iy, u exact), and in d_imgs both factors, bf16(w_y * ds)
    x bf16(w_x).
    """
    n, t, c, h, w = imgs.shape
    p = ix.shape[-1]
    _, wts = _blend(ix, iy, conf, h, w)
    s = _sources(imgs, ix, iy, padding_mode, precision)
    (wx0, wx1), (t0, t1) = s["wx"], s["t"]
    v00, v10, v01, v11 = s["v"]
    ux0, ux1 = (u[:, None, :]
                for u in tap_grads(ix.reshape(n * t, p), w, padding_mode))
    uy0, uy1 = (u[:, None, :]
                for u in tap_grads(iy.reshape(n * t, p), h, padding_mode))
    val = s["warped"].reshape(n, t, c, p)

    m = mask[:, None, :]
    dm = d_view * m
    if d_multi is not None:
        dm = dm + d_multi
    ds = (wts[:, :, None] * dm[:, None]).reshape(n * t, c, p)
    sx = ux0 * t0 + ux1 * t1
    sy = wx0 * (uy0 * v00 + uy1 * v10) + wx1 * (uy0 * v01 + uy1 * v11)
    d_ix = channel_sum(sx * ds).reshape(n, t, p)
    d_iy = channel_sum(sy * ds).reshape(n, t, p)

    g = torch.zeros_like(wts) if d_wts is None else d_wts
    for ch in range(c):
        g = g + dm[:, None, ch] * val[:, :, ch]
    gbar = wts[:, 0] * g[:, 0]
    for src in range(1, t):
        gbar = gbar + wts[:, src] * g[:, src]
    d_conf = wts * (g - gbar[:, None])
    d_mask = channel_sum(d_view * (_blend_sum(wts, val) - rgb))
    d_rgb = d_view * (1.0 - m)

    d_imgs = scatter_taps(s, ds, h, w, precision == "fast") \
        .reshape(n, t, c, h, w) if need_imgs else None
    return d_imgs, d_ix, d_iy, d_conf, d_mask, d_rgb


def _check(imgs, ix, iy, conf, mask, rgb, padding_mode, precision,
           d_view=None, d_multi=None, d_wts=None):
    """The modes, and shapes, dtype, device and layout of the forward's
    inputs and of any cotangent given (None is skipped): all contiguous,
    except imgs, which may also be channels-last."""
    if padding_mode not in ("border", "zeros"):
        raise ValueError(f"unknown padding_mode: {padding_mode!r}")
    if precision not in ("exact", "fast"):
        raise ValueError(f"unknown precision: {precision!r}")
    if imgs.dim() != 5:
        raise ValueError(f"imgs must be [N,T,C,H,W], got {tuple(imgs.shape)}")
    n, t, c, h, w = imgs.shape
    p = ix.shape[-1] if ix.dim() == 3 else -1
    # one grid.y row per example: check_inputs bounds n
    _build.check_inputs("multiflow_composite_pix", imgs, {
        "imgs": (imgs, (n, t, c, h, w)), "ix": (ix, (n, t, p)),
        "iy": (iy, (n, t, p)), "conf": (conf, (n, t, p)),
        "mask": (mask, (n, p)), "rgb": (rgb, (n, c, p)),
        "d_view": (d_view, (n, c, p)), "d_multi": (d_multi, (n, c, p)),
        "d_wts": (d_wts, (n, t, p))}, channels_last_ok=("imgs",))
    if imgs.device.type == "cuda" and c > MAX_CHANNELS:
        raise ValueError(f"at most {MAX_CHANNELS} channels per image, got "
                         f"{c}")


def _defines(t: int, padding_mode: str) -> tuple:
    """The build of the kernels for T sources under ``padding_mode``
    (``csrc/multiflow.cuh``): one cached library per pair."""
    return (f"DMV3D_MF_T={t}",
            f"DMV3D_MF_BORDER={int(padding_mode == 'border')}")


@torch.library.custom_op("dmv3d::multiflow_composite_fwd", mutates_args=(),
                         device_types="cpu")
def multiflow_composite_fwd(
        imgs: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor,
        conf: torch.Tensor, mask: torch.Tensor, rgb: torch.Tensor,
        padding_mode: str, precision: str
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward of ``multiflow_composite_pix`` as an operator: (view,
    multi, any_valid, wts), inputs checked by the wrapper. Its CPU
    implementation is the plain version, its CUDA one the kernel of T and
    ``padding_mode`` (the frames channels-last; counted in
    ``multiflow_composite_pix.launches``)."""
    return multiflow_composite_pix_plain(imgs, ix, iy, conf, mask, rgb,
                                         padding_mode, precision)


@multiflow_composite_fwd.register_kernel("cuda")
def _multiflow_composite_fwd_cuda(imgs, ix, iy, conf, mask, rgb, padding_mode,
                                  precision):
    n, t, c, h, w = imgs.shape
    p = ix.shape[-1]
    dev = imgs.device
    view = torch.empty((n, c, p), dtype=torch.float32, device=dev)
    multi = torch.empty_like(view)
    any_valid = torch.empty((n, p), dtype=torch.float32, device=dev)
    wts = torch.empty_like(conf)
    fn = _build.entry("multiflow_composite", "dmv3d_multiflow_composite_fwd",
                      10, 7, _defines(t, padding_mode))
    _build.launch(fn, "multiflow_composite", dev,
                  [_build.ptr(x) for x in (_build.as_channels_last(imgs), ix,
                                           iy, conf, mask, rgb, view, multi,
                                           any_valid, wts)],
                  (n, t, c, h, w, p, int(precision == "fast")))
    multiflow_composite_pix.launches += 1
    return view, multi, any_valid, wts


@multiflow_composite_fwd.register_fake
def _(imgs, ix, iy, conf, mask, rgb, padding_mode, precision):
    view = rgb.new_empty(rgb.shape)
    return (view, torch.empty_like(view), mask.new_empty(mask.shape),
            conf.new_empty(conf.shape))


def multiflow_composite_pix_bwd(imgs, ix, iy, conf, mask, rgb, d_view,
                                d_multi=None, d_wts=None,
                                padding_mode="border", precision="exact",
                                need_imgs=True):
    """The backward of ``multiflow_composite_pix``: (d_imgs or None, d_ix,
    d_iy, d_conf, d_mask, d_rgb) for the cotangents d_view, d_multi
    ([N, C, P]) and d_wts ([N, T, P]; d_multi, d_wts None: zero, and the
    kernel reads nothing for them), float32 and contiguous like the
    forward's inputs. CPU tensors run ``multiflow_composite_pix_bwd_plain``;
    CUDA tensors launch the kernel (d_imgs only when ``need_imgs``:
    scatter-added with atomics, returned in the layout of imgs) or raise.
    Counts each launch in ``multiflow_composite_pix_bwd.launches``, and the
    launches that computed d_imgs in ``.img_launches``."""
    _check(imgs, ix, iy, conf, mask, rgb, padding_mode, precision, d_view,
           d_multi, d_wts)
    if imgs.device.type == "cpu":
        return multiflow_composite_pix_bwd_plain(
            imgs, ix, iy, conf, mask, rgb, d_view, d_multi, d_wts,
            padding_mode, precision, need_imgs)
    n, t, c, h, w = imgs.shape
    p = ix.shape[-1]
    d_ix = torch.empty_like(ix)
    d_iy = torch.empty_like(ix)
    d_conf = torch.empty_like(ix)
    d_mask = torch.empty_like(mask)
    d_rgb = torch.empty_like(rgb)
    frames = _build.as_channels_last(imgs)
    # zeros_like keeps the channels-last strides
    d_imgs = torch.zeros_like(frames) if need_imgs else None
    fn = _build.entry("multiflow_composite_bwd",
                      "dmv3d_multiflow_composite_bwd", 15, 7,
                      _defines(t, padding_mode))
    _build.launch(fn, "multiflow_composite_bwd", imgs.device,
                  [_build.ptr(x) for x in (frames, ix, iy, conf, mask, rgb,
                                           d_view, d_multi, d_wts, d_imgs,
                                           d_ix, d_iy, d_conf, d_mask, d_rgb)],
                  (n, t, c, h, w, p, int(precision == "fast")))
    multiflow_composite_pix_bwd.launches += 1
    multiflow_composite_pix_bwd.img_launches += int(need_imgs)
    if need_imgs and frames is not imgs:          # back to the layout of imgs
        d_imgs = d_imgs.contiguous()
    return d_imgs, d_ix, d_iy, d_conf, d_mask, d_rgb


multiflow_composite_pix_bwd.launches = 0
multiflow_composite_pix_bwd.img_launches = 0


class _MultiflowComposite(torch.autograd.Function):
    """``multiflow_composite_pix``'s custom VJP around ``dmv3d::
    multiflow_composite_fwd``: any_valid has no gradient,
    a cotangent autograd leaves as None is not computed with (d_view is
    zero-filled; d_multi and d_wts are not read at all), and d_imgs is
    computed only when the images require grad (on the model's path they
    never do)."""

    @staticmethod
    def forward(ctx, imgs, ix, iy, conf, mask, rgb, padding_mode, precision):
        ctx.set_materialize_grads(False)
        ctx.modes = (padding_mode, precision)
        ctx.save_for_backward(imgs, ix, iy, conf, mask, rgb)
        view, multi, any_valid, wts = multiflow_composite_fwd(
            imgs, ix, iy, conf, mask, rgb, padding_mode, precision)
        ctx.mark_non_differentiable(any_valid)
        return view, multi, any_valid, wts

    @staticmethod
    def backward(ctx, d_view, d_multi, _d_valid, d_wts):
        if d_view is None and d_multi is None and d_wts is None:
            return (None,) * 8
        imgs, ix, iy, conf, mask, rgb = ctx.saved_tensors
        # the model's outputs are permuted views: their cotangents may be too
        d_view = (torch.zeros_like(rgb) if d_view is None
                  else d_view.contiguous())
        d_multi, d_wts = (None if g is None else g.contiguous()
                          for g in (d_multi, d_wts))
        grads = multiflow_composite_pix_bwd(
            imgs, ix, iy, conf, mask, rgb, d_view, d_multi, d_wts,
            *ctx.modes, need_imgs=ctx.needs_input_grad[0])
        return grads + (None, None)


def multiflow_composite_pix(imgs, ix, iy, conf, mask, rgb,
                            padding_mode="border", precision="exact"):
    """Fused multi-source synthesis at pixel coordinates, differentiable in
    imgs, ix, iy, conf, mask and rgb (any_valid has no gradient).

    imgs [N,T,C,H,W]; ix, iy, conf [N,T,P]; mask [N,P]; rgb [N,C,P]; all
    float32 on one device, contiguous, except imgs, which may also be
    channels-last (``imgs.movedim(2, -1)`` contiguous: NHWC frames
    permuted, as the model passes them, the kernels' layout: contiguous
    frames are copied into it on CUDA); any other strides raise. Any T;
    on CUDA, C <= 16. Returns view, multi [N,C,P], any_valid [N,P] and wts
    [N,T,P] (formulas in the module docstring). ``padding_mode`` "border"
    (the coordinate is clamped into the image; the model's) or "zeros" (a
    tap outside the image reads 0); either way a source whose unclamped
    coordinate leaves the image gets the -30 logit bias. ``precision``
    "exact" is f32 throughout; "fast" rounds image values and y-tap
    weights to bf16 (the model default). Counts each forward kernel launch
    in ``multiflow_composite_pix.launches``; the backward counts in
    ``multiflow_composite_pix_bwd.launches``.
    """
    _check(imgs, ix, iy, conf, mask, rgb, padding_mode, precision)
    return _MultiflowComposite.apply(imgs, ix, iy, conf, mask, rgb,
                                     padding_mode, precision)


multiflow_composite_pix.launches = 0
