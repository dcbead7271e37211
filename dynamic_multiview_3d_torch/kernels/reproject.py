"""Fused depth reprojection sampling (port of reproject_pallas.py).

Depth synthesis computes, per target pixel (u, v) with predicted depth d,
its correspondence in the source view and samples the source image there,
under zeros padding. With the 12 camera scalars of an image, M = K R K^-1
and m = K t (``host_params``):

    q      = d * (M @ [u, v, 1]) + m
    valid  = q.z > 1e-6
    (x, y) = q.xy / q.z where valid, else (-1e6, -1e6)   # samples 0
    geo    = bilinear(src, x, y) * valid
    view   = mask * geo + (1 - mask) * rgb                # composite only

Ports ``depth_reproject_sample`` (the TPU kernel ``_fused_kernel``) and
``depth_reproject_composite`` (``_fused_composite_kernel``) as the two
entries of ``csrc/reproject.cu``, and both VJPs (``_bwd``, ``_cmp_bwd``:
the composite's chain rule, site #3's sampler backward in zeros mode, the
chain rule to the depth) as one fused kernel, ``csrc/reproject_bwd.cu``.
The camera scalars get no gradient, as in the reference. Design and bound
are in each source's header; the correspondence is ``csrc/reproject.cuh``,
shared by both.

The source image may be shared by several targets: ``img_nchw`` holds
N_src = N / K frames for the N targets of ``depth`` and ``params``, and
target n reads frame n // K (K = 1: the reference's one image per target).
The kernels read three channels ``staged`` as [N_src, H, W, 4] (one
16-byte load per tap) and other C channels-last: on CUDA the wrappers copy
a frame that is in neither layout into it (``_build.stage``), and the
autograd ops keep the staged frame for the backward. The model stages its
last frame once per forward on CUDA and hands that view to every
single-source kernel, so these wrappers copy nothing on its path.
``d_img`` is [N_src, C, H, W], each frame's gradient summed over its K
targets, as autograd through a repeat of the frame gives.

``reproject_sample_pix`` and ``reproject_composite_pix`` are
``torch.autograd.Function``s on either device whose forwards call the
registered operators ``dmv3d::reproject_sample_fwd`` and
``dmv3d::reproject_composite_fwd`` (``_build``: traced by
``torch.export``, served by ``serving.py``). On CPU tensors their
forwards and backward are the plain PyTorch versions
(``reproject_sample_pix_plain``, ``reproject_composite_pix_plain``,
``reproject_pix_bwd_plain``), the kernels' oracles, written out with the
kernels' arithmetic in the kernels' order; on CUDA tensors each launches
its kernel or raises. The backward is written out by hand, not autograd
through the plain forward (see ``kernels/grid_sample.py``).
"""

from __future__ import annotations

import torch

from dynamic_multiview_3d_torch.kernels import _build
from dynamic_multiview_3d_torch.kernels.grid_sample import (
    _as_layout_of,
    _image_grad,
    channel_sum,
    per_frame,
    per_target,
    sample_taps,
    sampler_grads,
)
from dynamic_multiview_3d_torch.ops.pose import _matmul, _matvec
from dynamic_multiview_3d_torch.ops.reproject import inv3x3

EPS = 1e-6
FAR = -1e6          # a coordinate that samples 0 under zeros padding


def host_params(intrinsics: torch.Tensor, t_tgt2src: torch.Tensor
                ) -> torch.Tensor:
    """[N, 12] float32, contiguous: M = K R K^-1 (row-major 9) then m = K t
    (3), for intrinsics K [N, 3, 3] and the target->source transform
    [N, 4, 4] (the reference's ``_host_params``). The products are written
    out elementwise in f32 (no TF32), K^-1 is the closed-form ``inv3x3``."""
    k = intrinsics.to(torch.float32)
    t = t_tgt2src.to(torch.float32)
    m = _matmul(_matmul(k, t[:, :3, :3]), inv3x3(k))
    mt = _matvec(k, t[:, :3, 3])
    return torch.cat([m.reshape(-1, 9), mt], dim=-1).contiguous()


def correspondence_plain(depth: torch.Tensor, params: torch.Tensor, h: int,
                         w: int) -> dict:
    """The kernels' per-pixel correspondence (``csrc/reproject.cuh``) for
    depth [N, H*W] and params [N, 12], operation by operation: x, y, valid
    [N, P] and d x / d depth, d y / d depth (0 where not valid)."""
    idx = torch.arange(h * w, device=depth.device)
    u = (idx % w).to(torch.float32)
    v = (idx // w).to(torch.float32)

    def prm(i):
        return params[:, i, None]

    def row(i):                                  # (M[i,0] u + M[i,1] v) + M[i,2]
        return prm(3 * i) * u + prm(3 * i + 1) * v + prm(3 * i + 2)

    ax, ay, az = row(0), row(1), row(2)
    qx = depth * ax + prm(9)
    qy = depth * ay + prm(10)
    qz = depth * az + prm(11)
    valid = qz > EPS
    x = torch.where(valid, qx / qz, FAR)
    y = torch.where(valid, qy / qz, FAR)
    qzs = torch.where(valid, qz, 1.0)
    inv = 1.0 / (qzs * qzs)
    dxdd = torch.where(valid, (ax * qz - qx * az) * inv, 0.0)
    dydd = torch.where(valid, (ay * qz - qy * az) * inv, 0.0)
    return dict(x=x, y=y, valid=valid.to(torch.float32), dxdd=dxdd,
                dydd=dydd)


def _geo(img_nchw, depth, params, precision):
    img_nchw = per_target(img_nchw, depth.shape[0])
    n, c, h, w = img_nchw.shape
    cr = correspondence_plain(depth, params, h, w)
    s = sample_taps(img_nchw, cr["x"], cr["y"], "zeros", precision)
    return cr, s, s["warped"] * cr["valid"][:, None]


def reproject_sample_pix_plain(img_nchw, depth, params, precision="exact"):
    """Plain PyTorch version of ``dmv3d_reproject_sample_fwd``: (geo
    [N, C, P], valid [N, P]) for img [N / K, C, H, W] (target n reads frame
    n // K), depth [N, H*W] and params [N, 12]."""
    cr, _, geo = _geo(img_nchw, depth, params, precision)
    return geo, cr["valid"]


def reproject_composite_pix_plain(img_nchw, depth, params, mask, rgb,
                                  precision="exact"):
    """Plain PyTorch version of ``dmv3d_reproject_composite_fwd``: (view,
    geo [N, C, P], valid [N, P]); mask [N, P], rgb [N, C, P]."""
    cr, _, geo = _geo(img_nchw, depth, params, precision)
    m = mask[:, None, :]
    return m * geo + (1.0 - m) * rgb, geo, cr["valid"]


def reproject_pix_bwd_plain(img_nchw, depth, params, mask, rgb, d_view,
                            d_geo, precision="exact", need_img=True):
    """Plain PyTorch version of ``csrc/reproject_bwd.cu``: (d_img or None,
    d_depth, d_mask, d_rgb). A mask of None is the sample launch (the
    backward of ``reproject_sample_pix``: rgb and d_view None, d_mask and
    d_rgb returned as None, d_geo required); otherwise the composite
    launch (d_geo None: zero)::

        dg      = d_view * mask + d_geo        # composite; else dg = d_geo
        d_rgb   = d_view * (1 - mask)
        d_mask  = sum_c d_view * (geo - rgb)
        ds      = dg * valid
        d_x, d_y, d_img = the zeros-mode sampler backward of ds
        d_depth = d_x * dx/dd + d_y * dy/dd

    with d_img [N / K, C, H, W], summed over each frame's K targets.
    """
    n_src, c, h, w = img_nchw.shape
    cr, s, geo = _geo(img_nchw, depth, params, precision)
    d_mask = d_rgb = None
    if mask is None:
        dg = d_geo
    else:
        m = mask[:, None, :]
        dg = d_view * m
        if d_geo is not None:
            dg = dg + d_geo
        d_rgb = d_view * (1.0 - m)
        d_mask = channel_sum(d_view * (geo - rgb))
    ds = dg * cr["valid"][:, None]
    d_img, d_x, d_y = sampler_grads(s, cr["x"], cr["y"], ds, "zeros",
                                    precision, need_img)
    d_depth = d_x * cr["dxdd"] + d_y * cr["dydd"]
    if d_img is not None:
        d_img = per_frame(d_img, n_src).reshape(n_src, c, h, w)
    return d_img, d_depth, d_mask, d_rgb


def _check(img_nchw, depth, params, mask, rgb, precision, **grads):
    """The mode, and shapes, dtype, device and layout of the inputs and of
    any cotangent given by name ([N, C, P] each; None is skipped): all
    contiguous, except the image, which may also be channels-last or
    staged, and holds N / K frames for some whole K. Reads no memory: the
    16-byte alignment of params (the kernels read each image's 12 scalars
    as three 16-byte loads) and of a staged image is checked where they
    are read (``_aligned``)."""
    if precision not in ("exact", "fast"):
        raise ValueError(f"unknown precision: {precision!r}")
    if img_nchw.dim() != 4 or depth.dim() != 2:
        raise ValueError(f"img_nchw must be [N/K,C,H,W] and depth [N,H*W], "
                         f"got {tuple(img_nchw.shape)}, "
                         f"{tuple(depth.shape)}")
    n_src, c, h, w = img_nchw.shape
    n, p = depth.shape[0], h * w
    if n_src == 0 or n % n_src:
        raise ValueError(f"{n} targets do not share {n_src} frames evenly")
    tensors = {"img_nchw": (img_nchw, (n_src, c, h, w)),
               "depth": (depth, (n, p)), "params": (params, (n, 12)),
               "mask": (mask, (n, p)), "rgb": (rgb, (n, c, p))}
    tensors.update({k: (t, (n, c, p)) for k, t in grads.items()})
    # one grid.y row per target: check_inputs bounds depth's first dimension
    _build.check_inputs("depth reprojection", depth, tensors,
                        channels_last_ok=("img_nchw",))


def _aligned(img_nchw, params) -> None:
    _build.check_aligned(params, "params")
    _build.check_aligned(img_nchw, "img_nchw")


def _launch_fwd(img_nchw, depth, params, mask, rgb, precision):
    """The forward kernel on CUDA tensors: the composite when ``mask`` is
    given, else the sample; the image staged (``_build.stage``)."""
    n_src, c, h, w = img_nchw.shape
    n = depth.shape[0]
    frames = _build.stage(img_nchw)
    _aligned(frames, params)
    geo = torch.empty((n, c, h * w), dtype=torch.float32,
                      device=img_nchw.device)
    valid = torch.empty_like(depth)
    sizes = (n, c, h, w, n // n_src, int(precision == "fast"))
    if mask is None:
        fn = _build.entry("reproject", "dmv3d_reproject_sample_fwd", 5, 6)
        _build.launch(fn, "reproject_sample", img_nchw.device,
                      [_build.ptr(t) for t in (params, depth, frames, geo,
                                               valid)], sizes)
        reproject_sample_pix.launches += 1
        return geo, valid
    view = torch.empty_like(geo)
    fn = _build.entry("reproject", "dmv3d_reproject_composite_fwd", 8, 6)
    _build.launch(fn, "reproject_composite", img_nchw.device,
                  [_build.ptr(t) for t in (params, depth, frames, mask, rgb,
                                           view, geo, valid)], sizes)
    reproject_composite_pix.launches += 1
    return view, geo, valid


@torch.library.custom_op("dmv3d::reproject_sample_fwd", mutates_args=(),
                         device_types="cpu")
def reproject_sample_fwd(img_nchw: torch.Tensor, depth: torch.Tensor,
                         params: torch.Tensor, precision: str
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward of ``reproject_sample_pix`` as an operator: (geo,
    valid), inputs checked by the wrapper. Its CPU implementation is the
    plain version, its CUDA one ``dmv3d_reproject_sample_fwd`` (counted in
    ``reproject_sample_pix.launches``)."""
    _aligned(img_nchw, params)
    return reproject_sample_pix_plain(img_nchw, depth, params, precision)


@reproject_sample_fwd.register_kernel("cuda")
def _reproject_sample_fwd_cuda(img_nchw, depth, params, precision):
    return _launch_fwd(img_nchw, depth, params, None, None, precision)


@reproject_sample_fwd.register_fake
def _(img_nchw, depth, params, precision):
    n, p = depth.shape
    return depth.new_empty((n, img_nchw.shape[1], p)), torch.empty_like(depth)


@torch.library.custom_op("dmv3d::reproject_composite_fwd", mutates_args=(),
                         device_types="cpu")
def reproject_composite_fwd(
        img_nchw: torch.Tensor, depth: torch.Tensor, params: torch.Tensor,
        mask: torch.Tensor, rgb: torch.Tensor, precision: str
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward of ``reproject_composite_pix`` as an operator: (view,
    geo, valid), inputs checked by the wrapper. Its CPU implementation is
    the plain version, its CUDA one ``dmv3d_reproject_composite_fwd``
    (counted in ``reproject_composite_pix.launches``)."""
    _aligned(img_nchw, params)
    return reproject_composite_pix_plain(img_nchw, depth, params, mask, rgb,
                                         precision)


@reproject_composite_fwd.register_kernel("cuda")
def _reproject_composite_fwd_cuda(img_nchw, depth, params, mask, rgb,
                                  precision):
    return _launch_fwd(img_nchw, depth, params, mask, rgb, precision)


@reproject_composite_fwd.register_fake
def _(img_nchw, depth, params, mask, rgb, precision):
    geo = rgb.new_empty(rgb.shape)
    return torch.empty_like(geo), geo, torch.empty_like(depth)


def reproject_pix_bwd(img_nchw, depth, params, mask, rgb, d_view, d_geo,
                      precision="exact", need_img=True):
    """The backward of ``reproject_sample_pix`` (mask, rgb and d_view None:
    the sample launch) and of ``reproject_composite_pix`` (the composite
    launch): (d_img or None, d_depth, d_mask, d_rgb), as
    ``reproject_pix_bwd_plain``. CPU tensors run the plain version; CUDA
    tensors launch the kernel on the image staged as the forward reads it
    (``_build.stage``: no copy of a staged image) or raise; d_img only
    when ``need_img``: zeroed, then scatter-added with atomics, [N / K, C,
    H, W], each frame's gradient summed over its K targets, contiguous
    where the image is, else channels-last.
    Counts each launch in
    ``reproject_pix_bwd.launches``, those that computed d_img in
    ``.img_launches`` and those with the composite in
    ``.composite_launches``."""
    if mask is None and d_geo is None:
        raise ValueError("the sample launch needs d_geo")
    if mask is not None and d_view is None:
        raise ValueError("the composite launch needs d_view")
    _check(img_nchw, depth, params, mask, rgb, precision, d_view=d_view,
           d_geo=d_geo)
    _aligned(img_nchw, params)
    if img_nchw.device.type == "cpu":
        return reproject_pix_bwd_plain(img_nchw, depth, params, mask, rgb,
                                       d_view, d_geo, precision, need_img)
    n_src, c, h, w = img_nchw.shape
    n = depth.shape[0]
    frames = _build.stage(img_nchw)
    d_depth = torch.empty_like(depth)
    d_mask = None if mask is None else torch.empty_like(mask)
    d_rgb = None if mask is None else torch.empty_like(rgb)
    d_img = None
    if need_img:         # channels-last: zeros_like keeps a dense frame's
        d_img = (_image_grad(frames) if _build.staged(frames)
                 else torch.zeros_like(frames))
    fn = _build.entry("reproject_bwd", "dmv3d_reproject_bwd", 11, 6)
    _build.launch(fn, "reproject_bwd", img_nchw.device,
                  [_build.ptr(t) for t in (params, depth, frames, mask, rgb,
                                           d_view, d_geo, d_img, d_depth,
                                           d_mask, d_rgb)],
                  (n, c, h, w, n // n_src, int(precision == "fast")))
    reproject_pix_bwd.launches += 1
    reproject_pix_bwd.img_launches += int(need_img)
    reproject_pix_bwd.composite_launches += int(mask is not None)
    if need_img and frames is not img_nchw:     # back to the layout of img
        d_img = _as_layout_of(d_img, img_nchw)
    return d_img, d_depth, d_mask, d_rgb


reproject_pix_bwd.launches = 0
reproject_pix_bwd.img_launches = 0
reproject_pix_bwd.composite_launches = 0


class _ReprojectSample(torch.autograd.Function):
    """``depth_reproject_sample``'s custom VJP (the reference's ``_bwd``)
    around ``dmv3d::reproject_sample_fwd``: valid and the camera scalars
    have no gradient; d_img is computed only when the image requires grad
    (on the model's path it never does). On CUDA the image is staged once
    and kept so for the backward."""

    @staticmethod
    def forward(ctx, img_nchw, depth, params, precision):
        ctx.set_materialize_grads(False)
        ctx.precision = precision
        if img_nchw.is_cuda:
            img_nchw = _build.stage(img_nchw)
        ctx.save_for_backward(img_nchw, depth, params)
        geo, valid = reproject_sample_fwd(img_nchw, depth, params, precision)
        ctx.mark_non_differentiable(valid)
        return geo, valid

    @staticmethod
    def backward(ctx, d_geo, _d_valid):
        if d_geo is None:
            return (None,) * 4
        img_nchw, depth, params = ctx.saved_tensors
        d_img, d_depth, _, _ = reproject_pix_bwd(
            img_nchw, depth, params, None, None, None, d_geo.contiguous(),
            ctx.precision, need_img=ctx.needs_input_grad[0])
        return d_img, d_depth, None, None


class _ReprojectComposite(torch.autograd.Function):
    """``depth_reproject_composite``'s custom VJP (the reference's
    ``_cmp_bwd``) around ``dmv3d::reproject_composite_fwd``: valid and the
    camera scalars have no gradient, a d_view autograd leaves as None is
    zero, a d_geo left None is not read, and d_img is computed only when
    the image requires grad. On CUDA the image
    is staged once and kept so for the backward."""

    @staticmethod
    def forward(ctx, img_nchw, depth, params, mask, rgb, precision):
        ctx.set_materialize_grads(False)
        ctx.precision = precision
        if img_nchw.is_cuda:
            img_nchw = _build.stage(img_nchw)
        ctx.save_for_backward(img_nchw, depth, params, mask, rgb)
        view, geo, valid = reproject_composite_fwd(img_nchw, depth, params,
                                                   mask, rgb, precision)
        ctx.mark_non_differentiable(valid)
        return view, geo, valid

    @staticmethod
    def backward(ctx, d_view, d_geo, _d_valid):
        if d_view is None and d_geo is None:
            return (None,) * 6
        img_nchw, depth, params, mask, rgb = ctx.saved_tensors
        # the model's outputs are permuted views: their cotangents may be too
        d_view = (torch.zeros_like(rgb) if d_view is None
                  else d_view.contiguous())
        if d_geo is not None:
            d_geo = d_geo.contiguous()
        d_img, d_depth, d_mask, d_rgb = reproject_pix_bwd(
            img_nchw, depth, params, mask, rgb, d_view, d_geo, ctx.precision,
            need_img=ctx.needs_input_grad[0])
        return d_img, d_depth, None, d_mask, d_rgb, None


def reproject_sample_pix(img_nchw, depth, params, precision="exact"):
    """Fused geometric view at the target pixels: (geo [N, C, P], valid
    [N, P]) for img [N / K, C, H, W] (target n reads frame n // K;
    contiguous, channels-last or ``staged``; on CUDA copied into the
    kernels' layout where it is not in it, ``_build.stage``), depth [N, P =
    H*W] and the camera scalars params [N, 12] (``host_params``; 16-byte
    aligned); all float32 and contiguous on one device; differentiable in
    img and depth. ``precision`` "exact" is f32
    throughout, "fast" rounds image values and y-tap weights to bf16 (the
    model default). Counts each forward kernel launch in
    ``reproject_sample_pix.launches``; the backward counts in
    ``reproject_pix_bwd.launches``."""
    _check(img_nchw, depth, params, None, None, precision)
    return _ReprojectSample.apply(img_nchw, depth, params, precision)


reproject_sample_pix.launches = 0


def reproject_composite_pix(img_nchw, depth, params, mask, rgb,
                            precision="exact"):
    """``reproject_sample_pix`` plus the composite: (view, geo [N, C, P],
    valid [N, P]) with view = mask * geo + (1 - mask) * rgb; mask [N, P],
    rgb [N, C, P]; differentiable in img, depth, mask and rgb. Counts each
    forward kernel launch in ``reproject_composite_pix.launches``."""
    _check(img_nchw, depth, params, mask, rgb, precision)
    return _ReprojectComposite.apply(img_nchw, depth, params, mask, rgb,
                                     precision)


reproject_composite_pix.launches = 0


def _pixels(img_nhwc, depth, intrinsics, t_tgt2src):
    n, h, w, c = img_nhwc.shape
    params = host_params(intrinsics.detach(), t_tgt2src.detach())
    # the kernels' layout: the NHWC image as a channels-last view
    img_nchw = img_nhwc.to(torch.float32).contiguous().permute(0, 3, 1, 2)
    return (img_nchw, depth.to(torch.float32).reshape(n, h * w).contiguous(),
            params)


def _nhwc(x, n, h, w):                       # [N, C, P] -> [N, H, W, C]
    return x.reshape(n, -1, h, w).permute(0, 2, 3, 1)


def depth_reproject_sample(img_nhwc, depth, intrinsics, t_tgt2src,
                           precision="exact"):
    """Fused geometric synthesis (the reference's NHWC signature): (view
    [N, H, W, C] zeroed where not valid, valid [N, H, W]) for the source
    image img [N, H, W, C], the target depth [N, H, W], intrinsics
    [N, 3, 3] and the target->source transform [N, 4, 4]. Differentiable in
    img and depth; the cameras get no gradient."""
    n, h, w, _ = img_nhwc.shape
    geo, valid = reproject_sample_pix(
        *_pixels(img_nhwc, depth, intrinsics, t_tgt2src), precision)
    return _nhwc(geo, n, h, w), valid.reshape(n, h, w)


def depth_reproject_composite(img_nhwc, depth, intrinsics, t_tgt2src, mask,
                              rgb, precision="exact"):
    """Fused depth-mode synthesis (the reference's NHWC signature): (view,
    geo [N, H, W, C], valid [N, H, W]) with geo the reprojected source and
    view = mask * geo + (1 - mask) * rgb; mask [N, H, W, 1], rgb
    [N, H, W, C]. Differentiable in img, depth, mask and rgb."""
    n, h, w, c = img_nhwc.shape
    img_nchw, depth_p, params = _pixels(img_nhwc, depth, intrinsics,
                                        t_tgt2src)
    view, geo, valid = reproject_composite_pix(
        img_nchw, depth_p, params,
        mask.to(torch.float32).reshape(n, h * w).contiguous(),
        rgb.to(torch.float32).permute(0, 3, 1, 2).reshape(n, c, h * w)
        .contiguous(), precision)
    return _nhwc(view, n, h, w), _nhwc(geo, n, h, w), valid.reshape(n, h, w)
