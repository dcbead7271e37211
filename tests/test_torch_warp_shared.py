"""The fused warp + composite (kernels/grid_sample.py, sites #1/#3) on shared
frames: N / K source frames for N targets, target n reading frame n // K,
as flow synthesis passes each example's last frame to its K targets.

On the CPU ``warp_composite_pix`` and its backward run the plain versions,
which repeat the frames per target and then do what they do for one image
per target: bitwise the repeated frame's results, with d_img summed per
frame. Against the JAX package, the same numpy inputs go through
``grid_sample_pallas.flow_warp_composite`` (the Pallas kernels in
interpret mode) on the frame tiled per target and through ``jax.vjp``, its
d_img summed over each frame's K targets; tolerances as the per-target
tests': 1e-5 forward and 1e-4 gradients in "exact" (f32 both, sums in
another order), 3e-2 and 5e-2 in "fast" (a y-weight on a bf16 rounding
boundary can round the other way), d_img's relative to its largest value
(a sum over K targets).

The tests marked ``cuda`` hold the CUDA kernels to the plain versions on
the card, in the model's layout (channels-last frames, K > 1) and one
contiguous image per target, for C = 1, 3 (staged) and 5 (the general
instantiation); they skip without one:
``python -m pytest --noconftest tests/test_torch_warp_shared.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from dynamic_multiview_3d_torch.kernels import _build
from dynamic_multiview_3d_torch.kernels import grid_sample as tgs
from test_torch_kernels import _case, _jax_composite
from test_torch_kernels_bwd import _cotangents, _jax_grads


def _pix(arrays, k, layout="channels_last", device="cpu"):
    """The pixel-level inputs of N = len(flow) targets from NHWC arrays:
    (frames [N/K, C, H, W] in ``layout``: every K-th image, channels-last
    (NHWC memory, as the model passes it) or contiguous; ix, iy, mask
    [N, P]; rgb [N, C, P])."""
    img, flow, mask, rgb = (torch.from_numpy(np.ascontiguousarray(a))
                            .to(device) for a in arrays)
    n, h, w, c = img.shape
    p = h * w
    frames = img[::k].contiguous().permute(0, 3, 1, 2)
    if layout == "contiguous":
        frames = frames.contiguous()
    xs = torch.arange(w, dtype=torch.float32, device=device)
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    return (frames, (xs + flow[..., 0]).reshape(n, p).contiguous(),
            (ys + flow[..., 1]).reshape(n, p).contiguous(),
            mask.reshape(n, p).contiguous(),
            rgb.permute(0, 3, 1, 2).reshape(n, c, p).contiguous())


def _shared(k, layout="channels_last", name="edges", n_src=2, h=16, w=24,
            c=3, device="cpu"):
    """Shared-frame inputs (``_pix``) and the same with the frames repeated
    per target ([N, C, H, W], contiguous)."""
    args = _pix(_case(name, h, w, n=n_src * k, c=c), k, layout, device)
    repeated = args[0].repeat_interleave(k, dim=0).contiguous()
    return args, (repeated, *args[1:])


def _summed(d_img, k):
    """A per-target image gradient [N, C, H, W] summed over each frame's K
    targets."""
    return d_img.reshape(-1, k, *d_img.shape[1:]).sum(1)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_shared_frames_match_the_repeated_frame_bitwise(k, layout,
                                                        padding_mode,
                                                        precision):
    shared, repeated = _shared(k, layout)
    assert _build.channels_last(shared[0]) == (layout == "channels_last")
    for o, r in zip(tgs.warp_composite_pix(*shared, padding_mode, precision),
                    tgs.warp_composite_pix(*repeated, padding_mode,
                                           precision)):
        torch.testing.assert_close(o, r, rtol=0, atol=0)
    g = torch.Generator().manual_seed(3)
    d_view, d_warped = (torch.randn(shared[4].shape, generator=g)
                        for _ in range(2))
    for dw in (d_warped, None):
        ours = tgs.warp_composite_pix_bwd(*shared, d_view, dw, padding_mode,
                                          precision)
        ref = tgs.warp_composite_pix_bwd(*repeated, d_view, dw,
                                         padding_mode, precision)
        assert ours[0].shape == shared[0].shape
        torch.testing.assert_close(ours[0], _summed(ref[0], k), rtol=0,
                                   atol=0)
        for o, r in zip(ours[1:], ref[1:]):
            torch.testing.assert_close(o, r, rtol=0, atol=0)


@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_autograd_sums_the_image_gradient_per_frame(precision):
    """Through the autograd op, a shared frame that requires grad gets its
    K targets' gradients summed, as the repeated frame's autograd gives."""
    k = 3
    shared, repeated = _shared(k)
    g = torch.Generator().manual_seed(4)
    d_view = torch.randn(shared[4].shape, generator=g)
    grads = []
    for args in (shared, repeated):
        img = args[0].detach().requires_grad_(True)
        view, _, _ = tgs.warp_composite_pix(img, *args[1:], "border",
                                            precision)
        view.backward(d_view)
        grads.append(img.grad)
    torch.testing.assert_close(grads[0], _summed(grads[1], k), rtol=0,
                               atol=0)


@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_shared_frames_match_pallas_on_the_tiled_frame(padding_mode,
                                                       precision):
    k = 3
    arrays = list(_case("edges", 16, 24, n=2 * k))
    arrays[0] = np.repeat(arrays[0][::k], k, axis=0)      # K targets a frame
    cots = _cotangents(arrays)
    ref_out = _jax_composite(arrays, padding_mode, precision)
    ref_grads = _jax_grads(arrays, cots, padding_mode, precision)
    ref_grads[0] = ref_grads[0].reshape(-1, k, *ref_grads[0].shape[1:]) \
        .sum(1)

    img, flow, mask, rgb = (torch.from_numpy(a) for a in arrays)
    n, h, w, c = img.shape
    p = h * w
    frame = img[::k].contiguous().permute(0, 3, 1, 2).requires_grad_(True)
    flow, mask, rgb = (t.clone().requires_grad_(True)
                       for t in (flow, mask, rgb))
    xs = torch.arange(w, dtype=torch.float32)
    ys = torch.arange(h, dtype=torch.float32)[:, None]
    view, warped, valid = tgs.warp_composite_pix(
        frame, (xs + flow[..., 0]).reshape(n, p),
        (ys + flow[..., 1]).reshape(n, p), mask.reshape(n, p),
        rgb.permute(0, 3, 1, 2).reshape(n, c, p).contiguous(), padding_mode,
        precision)

    def nhwc(x):
        return x.reshape(n, c, h, w).permute(0, 2, 3, 1)
    tol = 1e-5 if precision == "exact" else 3e-2
    for o, r in zip((view, warped), ref_out[:2]):
        np.testing.assert_allclose(nhwc(o).detach().numpy(), r, rtol=tol,
                                   atol=tol)
    np.testing.assert_array_equal(valid.reshape(n, h, w).numpy(), ref_out[2])
    torch.autograd.backward(
        [nhwc(view), nhwc(warped)], [torch.from_numpy(ct) for ct in cots])
    gtol = 1e-4 if precision == "exact" else 5e-2
    ours = (frame.grad.permute(0, 2, 3, 1), flow.grad, mask.grad, rgb.grad)
    for what, o, r in zip(("img", "flow", "mask", "rgb"), ours, ref_grads):
        o = o.numpy()
        assert o.shape == r.shape, what
        np.testing.assert_allclose(o, r, rtol=gtol,
                                   atol=gtol * max(np.abs(r).max(), 1.0),
                                   err_msg=what)


def test_uneven_frame_sharing_raises():
    shared, _ = _shared(3)
    frames, ix, iy, mask, rgb = shared
    with pytest.raises(ValueError, match="share"):
        tgs.warp_composite_pix(frames, ix[:-1], iy[:-1], mask[:-1], rgb[:-1])
    with pytest.raises(ValueError, match="share"):
        tgs.warp_composite_pix_bwd(frames[:1].expand(4, -1, -1, -1)
                                   .contiguous(), ix, iy, mask, rgb,
                                   torch.ones_like(rgb))
    # the plain sampler takes one image per row of coordinates
    with pytest.raises(ValueError, match="rows of coordinates"):
        tgs.sample_pixel_coords(frames, ix, iy)


def test_stage_copies_once_and_keeps_a_staged_image():
    """``_build.stage`` puts 3 channels in [N, H, W, 4] once (a staged image
    comes back as it is, the same memory), other C channels-last; a
    channels-last image, or one cut from the end of a staged tensor without
    its fourth lane, is not staged."""
    frames = _shared(3)[0][0]
    staged = _build.stage(frames)
    assert _build.staged(staged) and not _build.staged(frames)
    assert staged.stride() == (4 * 16 * 24, 1, 4 * 24, 4)
    torch.testing.assert_close(staged, frames, rtol=0, atol=0)
    assert _build.stage(staged).data_ptr() == staged.data_ptr()
    base = torch.zeros(2 * 16 * 24 * 4 - 1)
    assert not _build.staged(base.as_strided(frames.shape, staged.stride()))
    five = _shared(3, c=5)[0][0]
    assert _build.stage(five) is five and _build.channels_last(five)
    assert _build.channels_last(_build.stage(five.contiguous()))


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
@pytest.mark.parametrize("c,k,layout,h,w", [
    (3, 8, "channels_last", 128, 128), (3, 1, "contiguous", 128, 128),
    (3, 3, "contiguous", 16, 24), (1, 3, "channels_last", 16, 24),
    (2, 3, "channels_last", 16, 24), (4, 3, "channels_last", 16, 24),
    (5, 3, "channels_last", 16, 24), (5, 1, "contiguous", 16, 24)])
def test_cuda_shared_frames_match_plain(cuda, precision, padding_mode, c, k,
                                        layout, h, w):
    """The forward and every backward launch (d_img on and off, d_warped
    given and None) on N / K frames against the plain versions on the same
    frames: bitwise, d_img (atomics, run-dependent order) to 1e-5 of its
    largest magnitude; the model's layout (K = 8 at 128²), one contiguous
    image per target, and each C the kernels instantiate (1-4, 3 staged)
    and the general one (5)."""
    args, repeated = _shared(k, layout, h=h, w=w, c=c, device=cuda)
    before = (tgs.warp_composite_pix.launches,
              tgs.warp_composite_pix_bwd.launches,
              tgs.warp_composite_pix_bwd.img_launches)
    out = tgs.warp_composite_pix(*args, padding_mode, precision)
    torch.cuda.synchronize()
    for o, r in zip(out, tgs.warp_composite_pix_plain(*args, padding_mode,
                                                      precision)):
        torch.testing.assert_close(o, r, rtol=0, atol=0)
    g = torch.Generator(device=cuda).manual_seed(0)
    d_view, d_warped = (torch.randn(args[4].shape, generator=g, device=cuda)
                        for _ in range(2))
    for need_img, dw in ((True, d_warped), (True, None), (False, None)):
        ours = tgs.warp_composite_pix_bwd(*args, d_view, dw, padding_mode,
                                          precision, need_img=need_img)
        torch.cuda.synchronize()
        ref = tgs.warp_composite_pix_bwd_plain(*args, d_view, dw,
                                               padding_mode, precision,
                                               need_img=need_img)
        for o, r in zip(ours[1:], ref[1:]):
            torch.testing.assert_close(o, r, rtol=0, atol=0)
        if need_img:
            assert ours[0].shape == args[0].shape
            assert ours[0].is_contiguous() == args[0].is_contiguous()
            scale = max(1.0, float(ref[0].abs().max()))
            assert float((ours[0] - ref[0]).abs().max()) <= 1e-5 * scale
        else:
            assert ours[0] is None
    assert (tgs.warp_composite_pix.launches,
            tgs.warp_composite_pix_bwd.launches,
            tgs.warp_composite_pix_bwd.img_launches) == \
        (before[0] + 1, before[1] + 3, before[2] + 2)
    if layout == "channels_last":       # the model's output: as the copy's
        for o, r in zip(out, tgs.warp_composite_pix_plain(
                *repeated, padding_mode, precision)):
            torch.testing.assert_close(o, r, rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_autograd_keeps_the_staged_frame(cuda):
    """The model's call: a channels-last shared frame that needs no grad;
    the forward stages it once and the backward launches on that staged
    frame, with no d_img, matching the plain backward."""
    args, _ = _shared(8, h=32, w=32, device=cuda)
    frames = args[0]
    rest = [t.requires_grad_(True) for t in args[1:]]
    fwd, bwd = (tgs.warp_composite_pix.launches,
                tgs.warp_composite_pix_bwd.launches)
    img_launches = tgs.warp_composite_pix_bwd.img_launches
    view, _, _ = tgs.warp_composite_pix(frames, *rest, "border", "fast")
    d_view = torch.randn_like(view)
    view.backward(d_view)
    torch.cuda.synchronize()
    assert (tgs.warp_composite_pix.launches,
            tgs.warp_composite_pix_bwd.launches,
            tgs.warp_composite_pix_bwd.img_launches) == \
        (fwd + 1, bwd + 1, img_launches)
    ref = tgs.warp_composite_pix_bwd_plain(
        frames, *(t.detach() for t in rest), d_view, None, "border", "fast",
        need_img=False)
    for t, r in zip(rest, ref[1:]):
        torch.testing.assert_close(t.grad, r, rtol=0, atol=0)
