"""The backward of the port's fused warp + composite (kernels/grid_sample.py).

On the CPU ``warp_composite_pix`` runs its plain backward
(``warp_composite_pix_bwd_plain``, written out by hand: it is not autograd
through the plain forward). It is held against ``jax.vjp`` of the JAX
package's ``flow_warp_composite`` with the Pallas kernels in interpret mode,
i.e. ``_wc_bwd`` around ``_bwd_kernel``, for the cotangents of view and
warped, and every gradient: d_img, d_flow, d_mask, d_rgb.

Tolerances: "exact" 1e-5 (f32 both, sums in another order: measured
<= 3e-6). "fast" the forward's two tiers (tests/test_torch_kernels.py):
2e-2 as the outer limit, and at least 99.9% of the elements within 1e-5 of
JAX's fast, which pins down which operands are rounded; a planted variant
that keeps the x-weights of d_img in f32 is shown to fail that share.

The "integer" case puts coordinates exactly on the far edges: there the
reference's floor-tap subgradient gives -v(edge) for the coordinate's
gradient in border mode, where autograd through the clamped plain forward
gave 0 (off by up to 3.21 before the backward was written out).

The tests marked ``cuda`` hold the CUDA backward kernel to the plain
backward on the card; they skip without one:
``python -m pytest --noconftest tests/test_torch_kernels_bwd.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from dynamic_multiview_3d_torch.kernels import grid_sample as tgs
from test_torch_kernels import CASES, _case, _share_within


def _cotangents(arrays, seed=1):
    rng = np.random.default_rng(seed)
    shape = arrays[0].shape                       # [N, H, W, C]
    return [rng.standard_normal(shape, dtype=np.float32) for _ in range(2)]


def _jax_grads(arrays, cots, padding_mode, precision):
    """jax.vjp of the JAX package's fused op -> (d_img, d_flow, d_mask,
    d_rgb); a cotangent of None is zero."""
    import jax
    import jax.numpy as jnp
    from dynamic_multiview_3d_tpu.kernels import grid_sample_pallas as gsp

    def f(*a):
        view, warped, _ = gsp.flow_warp_composite(
            *a, padding_mode=padding_mode, interpret=True,
            precision=precision)
        return view, warped
    outs, vjp = jax.vjp(f, *(jnp.asarray(a) for a in arrays))
    cots = tuple(jnp.zeros_like(o) if c is None else jnp.asarray(c)
                 for o, c in zip(outs, cots))
    return [np.asarray(g) for g in vjp(cots)]


def _port_grads(arrays, cots, padding_mode, precision, image_grad=True):
    ts = [torch.from_numpy(a) for a in arrays]
    for i, t in enumerate(ts):
        t.requires_grad_(image_grad or i > 0)
    view, warped, _ = tgs.flow_warp_composite(
        *ts, padding_mode=padding_mode, precision=precision)
    pairs = [(o, torch.from_numpy(c)) for o, c in zip((view, warped), cots)
             if c is not None]
    torch.autograd.backward([o for o, _ in pairs], [c for _, c in pairs])
    return [None if t.grad is None else t.grad.numpy() for t in ts]


@pytest.mark.parametrize("name,h,w", CASES)
@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_bwd_exact_matches_pallas(name, h, w, padding_mode):
    arrays = _case(name, h, w)
    cots = _cotangents(arrays)
    ref = _jax_grads(arrays, cots, padding_mode, "exact")
    ours = _port_grads(arrays, cots, padding_mode, "exact")
    for what, r, o in zip(("img", "flow", "mask", "rgb"), ref, ours):
        assert o.shape == r.shape, what
        np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-5, err_msg=what)


@pytest.mark.parametrize("name,h,w", CASES)
@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_bwd_fast_matches_pallas_fast(name, h, w, padding_mode):
    arrays = _case(name, h, w)
    cots = _cotangents(arrays)
    ref = _jax_grads(arrays, cots, padding_mode, "fast")
    ours = _port_grads(arrays, cots, padding_mode, "fast")
    exact = _port_grads(arrays, cots, padding_mode, "exact")
    for what, r, o in zip(("img", "flow", "mask", "rgb"), ref, ours):
        np.testing.assert_allclose(o, r, rtol=2e-2, atol=2e-2, err_msg=what)
        assert _share_within(o, r, 1e-5) >= 0.999, what
    if name != "integer":      # integer weights are exact in bf16
        assert np.abs(ours[0] - exact[0]).max() > 0      # fast really rounds


def _planted_dimg(arrays, cots, padding_mode):
    """d_img of a fast backward that rounds w_y * ds but keeps the x-weights
    in f32 (the forward's choice): bf16(w_y * ds) x w_x, scatter-added."""
    img, flow, mask, _ = (torch.from_numpy(a) for a in arrays)
    n, h, w, c = img.shape
    p = h * w
    base = torch.stack(torch.meshgrid(torch.arange(h, dtype=torch.float32),
                                      torch.arange(w, dtype=torch.float32),
                                      indexing="ij")[::-1], -1)
    coords = (base[None] + flow).reshape(n, p, 2)
    x0, x1, wx0, wx1 = tgs._taps(coords[..., 0], w, padding_mode)
    y0, y1, wy0, wy1 = tgs._taps(coords[..., 1], h, padding_mode)
    d_view, d_warped = (torch.from_numpy(t).permute(0, 3, 1, 2)
                        .reshape(n, c, p) for t in cots)
    ds = d_view * mask.reshape(n, 1, p) + d_warped
    d_img = torch.zeros(n, c, h * w)
    for wy, yi in ((wy0, y0), (wy1, y1)):
        a = tgs._round_bf16(wy[:, None] * ds)
        for wx, xi in ((wx0, x0), (wx1, x1)):
            idx = (yi * w + xi)[:, None, :].expand(n, c, p)
            d_img.scatter_add_(2, idx, a * wx[:, None])
    return d_img.reshape(n, c, h, w).permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("name,h,w", [c for c in CASES if c[0] != "integer"])
def test_fast_check_rejects_unrounded_x_weights_in_dimg(name, h, w):
    """The planted d_img stays inside the 2e-2 limit but fails the 1e-5
    share check above. Integer coordinates are left out: their x-weights
    are 0 and 1, which bf16 holds exactly."""
    arrays = _case(name, h, w)
    cots = _cotangents(arrays)
    ref = _jax_grads(arrays, cots, "border", "fast")[0]
    ours = _port_grads(arrays, cots, "border", "fast")[0]
    planted = _planted_dimg(arrays, cots, "border")
    np.testing.assert_allclose(planted, ours, rtol=2e-2, atol=2e-2)
    assert _share_within(ours, ref, 1e-5) >= 0.999
    assert _share_within(planted, ref, 1e-5) < 0.999


@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_no_image_grad_and_no_warped_cotangent(precision):
    """The model's path: the image needs no grad, so d_img is never
    computed, and warped is not in the loss, so its cotangent stays None
    (taken as zero); the other gradients match JAX's with a zero one."""
    arrays = _case("edges", 16, 24)
    d_view = _cotangents(arrays)[0]
    ref = _jax_grads(arrays, (d_view, None), "border", precision)
    ours = _port_grads(arrays, (d_view, None), "border", precision,
                       image_grad=False)
    assert ours[0] is None
    for what, r, o in zip(("flow", "mask", "rgb"), ref[1:], ours[1:]):
        np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-5, err_msg=what)


def _pix_inputs(name="inside", h=16, w=16, n=2, device="cpu"):
    img, flow, mask, rgb = (torch.from_numpy(a).to(device)
                            for a in _case(name, h, w, n))
    c = img.shape[-1]
    p = h * w
    base_x = torch.arange(w, dtype=torch.float32, device=device)
    base_y = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    return (img.permute(0, 3, 1, 2).contiguous(),
            (base_x + flow[..., 0]).reshape(n, p).contiguous(),
            (base_y + flow[..., 1]).reshape(n, p).contiguous(),
            mask.reshape(n, p).contiguous(),
            rgb.permute(0, 3, 1, 2).reshape(n, c, p).contiguous())


def test_bwd_wrapper_checks_inputs_and_counts_no_cpu_launch():
    args = _pix_inputs()
    d_view = torch.ones_like(args[4])
    before = (tgs.warp_composite_pix_bwd.launches,
              tgs.warp_composite_pix_bwd.img_launches)
    grads = tgs.warp_composite_pix_bwd(*args, d_view)
    assert (tgs.warp_composite_pix_bwd.launches,
            tgs.warp_composite_pix_bwd.img_launches) == before   # CPU: plain
    assert grads[0].shape == args[0].shape
    assert tgs.warp_composite_pix_bwd(*args, d_view, need_img=False)[0] \
        is None
    with pytest.raises(ValueError):
        tgs.warp_composite_pix_bwd(*args, d_view[:, :, :-1])
    with pytest.raises(TypeError):
        tgs.warp_composite_pix_bwd(*args, d_view, d_view.double())
    with pytest.raises(ValueError):
        tgs.warp_composite_pix_bwd(*args, d_view.transpose(1, 2)
                                   .contiguous().transpose(1, 2))
    with pytest.raises(ValueError):
        tgs.warp_composite_pix_bwd(*args, d_view, precision="half")


def test_permuted_cotangents_are_made_contiguous():
    """flow_warp_composite returns NHWC views of [N, C, P] tensors, so their
    cotangents reach the backward permuted: same gradients as contiguous
    ones through the pixel-level op."""
    arrays = _case("inside", 16, 24)
    d_view = _cotangents(arrays)[0]
    ours = _port_grads(arrays, (d_view, None), "border", "exact")
    args = [t.requires_grad_(True) for t in _pix_inputs("inside", 16, 24)]
    view, _, _ = tgs.warp_composite_pix(*args)
    n, h, w, c = d_view.shape
    view.backward(torch.from_numpy(d_view).permute(0, 3, 1, 2)
                  .reshape(n, c, h * w).contiguous())
    torch.testing.assert_close(
        torch.from_numpy(ours[0]), args[0].grad.permute(0, 2, 3, 1),
        rtol=0, atol=0)
    torch.testing.assert_close(torch.from_numpy(ours[2]).reshape(n, h * w),
                               args[3].grad, rtol=0, atol=0)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check_bwd_kernel(device, name, h, w, n, padding_mode, precision,
                      with_warped):
    args = _pix_inputs(name, h, w, n, device)
    g = torch.Generator(device=device).manual_seed(0)
    d_view = torch.randn(args[4].shape, generator=g, device=device)
    d_warped = torch.randn(args[4].shape, generator=g, device=device) \
        if with_warped else None
    before = (tgs.warp_composite_pix_bwd.launches,
              tgs.warp_composite_pix_bwd.img_launches)
    ours = tgs.warp_composite_pix_bwd(*args, d_view, d_warped, padding_mode,
                                      precision)
    torch.cuda.synchronize(device)
    assert (tgs.warp_composite_pix_bwd.launches,
            tgs.warp_composite_pix_bwd.img_launches) == \
        (before[0] + 1, before[1] + 1)
    ref = tgs.warp_composite_pix_bwd_plain(*args, d_view, d_warped,
                                           padding_mode, precision)
    for o, r in zip(ours[1:], ref[1:]):             # per pixel: bitwise
        assert o.device == args[0].device
        torch.testing.assert_close(o, r, rtol=0, atol=1e-5)
    # d_img sums with atomics in run-dependent order: 1e-5 of its largest
    scale = max(1.0, float(ref[0].abs().max()))
    assert float((ours[0] - ref[0]).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
@pytest.mark.parametrize("name,h,w,n,with_warped", [
    ("edges", 16, 24, 3, True), ("integer", 16, 16, 2, True),
    ("edges", 128, 128, 8, False)])
def test_cuda_bwd_kernel_matches_plain(cuda, precision, padding_mode, name, h,
                                       w, n, with_warped):
    _check_bwd_kernel(cuda, name, h, w, n, padding_mode, precision,
                      with_warped)


@pytest.mark.cuda
def test_cuda_autograd_goes_through_the_kernels(cuda):
    """On CUDA tensors that require grad, backward launches the kernel once
    (no d_img: the image needs no grad) and matches the plain backward."""
    args = [t.requires_grad_(i > 0)
            for i, t in enumerate(_pix_inputs("edges", 16, 24, 3, cuda))]
    fwd, bwd = (tgs.warp_composite_pix.launches,
                tgs.warp_composite_pix_bwd.launches)
    img_launches = tgs.warp_composite_pix_bwd.img_launches
    view, _, _ = tgs.warp_composite_pix(*args, "border", "fast")
    d_view = torch.randn_like(view)
    view.backward(d_view)
    torch.cuda.synchronize()
    assert tgs.warp_composite_pix.launches == fwd + 1
    assert tgs.warp_composite_pix_bwd.launches == bwd + 1
    assert tgs.warp_composite_pix_bwd.img_launches == img_launches
    assert args[0].grad is None
    ref = tgs.warp_composite_pix_bwd_plain(
        *(a.detach() for a in args), d_view, None, "border", "fast",
        need_img=False)
    for a, r in zip(args[1:], ref[1:]):
        torch.testing.assert_close(a.grad, r, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_cuda_bwd_kernel_on_a_gpu_other_than_the_current_one(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    dev = torch.device("cuda", 1)
    assert torch.cuda.current_device() != 1
    _check_bwd_kernel(dev, "edges", 16, 24, 3, "border", "fast", True)
