"""The port's plain bilinear sampler (kernels/grid_sample.py
``sample_pixel_coords``, site #2, and its backward through site #3's
no-composite launch) and its NHWC wrappers ``grid_sample`` and
``flow_warp``.

On the CPU the port runs the plain versions; they are held against the JAX
package's ``grid_sample_pallas.sample_pixel_coords`` with the Pallas kernels
in interpret mode (``_fwd_kernel``, and ``_bwd_kernel`` through
``jax.vjp``), in both paddings and both precisions. Tolerances as in
tests/test_torch_kernels.py and tests/test_torch_kernels_bwd.py: "exact"
1e-5 (f32 both, sums in another order); "fast" 2e-2 as the outer limit and
at least 99.9% of the elements within 1e-5 of JAX's fast, which pins down
which operands are rounded. The "integer" case puts coordinates exactly on
the far edges, where the floor-tap subgradient gives -v(edge) in border
mode.

Depth synthesis hands the sampler one frame per example, shared by its K
targets: the NHWC frame as a channels-last [B, C, H, W] view, sampled at
P = K*H*W pixels. On that layout the plain version is bitwise equal to the
reference's layout, one contiguous copy of the frame per target.

The tests marked ``cuda`` hold the CUDA kernels to the plain versions on
the card, on both layouts; they skip without one:
``python -m pytest --noconftest tests/test_torch_sample_kernel.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from dynamic_multiview_3d_torch.kernels import grid_sample as tgs
from test_torch_kernels import CASES, _case, _share_within


def _coords(name, h, w, n=2):
    """Image [N, C, H, W] and pixel coordinates ix, iy [N, P] of a case of
    tests/test_torch_kernels.py (base grid + its flow), as numpy."""
    img, flow, _, _ = _case(name, h, w, n)
    base_x = np.arange(w, dtype=np.float32)
    base_y = np.arange(h, dtype=np.float32)[:, None]
    p = h * w
    return (np.ascontiguousarray(img.transpose(0, 3, 1, 2)),
            (base_x + flow[..., 0]).reshape(n, p),
            (base_y + flow[..., 1]).reshape(n, p))


def _dout(img, seed=1):
    n, c, h, w = img.shape
    return np.random.default_rng(seed).standard_normal(
        (n, c, h * w), dtype=np.float32)


def _jax_sample(arrays, dout, padding_mode, precision):
    """JAX's sample_pixel_coords (interpret mode) and its VJP: (out, d_img,
    d_ix, d_iy)."""
    import jax
    import jax.numpy as jnp
    from dynamic_multiview_3d_tpu.kernels import grid_sample_pallas as gsp

    def f(img, ix, iy):
        return gsp.sample_pixel_coords(img, ix, iy, padding_mode, True,
                                       precision)
    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in arrays))
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(dout))]


def _port_sample(arrays, dout, padding_mode, precision, image_grad=True):
    ts = [torch.from_numpy(a).requires_grad_(image_grad or i > 0)
          for i, a in enumerate(arrays)]
    out = tgs.sample_pixel_coords(*ts, padding_mode, precision)
    out.backward(torch.from_numpy(dout))
    return [out.detach().numpy()] + [
        None if t.grad is None else t.grad.numpy() for t in ts]


NAMES = ("out", "d_img", "d_ix", "d_iy")


@pytest.mark.parametrize("name,h,w", CASES)
@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_sample_exact_matches_pallas(name, h, w, padding_mode):
    arrays = _coords(name, h, w)
    dout = _dout(arrays[0])
    ref = _jax_sample(arrays, dout, padding_mode, "exact")
    ours = _port_sample(arrays, dout, padding_mode, "exact")
    for what, r, o in zip(NAMES, ref, ours):
        assert o.shape == r.shape, what
        np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-5, err_msg=what)


@pytest.mark.parametrize("name,h,w", CASES)
@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_sample_fast_matches_pallas_fast(name, h, w, padding_mode):
    arrays = _coords(name, h, w)
    dout = _dout(arrays[0])
    ref = _jax_sample(arrays, dout, padding_mode, "fast")
    ours = _port_sample(arrays, dout, padding_mode, "fast")
    exact = _port_sample(arrays, dout, padding_mode, "exact")
    for what, r, o in zip(NAMES, ref, ours):
        np.testing.assert_allclose(o, r, rtol=2e-2, atol=2e-2, err_msg=what)
        assert _share_within(o, r, 1e-5) >= 0.999, what
    if name != "integer":      # integer weights are exact in bf16
        assert np.abs(ours[0] - exact[0]).max() > 0      # fast really rounds


def test_sample_without_image_grad():
    """Where the image needs no grad (the model's last frame is data)
    d_img is not computed; the coordinates' gradients are unchanged."""
    arrays = _coords("edges", 16, 24)
    dout = _dout(arrays[0])
    full = _port_sample(arrays, dout, "border", "fast")
    ours = _port_sample(arrays, dout, "border", "fast", image_grad=False)
    assert ours[1] is None
    for o, r in zip(ours[2:], full[2:]):
        np.testing.assert_array_equal(o, r)


@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample_nhwc_matches_pallas(padding_mode, align_corners):
    """The public NHWC grid_sample on a normalized grid of another output
    size than the image, reaching past every edge, with its gradients."""
    import jax
    import jax.numpy as jnp
    from dynamic_multiview_3d_tpu.kernels import grid_sample_pallas as gsp
    rng = np.random.default_rng(4)
    img = rng.standard_normal((2, 16, 24, 3), dtype=np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 8, 20, 2)).astype(np.float32)
    cot = rng.standard_normal((2, 8, 20, 3), dtype=np.float32)
    out, vjp = jax.vjp(lambda i, g: gsp.grid_sample(
        i, g, align_corners=align_corners, padding_mode=padding_mode,
        interpret=True), jnp.asarray(img), jnp.asarray(grid))
    ref = [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(cot))]
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (img, grid)]
    ours = tgs.grid_sample(*ts, align_corners=align_corners,
                           padding_mode=padding_mode)
    ours.backward(torch.from_numpy(cot))
    for what, r, o in zip(("out", "d_img", "d_grid"), ref,
                          [ours.detach().numpy()] + [t.grad.numpy()
                                                     for t in ts]):
        assert o.shape == r.shape, what
        np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-5, err_msg=what)


@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_flow_warp_nhwc_matches_pallas(precision):
    import jax
    import jax.numpy as jnp
    from dynamic_multiview_3d_tpu.kernels import grid_sample_pallas as gsp
    img, flow, _, _ = _case("inside", 16, 24)
    cot = np.random.default_rng(5).standard_normal(img.shape,
                                                   dtype=np.float32)
    out, vjp = jax.vjp(lambda i, f: gsp.flow_warp(
        i, f, interpret=True, precision=precision), jnp.asarray(img),
        jnp.asarray(flow))
    ref = [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(cot))]
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (img, flow)]
    ours = tgs.flow_warp(*ts, precision=precision)
    ours.backward(torch.from_numpy(cot))
    tol = 1e-5 if precision == "exact" else 2e-2
    for what, r, o in zip(("out", "d_img", "d_flow"), ref,
                          [ours.detach().numpy()] + [t.grad.numpy()
                                                     for t in ts]):
        np.testing.assert_allclose(o, r, rtol=tol, atol=tol, err_msg=what)


def _shared(b=2, k=3, c=3, h=12, w=20, seed=6):
    """One frame per example, channels-last [B, C, H, W] (NHWC memory), and
    coordinates [B, K*H*W] reaching past every edge, as depth synthesis
    passes them; and the same as one contiguous frame per target, [B*K, C,
    H, W] with coordinates [B*K, H*W]."""
    rng = np.random.default_rng(seed)
    nhwc = torch.from_numpy(rng.uniform(-1, 1, (b, h, w, c))
                            .astype(np.float32))
    ix = torch.from_numpy(rng.uniform(-4, w + 3, (b * k, h * w))
                          .astype(np.float32))
    iy = torch.from_numpy(rng.uniform(-4, h + 3, (b * k, h * w))
                          .astype(np.float32))
    ix[:, :7], iy[:, 7:14] = w - 1, h - 1           # on the far edges
    frame = nhwc.permute(0, 3, 1, 2)
    per_target = frame.repeat_interleave(k, dim=0).contiguous()
    return ((frame, ix.reshape(b, -1), iy.reshape(b, -1)),
            (per_target, ix, iy))


@pytest.mark.parametrize("c", [1, 3, 5])
@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_shared_frame_matches_per_target_copy_bitwise(c, padding_mode,
                                                      precision):
    """The sample of a channels-last frame at its K targets' pixels equals,
    bit for bit, that of one contiguous copy per target; so do the
    coordinates' gradients. d_img, one per frame, is the per-target
    copies' sum over K (1e-6 of its largest magnitude: another order of
    the same sums)."""
    shared, copy = _shared(c=c)
    b, k = shared[0].shape[0], copy[0].shape[0] // shared[0].shape[0]
    assert c == 1 or tgs._build.channels_last(shared[0])
    out = tgs.sample_pixel_coords(*shared, padding_mode, precision)
    ref = tgs.sample_pixel_coords(*copy, padding_mode, precision)
    torch.testing.assert_close(
        out, ref.reshape(b, k, c, -1).transpose(1, 2).reshape(b, c, -1),
        rtol=0, atol=0)
    dout = torch.from_numpy(_dout(np.zeros(copy[0].shape, np.float32)))
    d_shared = tgs.sample_pixel_coords_bwd(
        *shared, dout.reshape(b, k, c, -1).transpose(1, 2).reshape(b, c, -1),
        padding_mode, precision)
    d_copy = tgs.sample_pixel_coords_bwd(*copy, dout, padding_mode,
                                         precision)
    for o, r in zip(d_shared[1:], d_copy[1:]):
        torch.testing.assert_close(o.reshape(r.shape), r, rtol=0, atol=0)
    summed = d_copy[0].reshape(b, k, *d_copy[0].shape[1:]).sum(1)
    torch.testing.assert_close(d_shared[0], summed, rtol=0,
                               atol=1e-6 * float(summed.abs().max()))


def test_sample_wrappers_check_inputs_and_count_no_cpu_launch():
    img, ix, iy = (torch.from_numpy(a) for a in _coords("inside", 16, 16))
    dout = torch.from_numpy(_dout(img.numpy()))
    before = (tgs.sample_pixel_coords.launches,
              tgs.warp_composite_pix_bwd.launches)
    out = tgs.sample_pixel_coords(img, ix, iy)
    grads = tgs.sample_pixel_coords_bwd(img, ix, iy, dout)
    assert (tgs.sample_pixel_coords.launches,
            tgs.warp_composite_pix_bwd.launches) == before   # CPU: plain
    assert out.shape == dout.shape and grads[0].shape == img.shape
    assert tgs.sample_pixel_coords_bwd(img, ix, iy, dout,
                                       need_img=False)[0] is None
    with pytest.raises(TypeError):
        tgs.sample_pixel_coords(img.double(), ix, iy)
    with pytest.raises(ValueError):
        tgs.sample_pixel_coords(img, ix[:, :-1], iy)
    with pytest.raises(ValueError):
        tgs.sample_pixel_coords(img, ix, iy, padding_mode="wrap")
    with pytest.raises(ValueError):
        tgs.sample_pixel_coords(img, ix, iy, precision="half")
    with pytest.raises(ValueError):
        tgs.sample_pixel_coords_bwd(img, ix, iy, dout[:, :, :-1])
    # contiguous or channels-last images; any other strides raise
    tgs.sample_pixel_coords(img.permute(0, 2, 3, 1).contiguous()
                            .permute(0, 3, 1, 2), ix, iy)
    with pytest.raises(ValueError, match="contiguous or channels-last"):
        tgs.sample_pixel_coords(img.transpose(2, 3).contiguous()
                                .transpose(2, 3), ix, iy)


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
@pytest.mark.parametrize("name,h,w,n", [("edges", 16, 24, 3),
                                        ("integer", 16, 16, 2),
                                        ("edges", 128, 128, 8)])
def test_cuda_sample_kernels_match_plain(cuda, precision, padding_mode, name,
                                         h, w, n):
    """The forward kernel and the no-composite backward launch against the
    plain versions: out, d_ix, d_iy to 1e-5 (bitwise expected), d_img
    (atomics, run-dependent order) to 1e-5 of its largest magnitude."""
    img, ix, iy = (torch.from_numpy(a).to(cuda)
                   for a in _coords(name, h, w, n))
    dout = torch.from_numpy(_dout(img.cpu().numpy())).to(cuda)
    before = (tgs.sample_pixel_coords.launches,
              tgs.warp_composite_pix_bwd.launches,
              tgs.warp_composite_pix_bwd.composite_launches)
    out = tgs.sample_pixel_coords(img, ix, iy, padding_mode, precision)
    grads = tgs.sample_pixel_coords_bwd(img, ix, iy, dout, padding_mode,
                                        precision)
    torch.cuda.synchronize()
    assert (tgs.sample_pixel_coords.launches,
            tgs.warp_composite_pix_bwd.launches,
            tgs.warp_composite_pix_bwd.composite_launches) == \
        (before[0] + 1, before[1] + 1, before[2])
    torch.testing.assert_close(out, tgs.sample_pixel_coords_plain(
        img, ix, iy, padding_mode, precision), rtol=0, atol=1e-5)
    ref = tgs.sample_pixel_coords_bwd_plain(img, ix, iy, dout, padding_mode,
                                            precision)
    for o, r in zip(grads[1:], ref[1:]):
        torch.testing.assert_close(o, r, rtol=0, atol=1e-5)
    scale = max(1.0, float(ref[0].abs().max()))
    assert float((grads[0] - ref[0]).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
@pytest.mark.parametrize("c,b,k,h,w", [(3, 2, 3, 12, 20), (1, 2, 3, 12, 20),
                                       (2, 2, 3, 12, 20), (4, 2, 3, 12, 20),
                                       (5, 2, 3, 12, 20),
                                       (3, 16, 8, 128, 128)])
def test_cuda_sample_shared_frame_matches_plain(cuda, precision,
                                                padding_mode, c, b, k, h, w):
    """The model's layout, one channels-last frame per example sampled at
    its K targets' pixels, for each C the kernel instantiates (1-4) and
    the general one (5), and the c2 shape: bitwise against the plain
    version on the same frame and on one contiguous copy per target."""
    shared, copy = _shared(b=b, k=k, c=c, h=h, w=w)
    shared = [t.to(cuda) for t in shared]
    copy = [t.to(cuda) for t in copy]
    before = tgs.sample_pixel_coords.launches
    out = tgs.sample_pixel_coords(*shared, padding_mode, precision)
    torch.cuda.synchronize()
    assert tgs.sample_pixel_coords.launches == before + 1
    torch.testing.assert_close(out, tgs.sample_pixel_coords_plain(
        *shared, padding_mode, precision), rtol=0, atol=0)
    ref = tgs.sample_pixel_coords_plain(*copy, padding_mode, precision)
    torch.testing.assert_close(
        out, ref.reshape(b, k, c, -1).transpose(1, 2).reshape(b, c, -1),
        rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_sample_autograd_goes_through_the_kernels(cuda):
    img, ix, iy = (torch.from_numpy(a).to(cuda)
                   for a in _coords("edges", 16, 24, 3))
    ix.requires_grad_(True)
    iy.requires_grad_(True)
    fwd, bwd = (tgs.sample_pixel_coords.launches,
                tgs.warp_composite_pix_bwd.launches)
    img_launches = tgs.warp_composite_pix_bwd.img_launches
    out = tgs.sample_pixel_coords(img, ix, iy, "border", "fast")
    dout = torch.randn_like(out)
    out.backward(dout)
    torch.cuda.synchronize()
    assert tgs.sample_pixel_coords.launches == fwd + 1
    assert tgs.warp_composite_pix_bwd.launches == bwd + 1
    assert tgs.warp_composite_pix_bwd.img_launches == img_launches
    ref = tgs.sample_pixel_coords_bwd_plain(img, ix.detach(), iy.detach(),
                                            dout, "border", "fast",
                                            need_img=False)
    torch.testing.assert_close(ix.grad, ref[1], rtol=0, atol=1e-5)
    torch.testing.assert_close(iy.grad, ref[2], rtol=0, atol=1e-5)
