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

The tests marked ``cuda`` hold the CUDA kernels to the plain versions on
the card; they skip without one:
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
