"""The port's fused warp + composite + validity (kernels/grid_sample.py).

On the CPU the port runs its plain version; it is held against the JAX
package's Pallas kernel run in interpret mode (as tests/test_pallas.py runs
it). Tolerances: "exact" 1e-5 (f32 both, sums in another order); "fast"
2e-2 against JAX's fast as the outer limit (both round the image and
y-weights to bf16, but a y-weight that lands on a bf16 rounding boundary can
round the other way: ~2^-8 relative on values up to ~4), and at least 99.9%
of the elements within 1e-5 of it, which pins down which operands are
rounded; 3e-2 against the port's exact.

The tests marked ``cuda`` hold the CUDA kernel to the plain version on the
card; they skip without one. JAX is imported inside the tests that need it,
so those tests run where JAX is not installed:
``python -m pytest --noconftest tests/test_torch_kernels.py -m cuda``. The
backward's tests are in tests/test_torch_kernels_bwd.py.
"""

import numpy as np
import pytest
import torch

from dynamic_multiview_3d_torch.kernels import _build
from dynamic_multiview_3d_torch.kernels import grid_sample as tgs


def _case(name, h=16, w=16, n=2, c=3, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((n, h, w, c), dtype=np.float32)
    if name == "edges":              # flows that push off every edge
        lim = 1.5 * max(h, w)
        flow = rng.uniform(-lim, lim, (n, h, w, 2)).astype(np.float32)
    elif name == "integer":          # exact-integer coords, on the borders too
        flow = rng.integers(-4, 5, (n, h, w, 2)).astype(np.float32)
        flow[:, :, 0, 0] = 0.0                         # x = 0
        flow[:, :, -1, 0] = 0.0                        # x = W-1
        flow[:, 0, :, 1] = 0.0                         # y = 0
        flow[:, -1, :, 1] = 0.0                        # y = H-1
    else:                            # mostly inside, some off the edge
        flow = rng.uniform(-6, 6, (n, h, w, 2)).astype(np.float32)
    mask = rng.uniform(0.0, 1.0, (n, h, w, 1)).astype(np.float32)
    rgb = rng.standard_normal((n, h, w, c), dtype=np.float32)
    return img, flow, mask, rgb


def _jax_composite(arrays, padding_mode, precision):
    import jax.numpy as jnp
    from dynamic_multiview_3d_tpu.kernels import grid_sample_pallas as gsp
    out = gsp.flow_warp_composite(*(jnp.asarray(a) for a in arrays),
                                  padding_mode=padding_mode, interpret=True,
                                  precision=precision)
    return [np.asarray(o) for o in out]


def _port_composite(arrays, padding_mode, precision):
    out = tgs.flow_warp_composite(*(torch.from_numpy(a) for a in arrays),
                                  padding_mode=padding_mode,
                                  precision=precision)
    return [o.numpy() for o in out]


def _share_within(a, b, tol):
    """Fraction of the elements of a and b that agree within tol."""
    return float(np.mean(np.abs(a - b) <= tol))


CASES = [("edges", 16, 16), ("integer", 16, 16), ("inside", 16, 24),
         ("edges", 16, 24)]


@pytest.mark.parametrize("name,h,w", CASES)
@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_plain_exact_matches_pallas(name, h, w, padding_mode):
    arrays = _case(name, h, w)
    ref = _jax_composite(arrays, padding_mode, "exact")
    ours = _port_composite(arrays, padding_mode, "exact")
    for r, o in zip(ref[:2], ours[:2]):                 # view, warped
        np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ours[2], ref[2])      # valid
    assert ours[2].shape == (2, h, w)


@pytest.mark.parametrize("name,h,w", CASES)
def test_plain_fast_matches_pallas_fast(name, h, w):
    arrays = _case(name, h, w)
    ref = _jax_composite(arrays, "border", "fast")
    ours = _port_composite(arrays, "border", "fast")
    exact = _port_composite(arrays, "border", "exact")
    for r, o, e in zip(ref[:2], ours[:2], exact[:2]):
        np.testing.assert_allclose(o, r, rtol=2e-2, atol=2e-2)
        assert _share_within(o, r, 1e-5) >= 0.999
        np.testing.assert_allclose(o, e, rtol=3e-2, atol=3e-2)
        assert np.abs(o - e).max() > 0          # fast really rounds
    np.testing.assert_array_equal(ours[2], ref[2])


@pytest.mark.parametrize("name,h,w", [c for c in CASES if c[0] != "integer"])
def test_fast_check_rejects_unrounded_y_weights(name, h, w):
    """A planted fast mode that rounds the image but keeps the y-weights in
    f32 (exact mode on a bf16-rounded image) stays inside the 2e-2 limit but
    fails the 1e-5 share check above. Integer coordinates are left out:
    their y-weights are 0 and 1, which bf16 holds exactly."""
    img, *rest = _case(name, h, w)
    img_b = torch.from_numpy(img).to(torch.bfloat16).float().numpy()
    ref = _jax_composite([img, *rest], "border", "fast")
    planted = _port_composite([img_b, *rest], "border", "exact")
    for r, o in zip(ref[:2], planted[:2]):
        np.testing.assert_allclose(o, r, rtol=2e-2, atol=2e-2)
        assert _share_within(o, r, 1e-5) < 0.999


def test_wrapper_checks_inputs_and_counts_no_cpu_launch():
    img, flow, mask, rgb = (torch.from_numpy(a) for a in _case("inside"))
    n, h, w, c = img.shape
    img_nchw = img.permute(0, 3, 1, 2).contiguous()
    ix = flow[..., 0].reshape(n, h * w).contiguous()
    iy = flow[..., 1].reshape(n, h * w).contiguous()
    m = mask.reshape(n, h * w)
    r = rgb.permute(0, 3, 1, 2).reshape(n, c, h * w).contiguous()
    before = tgs.warp_composite_pix.launches
    tgs.warp_composite_pix(img_nchw, ix, iy, m, r)
    assert tgs.warp_composite_pix.launches == before     # CPU: plain version
    with pytest.raises(TypeError):
        tgs.warp_composite_pix(img_nchw.double(), ix, iy, m, r)
    with pytest.raises(ValueError):
        tgs.warp_composite_pix(img_nchw, ix[:, :-1], iy, m, r)
    # contiguous, channels-last or staged images; any other strides raise
    ref = tgs.warp_composite_pix(img_nchw, ix, iy, m, r)[0]
    for layout in (img.permute(0, 3, 1, 2), _build.stage(img_nchw)):
        torch.testing.assert_close(
            tgs.warp_composite_pix(layout, ix, iy, m, r)[0], ref, rtol=0,
            atol=0)
    with pytest.raises(ValueError, match="contiguous or channels-last"):
        tgs.warp_composite_pix(img_nchw.transpose(2, 3).contiguous()
                               .transpose(2, 3), ix, iy, m, r)
    with pytest.raises(ValueError):
        tgs.warp_composite_pix(img_nchw, ix, iy, m, r, precision="half")
    with pytest.raises(ValueError):
        tgs.warp_composite_pix(img_nchw, ix, iy, m, r, padding_mode="wrap")


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
def test_cuda_kernel_matches_plain(cuda, precision, padding_mode, name, h, w,
                                   n):
    arrays = [torch.from_numpy(a).to(cuda) for a in _case(name, h, w, n)]
    before = tgs.warp_composite_pix.launches
    ours = tgs.flow_warp_composite(*arrays, padding_mode=padding_mode,
                                   precision=precision)
    torch.cuda.synchronize()
    assert tgs.warp_composite_pix.launches == before + 1
    ref = tgs.flow_warp_composite_plain(*arrays, padding_mode=padding_mode,
                                        precision=precision)
    for o, r in zip(ours, ref):
        torch.testing.assert_close(o, r, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_kernel_on_a_gpu_other_than_the_current_one(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    dev = torch.device("cuda", 1)
    assert torch.cuda.current_device() != 1
    arrays = [torch.from_numpy(a).to(dev) for a in _case("edges", 16, 24, 3)]
    ours = tgs.flow_warp_composite(*arrays, precision="fast")
    torch.cuda.synchronize(dev)
    ref = tgs.flow_warp_composite_plain(*arrays, precision="fast")
    for o, r in zip(ours, ref):
        assert o.device == dev
        torch.testing.assert_close(o, r, rtol=1e-5, atol=1e-5)
