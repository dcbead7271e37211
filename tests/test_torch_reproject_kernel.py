"""The port's fused depth reprojection (kernels/reproject.py: sites #6 and #7
and their fused backward).

On the CPU the port runs its plain versions. They are held against the
JAX package's ``reproject_pallas`` with the Pallas kernels in interpret
mode, as tests/test_pallas.py runs them:

- ``host_params`` against ``_host_params`` (1e-6 of each matrix's largest
  entry: the reference's einsum sums the 3x3 products in another order);
- the plain forwards against ``_call_fused`` / ``_call_fused_composite``
  on the same camera scalars (1e-5: the same operations, f32), and the
  NHWC wrappers against ``depth_reproject_sample`` / ``_composite`` on the
  same cameras: "exact" 1e-4, the JAX package's own bar for these kernels
  (tests/test_pallas.py): the scalars differ by ulps between the two
  frameworks, which moves a coordinate by ulps (measured: one element of
  1,536 off by 1.03e-5 in the "near" case, all others within 1e-5); "fast"
  2e-2 (a y-weight on a bf16 rounding boundary may round the other way, as
  in tests/test_torch_kernels.py);
- the hand-written backward (d_img, d_depth, d_mask, d_rgb) against
  ``jax.vjp`` of the same wrappers: "exact" 1e-4, "fast" 5e-2, both of each
  gradient's largest magnitude where that exceeds 1 (the bars of
  tests/test_pallas.py for these kernels).

Every parametrised test runs the "mixed" case, whose batch has pixels that
reproject behind the source camera (q.z <= 1e-6: the far coordinate,
which samples 0) and pixels whose correspondence falls off the image
(``test_every_case_has_invalid_and_off_image_pixels``), beside the "near"
case of tests/test_pallas.py (small camera moves, depth 1.5-2.5).

The source frame may be shared: depth synthesis passes one frame per
example for its K targets (target n reads frame n // K): on the CPU the
NHWC frame as a channels-last [N/K, C, H, W] view, on CUDA that frame
staged as [N/K, H, W, 4] (``_build.stage``), the layout the kernels read
three channels in. On either layout the plain versions are bitwise equal
to those on the frame repeated K times, d_img being the repeats' sum over
K, and to those on the unstaged frame, and agree with the Pallas kernels
fed the repeated frame at the bars above. The wrappers refuse camera
scalars that do not start on a 16-byte boundary and a frame with the
staged strides that does not. The edge cases "invalid" (no pixel valid)
and "off" (every correspondence off the image) sample zeros, as the
Pallas kernels do.

The tests marked ``cuda`` hold the CUDA kernels to the plain versions on
the card, on both layouts; they skip without one:
``python -m pytest --noconftest tests/test_torch_reproject_kernel.py -m
cuda``.
"""

import numpy as np
import pytest
import torch

from dynamic_multiview_3d_torch.kernels import _build
from dynamic_multiview_3d_torch.kernels import reproject as trp
from dynamic_multiview_3d_torch.kernels._build import channels_last as \
    _channels_last
from dynamic_multiview_3d_torch.ops import pose as tpose


def _cameras(pose_a, pose_b, n, w, h):
    """Intrinsics [N, 3, 3] (focal max(h, w), centred) and the transform
    from the camera at pose_b (target) to the one at pose_a (source)
    [N, 4, 4], float32 numpy, computed by the port's pose ops."""
    k = tpose.intrinsics_matrix(torch.full((n,), float(max(h, w))),
                                (w - 1) / 2.0, (h - 1) / 2.0)
    rel = tpose.relative_transform(
        tpose.look_at_extrinsics(torch.from_numpy(pose_a)),
        tpose.look_at_extrinsics(torch.from_numpy(pose_b)))
    return k.numpy(), rel.numpy()


def _inputs(name, n=2, h=16, w=16, c=3, seed=0):
    """(img [N,H,W,C], depth [N,H,W], K, rel, mask [N,H,W,1], rgb), numpy
    float32."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((n, h, w, c), dtype=np.float32)
    if name == "near":            # tests/test_pallas.py's depths and cameras
        depth = rng.uniform(1.5, 2.5, (n, h, w))
        pa = rng.uniform(0.1, 1.0, (n, 3)) + [0, 0, 1.5]
        pb = rng.uniform(0.1, 1.0, (n, 3)) + [0, 0, 1.5]
    else:                          # "mixed": a source camera facing the
        depth = rng.uniform(0.5, 6.0, (n, h, w))   # target, and a wide turn
        pb = np.array([[0.3, 0.2, 2.0], [0.1, 0.3, 2.0]] * n)[:n]
        pa = pb + np.array([[np.pi + 0.3, -0.1, 0.0], [0.9, -0.1, -0.5]] * n
                           )[:n]
    k, rel = _cameras(pa.astype(np.float32), pb.astype(np.float32), n, w, h)
    mask = rng.uniform(0.0, 1.0, (n, h, w, 1))
    rgb = rng.standard_normal((n, h, w, c))
    return [a.astype(np.float32) for a in (img, depth, k, rel, mask, rgb)]


CASES = [("mixed", 16, 16), ("near", 16, 16), ("mixed", 16, 24),
         ("near", 12, 20)]


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _pix(arrays):
    """The pixel-level inputs of the port's kernels: img [N,C,H,W], depth
    [N,P], params [N,12], mask [N,P], rgb [N,C,P] (torch, CPU)."""
    img, depth, k, rel, mask, rgb = _t(arrays)
    n, h, w, c = img.shape
    return (img.permute(0, 3, 1, 2).contiguous(), depth.reshape(n, h * w),
            trp.host_params(k, rel), mask.reshape(n, h * w),
            rgb.permute(0, 3, 1, 2).reshape(n, c, h * w).contiguous())


def test_every_case_has_invalid_and_off_image_pixels():
    for name, h, w in CASES:
        img, depth, params, _, _ = _pix(_inputs(name, h=h, w=w))
        cr = trp.correspondence_plain(depth, params, h, w)
        valid = cr["valid"] > 0
        off = valid & ((cr["x"] < 0) | (cr["x"] > w - 1) | (cr["y"] < 0)
                       | (cr["y"] > h - 1))
        inside = valid & ~off
        if name == "mixed":
            assert 0 < int((~valid).sum()) and 0 < int(off.sum()), name
        assert int(inside.sum()) > 0.2 * valid.numel(), name


@pytest.mark.parametrize("name,h,w", CASES)
def test_host_params_matches_jax(name, h, w):
    import jax.numpy as jnp
    from dynamic_multiview_3d_tpu.kernels import reproject_pallas as jrp
    _, _, k, rel, _, _ = _inputs(name, h=h, w=w)
    ours = trp.host_params(*_t((k, rel))).numpy()
    ref = np.asarray(jrp._host_params(jnp.asarray(k), jnp.asarray(rel)))
    assert ours.shape == ref.shape == (2, 12)
    for cols in (slice(0, 9), slice(9, 12)):                 # M, then m
        scale = np.abs(ref[:, cols]).max()
        np.testing.assert_allclose(ours[:, cols], ref[:, cols], rtol=0,
                                   atol=1e-6 * scale)


@pytest.mark.parametrize("name,h,w", CASES)
@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_plain_kernels_match_pallas_on_the_same_params(name, h, w, precision):
    """The plain #6 and #7 against the interpret-mode TPU kernels fed the
    same 12 camera scalars: the kernels' arithmetic alone."""
    import jax.numpy as jnp
    from dynamic_multiview_3d_tpu.kernels import reproject_pallas as jrp
    img, depth, params, mask, rgb = _pix(_inputs(name, h=h, w=w))
    j = [jnp.asarray(t.numpy()) for t in (img, depth, params, mask, rgb)]
    out, valid = (np.asarray(a) for a in jrp._call_fused(
        j[0], j[1], j[2], True, precision))
    geo, valid_s = trp.reproject_sample_pix(img, depth, params, precision)
    view, geo_c, valid_c = trp.reproject_composite_pix(img, depth, params,
                                                       mask, rgb, precision)
    rv, rg, rvalid = (np.asarray(a) for a in jrp._call_fused_composite(
        j[0], j[1], j[2], j[3], j[4], True, precision))
    for v in (valid_s, valid_c):
        np.testing.assert_array_equal(v.numpy(), valid)
    np.testing.assert_array_equal(rvalid, valid)
    tol = 1e-5 if precision == "exact" else 2e-2
    for o, r in ((geo, out * valid[:, None]), (geo_c, rg), (view, rv)):
        np.testing.assert_allclose(o.numpy(), r, rtol=tol, atol=tol)
    torch.testing.assert_close(geo_c, geo, rtol=0, atol=0)


def _jax_fns(precision):
    from dynamic_multiview_3d_tpu.kernels import reproject_pallas as jrp

    def sample(img, depth, k, rel):
        view, valid = jrp.depth_reproject_sample(img, depth, k, rel, True,
                                                 precision)
        return (view,), valid

    def composite(img, depth, k, rel, mask, rgb):
        view, geo, valid = jrp.depth_reproject_composite(
            img, depth, k, rel, mask, rgb, True, precision)
        return (view, geo), valid
    return sample, composite


def _port_fns(precision):
    def sample(img, depth, k, rel):
        view, valid = trp.depth_reproject_sample(img, depth, k, rel,
                                                 precision)
        return (view,), valid

    def composite(img, depth, k, rel, mask, rgb):
        view, geo, valid = trp.depth_reproject_composite(
            img, depth, k, rel, mask, rgb, precision)
        return (view, geo), valid
    return sample, composite


def _jax_run(arrays, which, precision, cots):
    """Outputs, valid and the VJP of JAX's wrapper for the cotangents of
    its differentiable outputs (None: zero), w.r.t. img, depth and, for
    the composite, mask and rgb."""
    import jax
    import jax.numpy as jnp
    fn = _jax_fns(precision)[which == "composite"]
    args = [jnp.asarray(a) for a in arrays[:6 if which == "composite"
                                           else 4]]
    nd = (2, 3)                                     # the cameras

    def f(*diff):
        full = list(diff[:2]) + args[2:4] + list(diff[2:])
        return fn(*full)[0]
    diff = [a for i, a in enumerate(args) if i not in nd]
    outs, vjp = jax.vjp(f, *diff)
    valid = fn(*args)[1]
    cts = tuple(jnp.zeros_like(o) if c is None else jnp.asarray(c)
                for o, c in zip(outs, cots))
    return ([np.asarray(o) for o in outs], np.asarray(valid),
            [np.asarray(g) for g in vjp(cts)])


def _port_run(arrays, which, precision, cots, image_grad=True):
    fn = _port_fns(precision)[which == "composite"]
    ts = _t(arrays[:6 if which == "composite" else 4])
    for i, t in enumerate(ts):
        if i not in (2, 3):
            t.requires_grad_(image_grad or i > 0)
    outs, valid = fn(*ts)
    pairs = [(o, torch.from_numpy(c)) for o, c in zip(outs, cots)
             if c is not None]
    torch.autograd.backward([o for o, _ in pairs], [c for _, c in pairs])
    for i in (2, 3):
        assert ts[i].grad is None                   # the cameras: no grad
    assert not valid.requires_grad
    return ([o.detach().numpy() for o in outs], valid.numpy(),
            [None if t.grad is None else t.grad.numpy()
             for i, t in enumerate(ts) if i not in (2, 3)])


def _cots(arrays, which, with_geo=True, seed=1):
    rng = np.random.default_rng(seed)
    shape = arrays[0].shape
    d_view = rng.standard_normal(shape, dtype=np.float32)
    if which == "sample":
        return (d_view,)
    return (d_view, rng.standard_normal(shape, dtype=np.float32)
            if with_geo else None)


GRADS = {"sample": ("d_img", "d_depth"),
         "composite": ("d_img", "d_depth", "d_mask", "d_rgb")}


@pytest.mark.parametrize("name,h,w", CASES)
@pytest.mark.parametrize("which", ["sample", "composite"])
@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_reproject_matches_pallas_and_its_vjp(name, h, w, which, precision):
    arrays = _inputs(name, h=h, w=w)
    cots = _cots(arrays, which)
    r_out, r_valid, r_grads = _jax_run(arrays, which, precision, cots)
    o_out, o_valid, o_grads = _port_run(arrays, which, precision, cots)
    np.testing.assert_array_equal(o_valid, r_valid)
    tol = 1e-4 if precision == "exact" else 2e-2
    for o, r in zip(o_out, r_out):
        assert o.shape == r.shape
        np.testing.assert_allclose(o, r, rtol=tol, atol=tol)
    gtol = 1e-4 if precision == "exact" else 5e-2
    for what, o, r in zip(GRADS[which], o_grads, r_grads):
        assert o.shape == r.shape, what
        np.testing.assert_allclose(o, r, rtol=gtol,
                                   atol=gtol * max(np.abs(r).max(), 1.0),
                                   err_msg=what)
        if what == "d_depth":       # behind the camera: no depth gradient
            assert not np.any(o[r_valid == 0]), what


@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_composite_without_geo_cotangent_or_image_grad(precision):
    """The composite's backward with only the view in the loss (d_geo
    None, not read) and an image that needs no grad (d_img not
    computed), as the model's frame is data."""
    arrays = _inputs("mixed", h=16, w=24)
    cots = _cots(arrays, "composite", with_geo=False)
    _, _, r_grads = _jax_run(arrays, "composite", precision, cots)
    _, _, o_grads = _port_run(arrays, "composite", precision, cots,
                              image_grad=False)
    assert o_grads[0] is None
    gtol = 1e-4 if precision == "exact" else 5e-2
    for what, o, r in zip(GRADS["composite"][1:], o_grads[1:], r_grads[1:]):
        np.testing.assert_allclose(o, r, rtol=gtol,
                                   atol=gtol * max(np.abs(r).max(), 1.0),
                                   err_msg=what)


def test_plain_backward_is_not_autograd_of_the_plain_forward():
    """The hand-written backward's d_depth equals autograd through the
    plain forward away from tap boundaries (here: every pixel of the
    "near" case), so the chain rule to the depth is the forward's."""
    img, depth, params, mask, rgb = _pix(_inputs("near"))
    depth = depth.clone().requires_grad_(True)
    geo, _ = trp.reproject_sample_pix_plain(img, depth, params)
    d_geo = torch.from_numpy(_cots([geo.detach().numpy()], "sample")[0])
    geo.backward(d_geo)
    ours = trp.reproject_pix_bwd(img, depth.detach(), params, None, None,
                                 None, d_geo, need_img=False)
    torch.testing.assert_close(ours[1], depth.grad, rtol=1e-4, atol=1e-5)


def _shared(name, n_src=2, k=3, h=16, w=16, c=3, layout="channels_last"):
    """The pixel-level inputs with N_src frames shared by K targets each:
    (img [N_src,C,H,W] in ``layout``, depth, params, mask, rgb for the
    N = N_src*K targets), and the same with the frame repeated per target
    ([N,C,H,W], contiguous). ``layout`` "staged" (3 channels): the frames
    as ``_build.stage`` puts them."""
    img, depth, params, mask, rgb = _pix(_inputs(name, n=n_src * k, h=h,
                                                 w=w, c=c))
    frames = img[::k].contiguous()
    if layout == "channels_last":
        frames = frames.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
    elif layout == "staged":
        frames = _build.stage(frames)
    per_target = frames.repeat_interleave(k, dim=0).contiguous()
    return ((frames, depth, params, mask, rgb),
            (per_target, depth, params, mask, rgb))


def _launches(d_view, d_geo):
    """The backward's launches: (mask and rgb given, d_view, d_geo,
    need_img) of the sample launch and of the composite launch with and
    without d_geo."""
    return [(False, None, d_geo, True), (True, d_view, d_geo, True),
            (True, d_view, None, True)]


@pytest.mark.parametrize("name,h,w", CASES)
@pytest.mark.parametrize("layout", ["contiguous", "channels_last", "staged"])
@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_shared_frame_plain_matches_repeated_bitwise(name, h, w, layout,
                                                     precision):
    shared, repeated = _shared(name, h=h, w=w, layout=layout)
    img_s, img_r = shared[0], repeated[0]
    rest = shared[1:]
    assert _channels_last(img_s) == (layout == "channels_last")
    for ours, ref in (
            (trp.reproject_sample_pix(img_s, *rest[:2], precision),
             trp.reproject_sample_pix(img_r, *rest[:2], precision)),
            (trp.reproject_composite_pix(img_s, *rest, precision),
             trp.reproject_composite_pix(img_r, *rest, precision))):
        for o, r in zip(ours, ref):
            torch.testing.assert_close(o, r, rtol=0, atol=0)
    g = torch.Generator().manual_seed(2)
    d_view, d_geo = (torch.randn(rest[-1].shape, generator=g)
                     for _ in range(2))
    n_src, k = img_s.shape[0], img_r.shape[0] // img_s.shape[0]
    for composite, dv, dg, need in _launches(d_view, d_geo):
        m, r = (rest[2], rest[3]) if composite else (None, None)
        ours = trp.reproject_pix_bwd(img_s, *rest[:2], m, r, dv, dg,
                                     precision, need)
        ref = trp.reproject_pix_bwd(img_r, *rest[:2], m, r, dv, dg,
                                    precision, need)
        assert ours[0].shape == img_s.shape
        torch.testing.assert_close(
            ours[0], ref[0].reshape(n_src, k, *img_s.shape[1:]).sum(1),
            rtol=0, atol=0)
        for o, rr in zip(ours[1:], ref[1:]):
            assert (o is None) == (rr is None)
            if rr is not None:
                torch.testing.assert_close(o, rr, rtol=0, atol=0)


@pytest.mark.parametrize("name,h,w", CASES)
@pytest.mark.parametrize("which", ["sample", "composite"])
@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_shared_frame_matches_pallas_on_the_repeated_frame(name, h, w, which,
                                                           precision):
    """The port on the shared channels-last frame against the reference's
    wrappers on the frame repeated per target, with their VJP (d_img summed
    over each frame's K targets), at the bars of
    ``test_reproject_matches_pallas_and_its_vjp``."""
    _shared_against_pallas(name, h, w, which, precision, staged=False)


@pytest.mark.parametrize("name,h,w", CASES)
@pytest.mark.parametrize("which", ["sample", "composite"])
@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_staged_frame_matches_pallas_on_the_repeated_frame(name, h, w, which,
                                                           precision):
    """The same on the shared frame staged as the model stages it on
    CUDA."""
    _shared_against_pallas(name, h, w, which, precision, staged=True)


def _shared_against_pallas(name, h, w, which, precision, staged):
    k = 3
    arrays = _inputs(name, n=2 * k, h=h, w=w)
    arrays[0] = np.repeat(arrays[0][::k], k, axis=0)   # K targets a frame
    cots = _cots(arrays, which)
    r_out, r_valid, r_grads = _jax_run(arrays, which, precision, cots)
    img, depth, k_mat, rel, mask, rgb = _t(arrays)
    n, c = img.shape[0], img.shape[-1]
    frame = img[::k].clone().permute(0, 3, 1, 2)
    if staged:
        frame = _build.stage(frame)
        assert _build.staged(frame)
    frame.requires_grad_(True)
    depth = depth.reshape(n, h * w).requires_grad_(True)
    params = trp.host_params(k_mat, rel)
    if which == "sample":
        geo, valid = trp.reproject_sample_pix(frame, depth, params,
                                              precision)
        outs, leaves = (geo,), (frame, depth)
    else:
        mask = mask.reshape(n, h * w).requires_grad_(True)
        rgb = rgb.permute(0, 3, 1, 2).reshape(n, c, h * w).contiguous() \
            .requires_grad_(True)
        view, geo, valid = trp.reproject_composite_pix(frame, depth, params,
                                                       mask, rgb, precision)
        outs, leaves = (view, geo), (frame, depth, mask, rgb)

    def nhwc(x):
        return x.detach().reshape(n, c, h, w).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(valid.reshape(n, h, w).numpy(), r_valid)
    tol = 1e-4 if precision == "exact" else 2e-2
    for o, r in zip(outs, r_out):
        np.testing.assert_allclose(nhwc(o), r, rtol=tol, atol=tol)
    torch.autograd.backward(
        list(outs), [torch.from_numpy(ct).permute(0, 3, 1, 2)
                     .reshape(n, c, h * w) for ct in cots])
    r_grads[0] = r_grads[0].reshape(n // k, k, h, w, c).sum(1)
    o_grads = [frame.grad.permute(0, 2, 3, 1), depth.grad.reshape(n, h, w)]
    if which == "composite":
        o_grads += [mask.grad.reshape(n, h, w, 1), nhwc(rgb.grad)]
    gtol = 1e-4 if precision == "exact" else 5e-2
    for what, o, r in zip(GRADS[which], o_grads, r_grads):
        o = np.asarray(o)
        assert o.shape == r.shape, what
        np.testing.assert_allclose(o, r, rtol=gtol,
                                   atol=gtol * max(np.abs(r).max(), 1.0),
                                   err_msg=what)


def test_wrappers_check_inputs_and_count_no_cpu_launch():
    img, depth, params, mask, rgb = _pix(_inputs("mixed"))
    d_view = torch.ones_like(rgb)
    counters = (trp.reproject_sample_pix, trp.reproject_composite_pix,
                trp.reproject_pix_bwd)
    before = [f.launches for f in counters]
    trp.reproject_sample_pix(img, depth, params)
    trp.reproject_composite_pix(img, depth, params, mask, rgb)
    grads = trp.reproject_pix_bwd(img, depth, params, mask, rgb, d_view, None)
    assert [f.launches for f in counters] == before       # CPU: plain
    assert grads[0].shape == img.shape and grads[1].shape == depth.shape
    assert trp.reproject_pix_bwd(img, depth, params, None, None, None,
                                 d_view)[2:] == (None, None)
    with pytest.raises(ValueError, match="d_geo"):
        trp.reproject_pix_bwd(img, depth, params, None, None, None, None)
    with pytest.raises(ValueError, match="d_view"):
        trp.reproject_pix_bwd(img, depth, params, mask, rgb, None, d_view)
    with pytest.raises(TypeError):
        trp.reproject_sample_pix(img, depth.double(), params)
    with pytest.raises(ValueError):
        trp.reproject_sample_pix(img, depth[:, :-1], params)
    with pytest.raises(ValueError):
        trp.reproject_sample_pix(img, depth, params[:, :9])
    with pytest.raises(ValueError):
        trp.reproject_composite_pix(img, depth, params, mask,
                                    rgb.transpose(1, 2).contiguous()
                                    .transpose(1, 2))
    with pytest.raises(ValueError):
        trp.reproject_sample_pix(img, depth, params, precision="half")
    # N_src frames for N targets: N must be a multiple of N_src
    three = torch.cat([img, img[:1]])
    with pytest.raises(ValueError, match="share"):
        trp.reproject_sample_pix(three, depth, params)
    with pytest.raises(ValueError, match="contiguous or channels-last"):
        trp.reproject_sample_pix(img.transpose(2, 3).contiguous()
                                 .transpose(2, 3), depth, params)


@pytest.mark.parametrize("name,h,w", CASES)
@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_staged_frame_matches_unstaged_bitwise(name, h, w, precision):
    """Both forwards and the three backward launches on the shared frames
    staged (``_build.stage``, as the model hands them over on CUDA) give
    what they give on the same frames unstaged, bit for bit."""
    (frames, *rest), _ = _shared(name, h=h, w=w)
    staged = _build.stage(frames)
    assert _build.staged(staged) and not _build.staged(frames)
    for fn, args in ((trp.reproject_sample_pix, rest[:2]),
                     (trp.reproject_composite_pix, rest)):
        for o, r in zip(fn(staged, *args, precision),
                        fn(frames, *args, precision)):
            torch.testing.assert_close(o, r, rtol=0, atol=0)
    g = torch.Generator().manual_seed(2)
    d_view, d_geo = (torch.randn(rest[-1].shape, generator=g)
                     for _ in range(2))
    for composite, dv, dg, need in _launches(d_view, d_geo):
        m, r = (rest[2], rest[3]) if composite else (None, None)
        ours = trp.reproject_pix_bwd(staged, *rest[:2], m, r, dv, dg,
                                     precision, need)
        ref = trp.reproject_pix_bwd(frames, *rest[:2], m, r, dv, dg,
                                    precision, need)
        for o, rr in zip(ours, ref):
            assert (o is None) == (rr is None)
            if rr is not None:
                torch.testing.assert_close(o, rr, rtol=0, atol=0)


def test_wrappers_raise_on_misaligned_params_or_staged_frame():
    """The kernels read an image's 12 camera scalars as three 16-byte loads
    and a staged tap as one: params that do not start on a 16-byte
    boundary, and a frame with the staged strides that does not, are
    refused on either device."""
    img, depth, params, mask, rgb = _pix(_inputs("mixed"))
    odd = torch.empty(params.numel() + 1)[1:].view_as(params)
    odd.copy_(params)
    assert odd.data_ptr() % 16 and odd.is_contiguous()
    d_geo = torch.ones_like(rgb)
    for call in (lambda: trp.reproject_sample_pix(img, depth, odd),
                 lambda: trp.reproject_composite_pix(img, depth, odd, mask,
                                                     rgb),
                 lambda: trp.reproject_pix_bwd(img, depth, odd, None, None,
                                               None, d_geo)):
        with pytest.raises(ValueError, match="16-byte"):
            call()
    n, c, h, w = img.shape
    bad = torch.empty(n * h * w * 4 + 1)[1:].view(n, h, w, 4)[..., :3] \
        .movedim(-1, 1)
    bad.copy_(img)
    assert bad.stride() == _build.stage(img).stride()
    assert not _build.staged(bad)
    for call in (lambda: trp.reproject_sample_pix(bad, depth, params),
                 lambda: trp.reproject_pix_bwd(bad, depth, params, None,
                                               None, None, d_geo)):
        with pytest.raises(ValueError, match="staged"):
            call()


def _edge_params(kind, n):
    """Camera scalars [N, 12] under which no pixel is valid ("invalid":
    q.z = depth - 10 < 0 for depths in [0.5, 6]) or every correspondence
    lies far off the image ("off": x = u + 1e4 at q.z = depth)."""
    params = torch.zeros((n, 12))
    params[:, [0, 4, 8]] = 1.0                          # M = I
    if kind == "invalid":
        params[:, 11] = -10.0
    else:
        params[:, [2, 5]] = 1e4
    return params


@pytest.mark.parametrize("kind", ["invalid", "off"])
@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_edge_cases_sample_zeros_as_pallas_does(kind, precision):
    """No pixel valid, or every tap off the image: geo is 0, valid 0 or 1,
    the view is (1 - mask) * rgb, as the interpret-mode Pallas kernels
    give on the same camera scalars; the backward gives d_depth 0."""
    import jax.numpy as jnp
    from dynamic_multiview_3d_tpu.kernels import reproject_pallas as jrp
    img, depth, _, mask, rgb = _pix(_inputs("mixed", h=16, w=24))
    params = _edge_params(kind, img.shape[0])
    j = [jnp.asarray(t.numpy()) for t in (img, depth, params, mask, rgb)]
    view, geo, valid = trp.reproject_composite_pix(img, depth, params, mask,
                                                   rgb, precision)
    rv, rg, rvalid = (np.asarray(a) for a in jrp._call_fused_composite(
        *j, True, precision))
    np.testing.assert_array_equal(valid.numpy(), rvalid)
    assert float(valid.max()) == (0.0 if kind == "invalid" else 1.0)
    assert not torch.any(geo) and not np.any(rg)
    np.testing.assert_allclose(view.numpy(), rv, rtol=0, atol=1e-6)
    torch.testing.assert_close(view, (1.0 - mask[:, None]) * rgb, rtol=0,
                               atol=0)
    d_view = torch.ones_like(rgb)
    grads = trp.reproject_pix_bwd(img, depth, params, mask, rgb, d_view,
                                  d_view, precision)
    assert not torch.any(grads[0]) and not torch.any(grads[1])


# ---------------------------------------------------------------- on the card
@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("name,h,w,n", [("mixed", 16, 24, 2),
                                        ("near", 16, 16, 2),
                                        ("mixed", 128, 128, 2)])
def test_cuda_reproject_kernels_match_plain(cuda, precision, name, h, w, n):
    """Both forward entries and the three backward launches (sample;
    composite with and without d_geo; d_img on and off) against the plain
    versions: every per-pixel output to 1e-5 (bitwise expected), d_img
    (atomics) to 1e-5 of its largest magnitude."""
    args = [t.to(cuda) for t in _pix(_inputs(name, n=n, h=h, w=w))]
    img, depth, params, mask, rgb = args
    g = torch.Generator(device=cuda).manual_seed(0)
    d_view, d_geo = (torch.randn(rgb.shape, generator=g, device=cuda)
                     for _ in range(2))
    counters = (trp.reproject_sample_pix, trp.reproject_composite_pix,
                trp.reproject_pix_bwd)
    before = [f.launches for f in counters]
    ours = [trp.reproject_sample_pix(img, depth, params, precision),
            trp.reproject_composite_pix(*args, precision)]
    torch.cuda.synchronize()
    refs = [trp.reproject_sample_pix_plain(img, depth, params, precision),
            trp.reproject_composite_pix_plain(*args, precision)]
    for out, ref in zip(ours, refs):
        for o, r in zip(out, ref):
            torch.testing.assert_close(o, r, rtol=0, atol=1e-5)
    launches = [(None, None, None, d_geo, True),
                (mask, rgb, d_view, d_geo, False),
                (mask, rgb, d_view, None, True)]
    for m, r, dv, dg, need in launches:
        got = trp.reproject_pix_bwd(img, depth, params, m, r, dv, dg,
                                    precision, need)
        torch.cuda.synchronize()
        ref = trp.reproject_pix_bwd_plain(img, depth, params, m, r, dv, dg,
                                          precision, need)
        for o, rr in zip(got[1:], ref[1:]):
            if rr is None:
                assert o is None
            else:
                torch.testing.assert_close(o, rr, rtol=0, atol=1e-5)
        if need:
            scale = max(1.0, float(ref[0].abs().max()))
            assert float((got[0] - ref[0]).abs().max()) <= 1e-5 * scale
        else:
            assert got[0] is None
    assert [f.launches for f in counters] == [before[0] + 1, before[1] + 1,
                                              before[2] + 3]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("name,n_src,k,h,w,c", [
    ("mixed", 2, 3, 16, 24, 3), ("near", 2, 3, 16, 16, 1),
    ("mixed", 2, 3, 16, 24, 2), ("near", 2, 3, 16, 16, 4),
    ("mixed", 2, 3, 16, 24, 5), ("mixed", 16, 8, 128, 128, 3)])
def test_cuda_reproject_shared_frame_matches_plain(cuda, precision, name,
                                                   n_src, k, h, w, c):
    """The model's layout, N_src channels-last frames shared by K targets
    each, for each C the backward instantiates (1-4) and the general one
    (5), and the c2 shape: both forward entries and the three backward
    launches bitwise against the plain versions, on the same frames and on
    the frame repeated per target; d_img, one per frame (atomics), to 1e-6
    of its largest magnitude."""
    shared, repeated = _shared(name, n_src, k, h, w, c)
    shared = [t.to(cuda) for t in shared]
    img, depth, params, mask, rgb = shared
    per_target = repeated[0].to(cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    d_view, d_geo = (torch.randn(rgb.shape, generator=g, device=cuda)
                     for _ in range(2))
    ours = [trp.reproject_sample_pix(img, depth, params, precision),
            trp.reproject_composite_pix(*shared, precision)]
    torch.cuda.synchronize()
    for src in (img, per_target):
        refs = [trp.reproject_sample_pix_plain(src, depth, params,
                                               precision),
                trp.reproject_composite_pix_plain(src, depth, params, mask,
                                                  rgb, precision)]
        for out, ref in zip(ours, refs):
            for o, r in zip(out, ref):
                torch.testing.assert_close(o, r, rtol=0, atol=0)
    for composite, dv, dg, need in _launches(d_view, d_geo):
        m, r = (mask, rgb) if composite else (None, None)
        got = trp.reproject_pix_bwd(img, depth, params, m, r, dv, dg,
                                    precision, need)
        torch.cuda.synchronize()
        ref = trp.reproject_pix_bwd_plain(img, depth, params, m, r, dv, dg,
                                          precision, need)
        for o, rr in zip(got[1:], ref[1:]):
            assert (o is None) == (rr is None)
            if rr is not None:
                torch.testing.assert_close(o, rr, rtol=0, atol=0)
        assert got[0].shape == img.shape and got[0].stride() == img.stride()
        scale = max(1.0, float(ref[0].abs().max()))
        assert float((got[0] - ref[0]).abs().max()) <= 1e-6 * scale


@pytest.mark.cuda
def test_cuda_reproject_autograd_goes_through_the_kernels(cuda):
    """On CUDA tensors that require grad, the composite's backward launches
    the fused kernel once, without d_img (the image needs no grad), and
    matches the plain backward; the cameras get no gradient."""
    img, depth, params, mask, rgb = (t.to(cuda) for t in
                                     _pix(_inputs("mixed", h=16, w=24)))
    for t in (depth, mask, rgb):
        t.requires_grad_(True)
    fwd = trp.reproject_composite_pix.launches
    bwd = (trp.reproject_pix_bwd.launches, trp.reproject_pix_bwd.img_launches,
           trp.reproject_pix_bwd.composite_launches)
    view, geo, _ = trp.reproject_composite_pix(img, depth, params, mask, rgb,
                                               "fast")
    d_view, d_geo = torch.randn_like(view), torch.randn_like(geo)
    torch.autograd.backward([view, geo], [d_view, d_geo])
    torch.cuda.synchronize()
    assert trp.reproject_composite_pix.launches == fwd + 1
    assert (trp.reproject_pix_bwd.launches,
            trp.reproject_pix_bwd.img_launches,
            trp.reproject_pix_bwd.composite_launches) == \
        (bwd[0] + 1, bwd[1], bwd[2] + 1)
    ref = trp.reproject_pix_bwd_plain(
        img, depth.detach(), params, mask.detach(), rgb.detach(), d_view,
        d_geo, "fast", need_img=False)
    for t, r in zip((depth, mask, rgb), ref[1:]):
        torch.testing.assert_close(t.grad, r, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("case", ["mixed", "near", "invalid", "off"])
def test_cuda_reproject_staged_frame_matches_plain(cuda, precision, case):
    """The model's layout on CUDA: 2 frames staged as [N/K, H, W, 4], each
    shared by K = 3 targets. Both forward entries and the three backward
    launches on the staged frames against the plain versions on the
    unstaged ones, value for value (the kernels skip the loads of taps
    without weight, so a zero may differ in sign); d_img, one per frame
    (atomics), to 1e-6 of its largest magnitude, channels-last. No wrapper
    copies the staged frames. "invalid" and "off": no pixel valid, every
    correspondence off the image (``_edge_params``)."""
    edge = case in ("invalid", "off")
    shared, _ = _shared("mixed" if edge else case, h=16, w=24)
    frames, depth, params, mask, rgb = (t.to(cuda) for t in shared)
    if edge:
        params = _edge_params(case, depth.shape[0]).to(cuda)
    staged = _build.stage(frames)
    g = torch.Generator(device=cuda).manual_seed(0)
    d_view, d_geo = (torch.randn(rgb.shape, generator=g, device=cuda)
                     for _ in range(2))
    copies = _build.stage.copies
    ours = [trp.reproject_sample_pix(staged, depth, params, precision),
            trp.reproject_composite_pix(staged, depth, params, mask, rgb,
                                        precision)]
    torch.cuda.synchronize()
    refs = [trp.reproject_sample_pix_plain(frames, depth, params, precision),
            trp.reproject_composite_pix_plain(frames, depth, params, mask,
                                              rgb, precision)]
    for out, ref in zip(ours, refs):
        for o, r in zip(out, ref):
            torch.testing.assert_close(o, r, rtol=0, atol=0)
    for composite, dv, dg, need in _launches(d_view, d_geo):
        m, r = (mask, rgb) if composite else (None, None)
        got = trp.reproject_pix_bwd(staged, depth, params, m, r, dv, dg,
                                    precision, need)
        torch.cuda.synchronize()
        ref = trp.reproject_pix_bwd_plain(frames, depth, params, m, r, dv,
                                          dg, precision, need)
        for o, rr in zip(got[1:], ref[1:]):
            assert (o is None) == (rr is None)
            if rr is not None:
                torch.testing.assert_close(o, rr, rtol=0, atol=0)
        assert _channels_last(got[0])
        scale = max(1.0, float(ref[0].abs().max()))
        assert float((got[0] - ref[0]).abs().max()) <= 1e-6 * scale
    assert _build.stage.copies == copies
    if edge:
        assert not torch.any(ours[0][0])
        assert float(ours[0][1].max()) == (0.0 if case == "invalid" else 1.0)


@pytest.mark.cuda
def test_cuda_reproject_autograd_stages_an_unstaged_frame_once(cuda):
    """The autograd ops stage a channels-last frame once in the forward and
    keep it: the backward launches on it with no further copy; a staged
    frame is not copied at all."""
    shared, _ = _shared("mixed", h=16, w=24)
    frames, depth, params, mask, rgb = (t.to(cuda) for t in shared)
    for img, want in ((frames, 1), (_build.stage(frames), 0)):
        dep = depth.clone().requires_grad_(True)
        copies = _build.stage.copies
        view, geo, _ = trp.reproject_composite_pix(img, dep, params, mask,
                                                   rgb, "fast")
        geo_s, _ = trp.reproject_sample_pix(img, dep, params, "fast")
        torch.autograd.backward([view, geo_s], [torch.ones_like(view),
                                                torch.ones_like(geo_s)])
        torch.cuda.synchronize()
        assert _build.stage.copies - copies == 2 * want
        ref = trp.reproject_pix_bwd_plain(frames, depth, params, mask, rgb,
                                          torch.ones_like(view), None,
                                          "fast", need_img=False)[1] \
            + trp.reproject_pix_bwd_plain(frames, depth, params, None, None,
                                          None, torch.ones_like(geo_s),
                                          "fast", need_img=False)[1]
        torch.testing.assert_close(dep.grad, ref, rtol=0, atol=1e-5)
