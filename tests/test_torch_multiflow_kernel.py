"""The port's fused multi-source warp + blend + composite
(kernels/multiflow.py), forward and backward.

On the CPU ``multiflow_composite_pix`` runs its plain versions; they are
held against the JAX package's ``multiflow_composite_pix`` with the Pallas
kernels in interpret mode (forward) and ``jax.vjp`` of it (``_mf_bwd``
around ``_bwd_kernel``: every gradient, d_imgs, d_ix, d_iy, d_conf, d_mask,
d_rgb), for each of the cotangents of view, multi and wts present or absent.

Tolerances: "exact" 1e-5 forward and 1e-4 backward (f32 both, sums in
another order and exp from another library). "fast" as the single-source
kernel's tests hold it (tests/test_torch_kernels.py): both round the image
and the y-weights to bf16, but the reference's tent weight 1 - |h - c| can
differ from the port's 1 - frac(c) by an ulp and round the other way, which
moves a sample by up to 2^-8 of its value: 2e-2 (forward) and 5e-2
(backward, tests/test_multiflow_kernel.py's bar) as the outer limit, and at
least 99.9% of the elements within the exact tolerance, which pins down
which operands are rounded.

Cases (the "exact" ones at two seeds): coordinates spilling past every
border, T = 1, and exact-integer coordinates with whole rows and columns on
the far edges (where the reference's floor-tap subgradient gives
-v(edge)). Sampling is under border padding (the model's) unless a test
names zeros padding, which is held to the reference the same way, at
T = 3 and T = 17.

The frames may be contiguous or channels-last (NHWC frames permuted to
[N,T,C,H,W], as the model passes them, with no copy): both layouts give
bitwise the same results, and the wrapper refuses every other layout. The
CUDA kernels read channels-last frames only: the wrappers copy contiguous
ones into that layout.

The tests marked ``cuda`` hold the CUDA kernels to the plain versions on
the card; they skip without one:
``python -m pytest --noconftest tests/test_torch_multiflow_kernel.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from dynamic_multiview_3d_torch import config as tconfig
from dynamic_multiview_3d_torch.kernels import _build
from dynamic_multiview_3d_torch.kernels import multiflow as tmf
from dynamic_multiview_3d_torch.models import DMV3D as TDMV3D
from test_torch_kernels import _share_within

NAMES = ("imgs", "ix", "iy", "conf", "mask", "rgb")


def _case(name, n=2, t=3, c=3, h=16, w=16, k=2, seed=0):
    """imgs [N,T,C,H,W], ix, iy, conf [N,T,P], mask [N,P], rgb [N,C,P]."""
    rng = np.random.default_rng(seed)
    p = k * h * w
    imgs = rng.uniform(-1, 1, (n, t, c, h, w)).astype(np.float32)
    if name == "integer":       # integer coords, whole far-edge rows/columns
        ix = rng.integers(-2, w + 2, (n, t, p)).astype(np.float32)
        iy = rng.integers(-2, h + 2, (n, t, p)).astype(np.float32)
        ix[:, :, : p // 8] = w - 1
        iy[:, :, p // 8: p // 4] = h - 1
        ix[:, :, p // 4: p // 4 + 16] = 0.0
    else:                       # spill past the borders on purpose
        ix = rng.uniform(-6, w + 5, (n, t, p)).astype(np.float32)
        iy = rng.uniform(-6, h + 5, (n, t, p)).astype(np.float32)
    conf = rng.standard_normal((n, t, p)).astype(np.float32)
    mask = rng.uniform(0, 1, (n, p)).astype(np.float32)
    rgb = rng.uniform(-1, 1, (n, c, p)).astype(np.float32)
    return imgs, ix, iy, conf, mask, rgb


CASES = {"spill": dict(), "t1": dict(t=1), "integer": dict(),
         "wide": dict(h=8, w=24, k=1, t=4)}


def _jax_forward(arrays, precision, padding_mode="border"):
    import jax.numpy as jnp
    from dynamic_multiview_3d_tpu.kernels import multiflow_pallas as mfp
    out = mfp.multiflow_composite_pix(*(jnp.asarray(a) for a in arrays),
                                      padding_mode, True, precision)
    return [np.asarray(o) for o in out]


def _port_forward(arrays, precision, padding_mode="border"):
    out = tmf.multiflow_composite_pix(*(torch.from_numpy(a) for a in arrays),
                                      padding_mode, precision)
    return [o.numpy() for o in out]


def _frames(imgs: torch.Tensor, layout: str) -> torch.Tensor:
    """imgs [N,T,C,H,W] with the same values in the memory layout named:
    "contiguous", "channels_last" (NHWC frames permuted, as the model
    passes them) or one the wrapper must refuse."""
    if layout == "contiguous":
        return imgs.contiguous()
    if layout == "channels_last":
        return imgs.permute(0, 1, 3, 4, 2).contiguous().permute(0, 1, 4, 2, 3)
    if layout == "hw_transposed":         # [N,T,C,W,H] memory
        return imgs.transpose(3, 4).contiguous().transpose(3, 4)
    if layout == "channels_first_nt":     # [T,N,C,H,W] memory
        return imgs.transpose(0, 1).contiguous().transpose(0, 1)
    if layout == "strided":               # every other pixel of a wider row
        return torch.cat([imgs, imgs], dim=-1)[..., ::2]
    raise ValueError(layout)


SEEDS = [0, 1]


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("seed", SEEDS)
def test_plain_forward_exact_matches_pallas(name, seed):
    arrays = _case(name, seed=seed, **CASES[name])
    ref = _jax_forward(arrays, "exact")
    ours = _port_forward(arrays, "exact")
    for what, r, o in zip(("view", "multi", "any_valid", "wts"), ref, ours):
        assert o.shape == r.shape, what
        np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-5, err_msg=what)
    np.testing.assert_array_equal(ours[2], ref[2])
    assert 0 < ours[2].mean() < 1 or name == "t1"


@pytest.mark.parametrize("name", CASES)
def test_plain_forward_fast_matches_pallas_fast(name):
    arrays = _case(name, **CASES[name])
    ref = _jax_forward(arrays, "fast")
    ours = _port_forward(arrays, "fast")
    exact = _port_forward(arrays, "exact")
    for what, r, o in zip(("view", "multi"), ref[:2], ours[:2]):
        np.testing.assert_allclose(o, r, rtol=2e-2, atol=2e-2, err_msg=what)
        assert _share_within(o, r, 1e-5) >= 0.999, what
    np.testing.assert_allclose(ours[3], ref[3], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ours[2], ref[2])
    assert np.abs(ours[1] - exact[1]).max() > 0          # fast really rounds


def _cotangents(arrays, present, seed=1):
    """(d_view, d_multi, d_wts), None where not present."""
    rng = np.random.default_rng(seed)
    _, _, _, conf, _, rgb = arrays
    shapes = (rgb.shape, rgb.shape, conf.shape)
    return [rng.standard_normal(s).astype(np.float32) if on else None
            for s, on in zip(shapes, present)]


def _jax_grads(arrays, cots, precision, padding_mode="border"):
    """jax.vjp of the JAX package's op (interpret-mode kernels) -> the six
    gradients; an absent cotangent is zero, as JAX hands it to _mf_bwd."""
    import jax
    import jax.numpy as jnp
    from dynamic_multiview_3d_tpu.kernels import multiflow_pallas as mfp

    def f(*a):
        view, multi, _, wts = mfp.multiflow_composite_pix(
            *a, padding_mode, True, precision)
        return view, multi, wts
    outs, vjp = jax.vjp(f, *(jnp.asarray(a) for a in arrays))
    cots = tuple(jnp.zeros_like(o) if c is None else jnp.asarray(c)
                 for o, c in zip(outs, cots))
    return [np.asarray(g) for g in vjp(cots)]


def _port_grads(arrays, cots, precision, image_grad=True,
                padding_mode="border"):
    ts = [torch.from_numpy(a).requires_grad_(image_grad or i > 0)
          for i, a in enumerate(arrays)]
    view, multi, _, wts = tmf.multiflow_composite_pix(*ts, padding_mode,
                                                      precision)
    pairs = [(o, torch.from_numpy(c)) for o, c in zip((view, multi, wts), cots)
             if c is not None]
    torch.autograd.backward([o for o, _ in pairs], [c for _, c in pairs])
    return [None if x.grad is None else x.grad.numpy() for x in ts]


# (d_view, d_multi, d_wts) present: all; the multiflow training launch;
# the multidepth one (geo-L1 on multi); d_wts alone beside d_view; no d_view
COTANGENTS = [(1, 1, 1), (1, 0, 0), (1, 1, 0), (1, 0, 1), (0, 1, 1)]


@pytest.mark.parametrize("present", COTANGENTS)
@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("seed", SEEDS)
def test_plain_bwd_exact_matches_pallas(name, present, seed):
    arrays = _case(name, seed=seed, **CASES[name])
    cots = _cotangents(arrays, present, seed=seed + 1)
    ref = _jax_grads(arrays, cots, "exact")
    ours = _port_grads(arrays, cots, "exact")
    for what, r, o in zip(NAMES, ref, ours):
        assert o.shape == r.shape, what
        np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-4, err_msg=what)
    # the softmax Jacobian (one source: a constant weight, zero gradient)
    assert (np.abs(ours[3]).max() > 0) == (name != "t1")


@pytest.mark.parametrize("present", [(1, 1, 1), (1, 1, 0)])
@pytest.mark.parametrize("name", CASES)
def test_plain_bwd_fast_matches_pallas_fast(name, present):
    arrays = _case(name, **CASES[name])
    cots = _cotangents(arrays, present)
    ref = _jax_grads(arrays, cots, "fast")
    ours = _port_grads(arrays, cots, "fast")
    exact = _port_grads(arrays, cots, "exact")
    for what, r, o in zip(NAMES, ref, ours):
        np.testing.assert_allclose(o, r, rtol=5e-2, atol=5e-2, err_msg=what)
        assert _share_within(o, r, 1e-4) >= 0.999, what
    if name != "integer":          # integer weights are exact in bf16
        assert np.abs(ours[0] - exact[0]).max() > 0   # fast really rounds


ZEROS_SOURCES = [3, 17]


@pytest.mark.parametrize("t", ZEROS_SOURCES)
@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_zeros_padding_forward_matches_pallas(t, precision):
    """padding_mode="zeros" (a tap outside the image reads 0; the blend
    logit still tests the unclamped coordinate) against the reference in
    the same mode, at the tolerances above."""
    arrays = _case("spill", t=t)
    ref = _jax_forward(arrays, precision, "zeros")
    ours = _port_forward(arrays, precision, "zeros")
    border = _port_forward(arrays, precision, "border")
    tol = 1e-5 if precision == "exact" else 2e-2
    for what, r, o in zip(("view", "multi", "any_valid", "wts"), ref, ours):
        assert o.shape == r.shape, what
        np.testing.assert_allclose(o, r, rtol=tol, atol=tol, err_msg=what)
        if precision == "fast":
            assert _share_within(o, r, 1e-5) >= 0.999, what
    np.testing.assert_array_equal(ours[2], ref[2])
    # the blend weights do not depend on the padding; the samples do
    np.testing.assert_array_equal(ours[3], border[3])
    assert np.abs(ours[1] - border[1]).max() > 0.1


@pytest.mark.parametrize("t", ZEROS_SOURCES)
@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_zeros_padding_backward_matches_pallas(t, precision):
    arrays = _case("spill", t=t)
    cots = _cotangents(arrays, (1, 1, 1))
    ref = _jax_grads(arrays, cots, precision, "zeros")
    ours = _port_grads(arrays, cots, precision, padding_mode="zeros")
    tol = 1e-4 if precision == "exact" else 5e-2
    for what, r, o in zip(NAMES, ref, ours):
        assert o.shape == r.shape, what
        np.testing.assert_allclose(o, r, rtol=tol, atol=tol, err_msg=what)
        if precision == "fast":
            assert _share_within(o, r, 1e-4) >= 0.999, what


def test_far_edge_subgradient():
    """At x = W-1 exactly, d_ix is the reference's
    floor-tap subgradient -v(edge) * ds, not the 0 that autograd through
    the clamped forward would give."""
    arrays = _case("integer")
    cots = _cotangents(arrays, (1, 0, 0))
    ours = _port_grads(arrays, cots, "exact")
    imgs, ix, iy, conf, mask, rgb = (torch.from_numpy(a).requires_grad_(True)
                                     for a in arrays)
    view, *_ = tmf.multiflow_composite_pix_plain(imgs, ix, iy, conf, mask,
                                                 rgb)
    view.backward(torch.from_numpy(cots[0]))
    edge = (arrays[1] == 15) & (arrays[2] >= 0) & (arrays[2] <= 15)
    assert edge.sum() > 100
    assert np.abs(ix.grad.numpy()[edge]).max() == 0
    assert np.abs(ours[1][edge]).max() > 0.1


def test_training_launch_needs_no_image_grad():
    """The model's path: the frames need no grad, so d_imgs is never
    computed, and neither multi nor wts is in the multiflow loss, so their
    cotangents stay None; the other gradients match JAX's with zeros."""
    arrays = _case("spill")
    cots = _cotangents(arrays, (1, 0, 0))
    ref = _jax_grads(arrays, cots, "exact")
    ours = _port_grads(arrays, cots, "exact", image_grad=False)
    assert ours[0] is None
    for what, r, o in zip(NAMES[1:], ref[1:], ours[1:]):
        np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-4, err_msg=what)


@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("name", CASES)
def test_plain_channels_last_frames_match_contiguous_bitwise(name, precision):
    """Forward and backward (every cotangent, d_imgs too) of channels-last
    frames equal those of contiguous ones bit for bit; d_imgs comes back
    with the frames' values, whatever its strides."""
    arrays = _case(name, **CASES[name])
    cots = [torch.from_numpy(c) for c in
            _cotangents(arrays, (1, 1, 1), seed=3)]
    runs = {}
    for layout in ("contiguous", "channels_last"):
        args = [torch.from_numpy(a) for a in arrays]
        args[0] = _frames(args[0], layout)
        assert _build.channels_last(args[0]) == (layout == "channels_last")
        ts = [a.requires_grad_(True) for a in args]
        outs = tmf.multiflow_composite_pix(*ts, precision=precision)
        view, multi, _, wts = outs
        torch.autograd.backward([view, multi, wts], cots)
        runs[layout] = [o.detach() for o in outs] + [t.grad for t in ts]
    for a, b in zip(runs["contiguous"], runs["channels_last"]):
        torch.testing.assert_close(b, a, rtol=0, atol=0)


@pytest.mark.parametrize("layout,ok", [
    ("contiguous", True), ("channels_last", True), ("hw_transposed", False),
    ("channels_first_nt", False), ("strided", False)])
def test_wrapper_takes_exactly_two_frame_layouts(layout, ok):
    """Contiguous and channels-last frames are taken, any other layout
    raises; the kernels get channels-last frames, a channels-last view as
    it is and contiguous frames copied."""
    args = [torch.from_numpy(a) for a in _case("spill")]
    args[0] = _frames(args[0], layout)
    d_view = torch.ones_like(args[5])
    if ok:
        tmf.multiflow_composite_pix(*args)
        tmf.multiflow_composite_pix_bwd(*args, d_view)
        frames = _build.as_channels_last(args[0])
        assert frames.movedim(2, -1).is_contiguous()
        assert (frames is args[0]) == (layout == "channels_last")
        torch.testing.assert_close(frames, args[0], rtol=0, atol=0)
        return
    with pytest.raises(ValueError, match="contiguous or channels-last"):
        tmf.multiflow_composite_pix(*args)
    with pytest.raises(ValueError, match="contiguous or channels-last"):
        tmf.multiflow_composite_pix_bwd(*args, d_view)


def test_model_passes_the_frames_without_a_copy(monkeypatch):
    """_blend_sources hands the op a channels-last view of image_seq: the
    same memory, no transpose before the kernel."""
    cfg = tconfig.override(tconfig.Config(), [
        "model.image_size=16", "model.num_levels=2", "model.base_features=8",
        "model.max_features=8", "model.gru_features=8",
        "model.pose_embed_dim=8", "model.dtype=float32",
        "model.synthesis=multidepth", "data.image_size=16"])
    module = TDMV3D(cfg.model).eval()
    seen = []

    def spy(imgs, *args):
        seen.append(imgs)
        return op(imgs, *args)
    op = tmf.multiflow_composite_pix
    monkeypatch.setattr(tmf, "multiflow_composite_pix", spy)
    rng = np.random.default_rng(0)
    image_seq = torch.from_numpy(
        rng.uniform(-1, 1, (2, 3, 16, 16, 3)).astype(np.float32))
    poses = torch.from_numpy(rng.uniform(0.5, 1.5, (2, 5, 3))
                             .astype(np.float32))
    with torch.no_grad():
        module(image_seq, poses[:, :3], poses[:, 3:])
    (imgs,) = seen
    assert imgs.shape == (2, 3, 3, 16, 16)
    assert _build.channels_last(imgs)
    assert imgs.data_ptr() == image_seq.data_ptr()
    assert imgs.untyped_storage().data_ptr() == \
        image_seq.untyped_storage().data_ptr()
    torch.testing.assert_close(imgs, image_seq.permute(0, 1, 4, 2, 3),
                               rtol=0, atol=0)


def test_wrapper_checks_inputs_and_counts_no_cpu_launch():
    args = [torch.from_numpy(a) for a in _case("spill")]
    before = (tmf.multiflow_composite_pix.launches,
              tmf.multiflow_composite_pix_bwd.launches,
              tmf.multiflow_composite_pix_bwd.img_launches)
    out = tmf.multiflow_composite_pix(*args)
    d_view = torch.ones_like(args[5])
    grads = tmf.multiflow_composite_pix_bwd(*args, d_view)
    assert (tmf.multiflow_composite_pix.launches,
            tmf.multiflow_composite_pix_bwd.launches,
            tmf.multiflow_composite_pix_bwd.img_launches) == before  # plain
    assert [tuple(o.shape) for o in out] == [(2, 3, 512), (2, 3, 512),
                                             (2, 512), (2, 3, 512)]
    assert grads[0].shape == args[0].shape
    assert tmf.multiflow_composite_pix_bwd(*args, d_view,
                                           need_imgs=False)[0] is None
    imgs, ix, iy, conf, mask, rgb = args
    with pytest.raises(ValueError):
        tmf.multiflow_composite_pix(imgs[:, 0], ix, iy, conf, mask, rgb)
    with pytest.raises(ValueError):
        tmf.multiflow_composite_pix(imgs, ix, iy, conf[:, :2], mask, rgb)
    with pytest.raises(TypeError):
        tmf.multiflow_composite_pix(imgs.double(), ix, iy, conf, mask, rgb)
    with pytest.raises(ValueError):
        tmf.multiflow_composite_pix(imgs, ix.transpose(0, 1).contiguous()
                                    .transpose(0, 1), iy, conf, mask, rgb)
    with pytest.raises(ValueError):
        tmf.multiflow_composite_pix(*args, precision="half")
    with pytest.raises(ValueError):
        tmf.multiflow_composite_pix_bwd(*args, d_view, d_wts=d_view[:1])


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check_fwd_kernel(device, name, precision, layout="contiguous",
                      padding_mode="border", **kw):
    args = [torch.from_numpy(a).to(device) for a in _case(name, **kw)]
    args[0] = _frames(args[0], layout)
    before = tmf.multiflow_composite_pix.launches
    ours = tmf.multiflow_composite_pix(*args, padding_mode, precision)
    torch.cuda.synchronize(device)
    assert tmf.multiflow_composite_pix.launches == before + 1
    ref = tmf.multiflow_composite_pix_plain(*args, padding_mode, precision)
    for o, r in zip(ours, ref):
        assert o.device == args[0].device
        torch.testing.assert_close(o, r, rtol=0, atol=1e-5)


def _check_bwd_kernel(device, name, precision, present, need_imgs=True,
                      layout="contiguous", padding_mode="border", **kw):
    args = [torch.from_numpy(a).to(device) for a in _case(name, **kw)]
    args[0] = _frames(args[0], layout)
    cots = [None if c is None else torch.from_numpy(c).to(device)
            for c in _cotangents(_case(name, **kw), present)]
    if cots[0] is None:
        cots[0] = torch.zeros_like(args[5])
    before = (tmf.multiflow_composite_pix_bwd.launches,
              tmf.multiflow_composite_pix_bwd.img_launches)
    ours = tmf.multiflow_composite_pix_bwd(*args, *cots, padding_mode,
                                           precision, need_imgs=need_imgs)
    torch.cuda.synchronize(device)
    assert (tmf.multiflow_composite_pix_bwd.launches,
            tmf.multiflow_composite_pix_bwd.img_launches) == \
        (before[0] + 1, before[1] + int(need_imgs))
    ref = tmf.multiflow_composite_pix_bwd_plain(*args, *cots, padding_mode,
                                                precision, need_imgs)
    for o, r in zip(ours[1:], ref[1:]):             # per pixel, no atomics
        assert o.device == args[0].device
        torch.testing.assert_close(o, r, rtol=0, atol=1e-5)
    if need_imgs:      # atomics, run-dependent order: 1e-5 of the largest
        assert ours[0].stride() == args[0].stride()   # the frames' layout
        scale = max(1.0, float(ref[0].abs().max()))
        assert float((ours[0] - ref[0]).abs().max()) <= 1e-5 * scale
    else:
        assert ours[0] is None


# T = 1, 3, 8, 16, 17 and 24 (each T is built at its first use; C = 4 takes
# two passes of the 3-channel groups, C = 2 one pass with a channel to
# spare), an odd pixel count, and the c3md shape (forward only: the
# backward's c3md launches follow)
KERNEL_CASES = [
    ("spill", {}), ("t1", dict(t=1)), ("integer", {}),
    ("spill", dict(t=16, c=4, h=24, w=40, k=1)),
    ("spill", dict(t=8, c=2, h=5, w=7, k=1)),
    ("spill", dict(t=17)), ("spill", dict(t=24, h=8, w=24, k=1))]
LAYOUTS = ["contiguous", "channels_last"]
PADDINGS = ["border", "zeros"]


@pytest.mark.cuda
@pytest.mark.parametrize("padding_mode", PADDINGS)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("name,kw", KERNEL_CASES + [
    ("spill", dict(n=8, t=8, h=128, w=128, k=2))])      # the c3md shape
def test_cuda_fwd_kernel_matches_plain(cuda, precision, name, kw, layout,
                                       padding_mode):
    _check_fwd_kernel(cuda, name, precision, layout, padding_mode, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("padding_mode", PADDINGS)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("present", COTANGENTS)
@pytest.mark.parametrize("name,kw", KERNEL_CASES)
def test_cuda_bwd_kernel_matches_plain(cuda, precision, present, name, kw,
                                       layout, padding_mode):
    _check_bwd_kernel(cuda, name, precision, present, layout=layout,
                      padding_mode=padding_mode, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("present", [(1, 0, 0), (1, 1, 0)])
def test_cuda_bwd_training_launch_at_c3md_shape(cuda, present, layout):
    _check_bwd_kernel(cuda, "spill", "fast", present, need_imgs=False,
                      layout=layout, n=8, t=8, h=128, w=128, k=2)


@pytest.mark.cuda
def test_cuda_more_than_16_sources_run(cuda):
    """T = 17 launches both kernels, built for it at their first use (each
    T and padding a library of its own), and matches the plain versions."""
    args = [torch.from_numpy(a).to(cuda) for a in _case("spill", t=17)]
    before = (tmf.multiflow_composite_pix.launches,
              tmf.multiflow_composite_pix_bwd.launches)
    out = tmf.multiflow_composite_pix(*args)
    grads = tmf.multiflow_composite_pix_bwd(*args, torch.ones_like(args[5]))
    torch.cuda.synchronize()
    assert (tmf.multiflow_composite_pix.launches,
            tmf.multiflow_composite_pix_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    assert out[3].shape == (2, 17, 512) and grads[1].shape == (2, 17, 512)
    ref = tmf.multiflow_composite_pix_plain(*args)
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_cuda_autograd_goes_through_the_kernels(cuda):
    """On CUDA tensors, backward launches the kernel once (no d_imgs: the
    images need no grad; only view's cotangent) and matches the plain
    backward."""
    args = [torch.from_numpy(a).to(cuda).requires_grad_(i > 0)
            for i, a in enumerate(_case("spill"))]
    fwd, bwd = (tmf.multiflow_composite_pix.launches,
                tmf.multiflow_composite_pix_bwd.launches)
    img_launches = tmf.multiflow_composite_pix_bwd.img_launches
    view, *_ = tmf.multiflow_composite_pix(*args, precision="fast")
    d_view = torch.randn_like(view)
    view.backward(d_view)
    torch.cuda.synchronize()
    assert tmf.multiflow_composite_pix.launches == fwd + 1
    assert tmf.multiflow_composite_pix_bwd.launches == bwd + 1
    assert tmf.multiflow_composite_pix_bwd.img_launches == img_launches
    assert args[0].grad is None
    ref = tmf.multiflow_composite_pix_bwd_plain(
        *(a.detach() for a in args), d_view, None, None, precision="fast",
        need_imgs=False)
    for a, r in zip(args[1:], ref[1:]):
        torch.testing.assert_close(a.grad, r, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_cuda_kernels_on_a_gpu_other_than_the_current_one(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    dev = torch.device("cuda", 1)
    assert torch.cuda.current_device() != 1
    _check_fwd_kernel(dev, "spill", "fast", "channels_last")
    _check_bwd_kernel(dev, "spill", "fast", (1, 1, 1),
                      layout="channels_last")
