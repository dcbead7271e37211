"""Which source frame the model hands each single-source kernel
(models/dmv3d.py, synthesis "depth" and "flow" with ``predict_depth``).

Every synthesis hands its kernels one frame per example, shared by its K
targets, as one tensor. On the CPU it is the NHWC last frame itself as a
channels-last [B, 3, H, W] view, with no copy; on CUDA that frame staged
once per forward as [B, H, W, 4] (``_last_frame``, ``_build.stage``), which
every kernel of the forward and the backward reads with no further copy.
Depth synthesis samples it (site #2, ``sample_pixel_coords``) and
reprojects it (#7, ``reproject_composite_pix``); flow synthesis warps it
(sites #1/#3, ``warp_composite_pix``) and, with ``predict_depth``,
reprojects the same tensor (#6). The spies pass every call on to the op,
so the outputs are the model's. The CUDA staging is run here on the CPU
(``_last_frame(..., stage=True)``): it gives the CPU's outputs and
gradients bit for bit, with one copy per forward.
"""

import functools

import numpy as np
import pytest
import torch

from dynamic_multiview_3d_torch import config as tconfig
from dynamic_multiview_3d_torch.kernels import _build
from dynamic_multiview_3d_torch.kernels import grid_sample as tgs
from dynamic_multiview_3d_torch.kernels import reproject as trp
from dynamic_multiview_3d_torch.models import DMV3D as TDMV3D
from dynamic_multiview_3d_torch.models import dmv3d as tdmv3d

B, K, HW = 2, 3, 16


def _run(monkeypatch, synthesis, seq_len=1, grad=False):
    """Run a tiny model with predict_depth; return {op name: the image it
    was handed} and the input frames. With ``grad``, on seeded random
    weights, also the outputs and the weights' gradients of the sum of the
    view and the geometric view (a third entry)."""
    cfg = tconfig.override(tconfig.Config(), [
        f"model.image_size={HW}", "model.num_levels=2",
        "model.base_features=8", "model.max_features=8",
        "model.gru_features=8", "model.pose_embed_dim=8",
        "model.dtype=float32", f"model.synthesis={synthesis}",
        "model.predict_depth=true", f"data.image_size={HW}"])
    module = TDMV3D(cfg.model).eval()
    seen = {}
    for mod, name in ((tgs, "sample_pixel_coords"),
                      (tgs, "warp_composite_pix"),
                      (trp, "reproject_sample_pix"),
                      (trp, "reproject_composite_pix")):
        def spy(img, *args, _op=getattr(mod, name), _name=name):
            seen[_name] = img
            return _op(img, *args)
        monkeypatch.setattr(mod, name, spy)
    rng = np.random.default_rng(0)
    image_seq = torch.from_numpy(
        rng.uniform(-1, 1, (B, seq_len, HW, HW, 3)).astype(np.float32))
    poses = torch.from_numpy(rng.uniform(0.5, 1.5, (B, seq_len + K, 3))
                             .astype(np.float32))
    if not grad:
        with torch.no_grad():
            out = module(image_seq, poses[:, :seq_len], poses[:, seq_len:])
        assert out["view"].shape == (B, K, HW, HW, 3)
        return seen, image_seq
    g = torch.Generator().manual_seed(0)      # weights that move the frame
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    out = module(image_seq, poses[:, :seq_len], poses[:, seq_len:])
    (out["view"].sum() + out["geo_view"].sum()).backward()
    grads = {n: p.grad for n, p in module.named_parameters()
             if p.grad is not None}
    return seen, image_seq, (out, grads)


def _is_the_frame(img, image_seq):
    """img is image_seq's last frame as a channels-last view, no copy."""
    return (tuple(img.shape) == (B, 3, HW, HW) and _build.channels_last(img)
            and img.data_ptr() == image_seq[:, -1].data_ptr()
            and torch.equal(img, image_seq[:, -1].permute(0, 3, 1, 2)))


def test_depth_synthesis_shares_one_frame_per_example(monkeypatch):
    seen, image_seq = _run(monkeypatch, "depth")
    assert set(seen) == {"sample_pixel_coords", "reproject_composite_pix"}
    for name, img in seen.items():
        assert _is_the_frame(img, image_seq), name
    assert seen["sample_pixel_coords"] is seen["reproject_composite_pix"]


def test_flow_synthesis_shares_one_frame_per_example_for_the_warp(
        monkeypatch):
    """The warp + composite gets the NHWC frame itself, B frames for the
    B*K targets, not a copy per target; the geometric side view (#6) gets
    the same tensor."""
    seen, image_seq = _run(monkeypatch, "flow")
    assert set(seen) == {"warp_composite_pix", "reproject_sample_pix"}
    for name, img in seen.items():
        assert _is_the_frame(img, image_seq), name
    assert seen["warp_composite_pix"] is seen["reproject_sample_pix"]


@pytest.mark.parametrize("synthesis", ["depth", "flow"])
def test_a_strided_last_frame_is_gathered_once_per_example(monkeypatch,
                                                           synthesis):
    """With T > 1 the last frame of [B,T,H,W,3] is strided: it is copied
    once per example (B frames, not B*K) into the channels-last layout,
    and every kernel gets that one copy."""
    seen, image_seq = _run(monkeypatch, synthesis, seq_len=2)
    img = seen["reproject_composite_pix" if synthesis == "depth"
               else "reproject_sample_pix"]
    assert tuple(img.shape) == (B, 3, HW, HW) and _build.channels_last(img)
    torch.testing.assert_close(img, image_seq[:, -1].permute(0, 3, 1, 2),
                               rtol=0, atol=0)
    assert all(other is img for other in seen.values())


@pytest.mark.parametrize("synthesis", ["depth", "flow"])
@pytest.mark.parametrize("seq_len", [1, 2])
def test_the_staged_frame_is_copied_once_and_shared(monkeypatch, synthesis,
                                                     seq_len):
    """The CUDA path's frame, run on the CPU: the last frame is staged once
    per forward (one ``_build.stage`` copy, none in the backward), every
    kernel gets that one staged tensor, and the outputs and the weights'
    gradients are bitwise those of the channels-last frame."""
    _, _, (ref, ref_grads) = _run(monkeypatch, synthesis, seq_len, grad=True)
    monkeypatch.setattr(tdmv3d, "_last_frame",
                        functools.partial(tdmv3d._last_frame, stage=True))
    copies = _build.stage.copies
    seen, image_seq, (out, grads) = _run(monkeypatch, synthesis, seq_len,
                                         grad=True)
    assert _build.stage.copies - copies == 1
    img = next(iter(seen.values()))
    assert len(seen) == 2 and all(other is img for other in seen.values())
    assert _build.staged(img)
    torch.testing.assert_close(img, image_seq[:, -1].permute(0, 3, 1, 2),
                               rtol=0, atol=0)
    for key in ("view", "geo_view", "warped", "geo_valid"):
        torch.testing.assert_close(out[key], ref[key], rtol=0, atol=0)
    assert grads.keys() == ref_grads.keys()
    for name, g in grads.items():
        torch.testing.assert_close(g, ref_grads[name], rtol=0, atol=0,
                                   msg=name)
