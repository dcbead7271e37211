"""The port's geometry ops (dynamic_multiview_3d_torch.ops) against the JAX
package's, on the same numpy inputs. Tolerance 1e-5: both compute in f32 and
differ only in the order of sums and in transcendental rounding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_multiview_3d_torch.ops import pose as tpose
from dynamic_multiview_3d_torch.ops import reproject as trep
from dynamic_multiview_3d_torch.ops import sampling as tsamp
from dynamic_multiview_3d_tpu.ops import pose as jpose
from dynamic_multiview_3d_tpu.ops import reproject as jrep
from dynamic_multiview_3d_tpu.ops import sampling as jsamp

TOL = 1e-5


def _close(jax_out, torch_out, tol=TOL):
    np.testing.assert_allclose(torch_out.numpy(), np.asarray(jax_out),
                               rtol=tol, atol=tol)


def _poses(rng, *shape):
    return np.stack([rng.uniform(0, 2 * np.pi, shape),
                     rng.uniform(-0.6, 0.8, shape),
                     rng.uniform(1.5, 3.0, shape)], -1).astype(np.float32)


def test_pose_features_and_view_pair(rng):
    src, tgt = _poses(rng, 4, 3), _poses(rng, 4, 3)
    _close(jpose.pose_to_features(jnp.asarray(src)),
           tpose.pose_to_features(torch.from_numpy(src)))
    _close(jpose.encode_view_pair(jnp.asarray(src), jnp.asarray(tgt)),
           tpose.encode_view_pair(torch.from_numpy(src), torch.from_numpy(tgt)))


@pytest.mark.parametrize("mode", ["sincos", "mat"])
def test_encode_pose(rng, mode):
    src, tgt = _poses(rng, 6), _poses(rng, 6)
    _close(jpose.encode_pose(jnp.asarray(src), jnp.asarray(tgt), mode=mode),
           tpose.encode_pose(torch.from_numpy(src), torch.from_numpy(tgt),
                             mode=mode))
    with pytest.raises(ValueError):
        tpose.encode_pose(torch.from_numpy(src), torch.from_numpy(tgt),
                          mode="quat")


@pytest.mark.parametrize("with_center", [False, True])
def test_extrinsics_and_relative_transform(rng, with_center):
    a, b = _poses(rng, 2, 5), _poses(rng, 2, 5)
    center = rng.uniform(-0.3, 0.3, 3).astype(np.float32) if with_center \
        else None
    jc = None if center is None else jnp.asarray(center)
    tc = None if center is None else torch.from_numpy(center)
    ja = jpose.look_at_extrinsics(jnp.asarray(a), jc)
    jb = jpose.look_at_extrinsics(jnp.asarray(b), jc)
    ta = tpose.look_at_extrinsics(torch.from_numpy(a), tc)
    tb = tpose.look_at_extrinsics(torch.from_numpy(b), tc)
    _close(ja, ta)
    _close(jpose.relative_transform(ja, jb), tpose.relative_transform(ta, tb))


def test_intrinsics(rng):
    focal = rng.uniform(50, 200, 7).astype(np.float32)
    _close(jpose.intrinsics_matrix(jnp.asarray(focal), 63.5, 31.5),
           tpose.intrinsics_matrix(torch.from_numpy(focal), 63.5, 31.5))


@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_normalization_roundtrip(rng, align_corners):
    h, w = 16, 24
    _close(jsamp.base_grid(h, w), tsamp.base_grid(h, w))
    pix = rng.uniform(-3, 27, (2, 5, 7, 2)).astype(np.float32)
    jg = jsamp.normalize_coords(jnp.asarray(pix), h, w, align_corners)
    tg = tsamp.normalize_coords(torch.from_numpy(pix), h, w, align_corners)
    _close(jg, tg)
    for j, t in zip(jsamp.unnormalize_coords(jg, h, w, align_corners),
                    tsamp.unnormalize_coords(tg, h, w, align_corners)):
        _close(j, t)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample_matches_jnp(rng, padding_mode, align_corners):
    img = rng.standard_normal((2, 16, 24, 3), dtype=np.float32)
    grid = rng.uniform(-1.4, 1.4, (2, 12, 20, 2)).astype(np.float32)
    ref = jsamp.grid_sample(jnp.asarray(img), jnp.asarray(grid),
                            align_corners=align_corners,
                            padding_mode=padding_mode, impl="jnp")
    ours = tsamp.grid_sample(torch.from_numpy(img), torch.from_numpy(grid),
                             align_corners=align_corners,
                             padding_mode=padding_mode)
    _close(ref, ours)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_flow_warp_and_in_bounds_mask(rng, padding_mode):
    h, w = 16, 24
    img = rng.standard_normal((2, h, w, 3), dtype=np.float32)
    flow = rng.uniform(-30, 30, (2, h, w, 2)).astype(np.float32)
    flow[0, :4] = np.round(flow[0, :4])           # exact-integer coordinates
    _close(jsamp.flow_warp(jnp.asarray(img), jnp.asarray(flow),
                           padding_mode=padding_mode, impl="jnp"),
           tsamp.flow_warp(torch.from_numpy(img), torch.from_numpy(flow),
                           padding_mode=padding_mode))
    ref = np.asarray(jsamp.in_bounds_mask(jnp.asarray(flow), h, w))
    ours = tsamp.in_bounds_mask(torch.from_numpy(flow), h, w).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert 0 < ours.mean() < 1


def test_inv3x3(rng):
    m = rng.standard_normal((5, 3, 3)).astype(np.float32) \
        + 3 * np.eye(3, dtype=np.float32)
    intr = tpose.intrinsics_matrix(torch.tensor([64.0, 128.0]), 31.5, 15.5)
    for a in (m, intr.numpy()):
        ours = trep.inv3x3(torch.from_numpy(a))
        _close(jrep.inv3x3(jnp.asarray(a)), ours)
        np.testing.assert_allclose((torch.from_numpy(a) @ ours).numpy(),
                                   np.broadcast_to(np.eye(3), a.shape),
                                   atol=1e-5)


def _reproject_case(rng, n=3, h=12, w=16):
    """Depths in (0.5, 8) seen from a target camera at radius 2; for half
    the batch the source sits opposite it (through the centre), so points
    deeper than about 4 lie behind that source (z <= eps)."""
    tgt = _poses(rng, n)
    tgt[:, 2] = 2.0
    src = tgt.copy()
    src[:, 0] += rng.uniform(-0.3, 0.3, n).astype(np.float32)
    src[::2, 0] += np.float32(np.pi)
    src[::2, 1] *= -1.0
    rel = tpose.relative_transform(tpose.look_at_extrinsics(
        torch.from_numpy(src)), tpose.look_at_extrinsics(
        torch.from_numpy(tgt))).numpy()
    intr = tpose.intrinsics_matrix(torch.full((n,), float(max(h, w))),
                                   (w - 1) / 2, (h - 1) / 2).numpy()
    depth = rng.uniform(0.5, 8.0, (n, h, w)).astype(np.float32)
    return depth, intr, rel


def test_reproject_coords_and_gradient(rng):
    """coords, validity and the gradient into depth, behind-camera points
    included: their coordinate divides by 1, finite in value and gradient.
    Coordinates of points within 1e-2 of the source's image plane divide by
    a z that is all cancellation, and are compared by validity only."""
    import jax
    depth, intr, rel = _reproject_case(rng)
    (jc, jv), vjp = jax.vjp(lambda d: jrep.reproject_coords(
        d, jnp.asarray(intr), jnp.asarray(rel)), jnp.asarray(depth))
    td = torch.from_numpy(depth).requires_grad_(True)
    tc, tv = trep.reproject_coords(td, torch.from_numpy(intr),
                                   torch.from_numpy(rel))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert 0.5 < float(tv.mean()) < 0.9            # both kinds are present
    z_far = np.abs(np.asarray(jc)).max(-1) < 1e4   # not at the image plane
    np.testing.assert_allclose(tc.detach().numpy()[z_far],
                               np.asarray(jc)[z_far], rtol=1e-5, atol=1e-4)
    cot = rng.standard_normal(tc.shape).astype(np.float32) \
        * z_far[..., None]
    (jg,) = vjp((jnp.asarray(cot), jnp.zeros_like(jv)))
    tc.backward(torch.from_numpy(cot))
    assert np.all(np.isfinite(td.grad.numpy()))
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_depth_reproject_sample(rng, padding_mode):
    depth, intr, rel = _reproject_case(rng)
    img = rng.standard_normal((3, 12, 16, 3)).astype(np.float32)
    jview, jvalid = jrep.depth_reproject_sample(
        jnp.asarray(img), jnp.asarray(depth), jnp.asarray(intr),
        jnp.asarray(rel), padding_mode=padding_mode)
    view, valid = trep.depth_reproject_sample(
        torch.from_numpy(img), torch.from_numpy(depth),
        torch.from_numpy(intr), torch.from_numpy(rel),
        padding_mode=padding_mode)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    _close(jview, view)
    assert float(view[valid == 0].abs().max()) == 0.0
