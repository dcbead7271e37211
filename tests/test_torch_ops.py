"""The port's geometry ops (dynamic_multiview_3d_torch.ops) against the JAX
package's, on the same numpy inputs. Tolerance 1e-5: both compute in f32 and
differ only in the order of sums and in transcendental rounding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_multiview_3d_torch.ops import pose as tpose
from dynamic_multiview_3d_torch.ops import sampling as tsamp
from dynamic_multiview_3d_tpu.ops import pose as jpose
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
