"""The port's numpy scene bank (data/synthetic.py) against the JAX package's.

Scenes, poses, the example layout and every rendered pixel must be
identical: the port's ``fill_convex_poly`` is a numpy copy of what
``cv2.fillConvexPoly(..., lineType=cv2.LINE_AA)`` does to a float32 image
(OpenCV draws such an image with ``LINE_8``), held bit for bit to cv2 on
seeded convex polygons inside, across and far outside the image and on
degenerate ones.
"""

import time

import cv2
import numpy as np
import pytest

from dynamic_multiview_3d_torch.data import synthetic as tsyn
from dynamic_multiview_3d_tpu.data import synthetic as jsyn


def test_scene_bank_matches_jax():
    kw = dict(num_scenes=4, image_size=64, seq_len=3, num_targets=2,
              dynamic=True, seed=3)
    ours, ref = tsyn.SyntheticScenes(**kw), jsyn.SyntheticScenes(**kw)
    for sid in range(4):
        a, b = ours.scene_params(sid), ref.scene_params(sid)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    a, b = ours.batch([0, 5], raw=True), ref.batch([0, 5], raw=True)
    assert {k: v.shape for k, v in a.items()} == \
        {k: v.shape for k, v in b.items()}
    for k in ("src_poses", "tgt_poses"):
        np.testing.assert_array_equal(a[k], b[k])
    for k in ("image_seq", "tgt_images"):
        assert a[k].dtype == np.uint8
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(tsyn.to_model(b["image_seq"]),
                                  jsyn.to_model(b["image_seq"]))


def test_look_at_matches_jax():
    pose = np.array([0.7, 0.4, 2.5], np.float32)
    np.testing.assert_array_equal(tsyn.look_at_np(pose), jsyn.look_at_np(pose))


def test_fill_convex_poly_covers_interior_and_edges():
    img = np.zeros((8, 8, 1), np.float32)
    tsyn.fill_convex_poly(img, np.array([[1, 1], [5, 1], [5, 4], [1, 4]]),
                          np.float32([1.0]))
    want = np.zeros((8, 8), np.float32)
    want[1:5, 1:6] = 1.0
    np.testing.assert_array_equal(img[..., 0], want)
    # clipped at the image border, either winding order
    tsyn.fill_convex_poly(img, np.array([[-3, 6], [4, 6], [4, 12]]),
                          np.float32([2.0]))
    assert img[6, 0, 0] == 2.0 and img[7, 4, 0] == 2.0 and img[5, 0, 0] == 0


def _convex(rng, n, center, radius):
    """n integer vertices of a convex polygon (sorted angles on an
    ellipse; either winding), rounded as the renderer rounds them."""
    ang = np.sort(rng.uniform(0.0, 2 * np.pi, n))
    if rng.random() < 0.5:
        ang = ang[::-1]
    r = rng.uniform(0.2, 1.0, 2) * radius
    poly = np.stack([center[0] + r[0] * np.cos(ang),
                     center[1] + r[1] * np.sin(ang)], -1)
    return np.round(poly).astype(np.int32)


def _polygons(kind, rng, count=200):
    """Seeded convex polygons of 3 or 4 vertices on a 48 x 64 image."""
    out = []
    for _ in range(count):
        n = int(rng.integers(3, 5))
        if kind == "inside":
            p = _convex(rng, n, rng.uniform(16, 40, 2), 14)
        elif kind == "partly_off":
            p = _convex(rng, n, rng.uniform(-20, 80, 2), 40)
        elif kind == "far_off":
            p = _convex(rng, n, rng.uniform(-2e4, 2e4, 2), 5e3)
        elif rng.random() < 0.5:    # a repeated vertex, or a single point
            p = _convex(rng, n, rng.uniform(0, 60, 2), 20)
            p[1:2 if rng.random() < 0.6 else n] = p[0]
        else:                       # collinear vertices
            a, b = rng.integers(-20, 80, (2, 2))
            p = np.stack([a, (a + b) // 2, b, b][:n]).astype(np.int32)
        out.append(p)
    return out


@pytest.mark.parametrize("kind", ["inside", "partly_off", "far_off",
                                  "degenerate"])
def test_fill_convex_poly_matches_cv2_bitwise(kind):
    """Each polygon filled into a random float32 [64, 48, 3] image by the
    port and by cv2 (the call the JAX package makes) gives the same
    image, bit for bit."""
    rng = np.random.default_rng(["inside", "partly_off", "far_off",
                                 "degenerate"].index(kind))
    for poly in _polygons(kind, rng):
        base = rng.uniform(0, 1, (64, 48, 3)).astype(np.float32)
        color = rng.uniform(0, 1, 3).astype(np.float32)
        ref, ours = base.copy(), base.copy()
        cv2.fillConvexPoly(ref, poly, tuple(float(c) for c in color),
                           lineType=cv2.LINE_AA)
        tsyn.fill_convex_poly(ours, poly, color)
        np.testing.assert_array_equal(ours, ref, err_msg=str(poly.tolist()))


@pytest.mark.parametrize("dynamic", [False, True])
def test_render_and_example_match_jax_bitwise(dynamic):
    """Seeded scenes rendered at seeded poses and times, and whole
    examples, are equal in both packages; the render time a 128² frame of
    each is printed (CPU)."""
    kw = dict(num_scenes=16, image_size=128, seq_len=3, num_targets=2,
              dynamic=dynamic, seed=11)
    ours, ref = tsyn.SyntheticScenes(**kw), jsyn.SyntheticScenes(**kw)
    poses = ours.sample_poses(np.random.default_rng(5), 32)
    times = {"port": 0.0, "jax": 0.0}
    for i, pose in enumerate(poses):
        frames = {}
        for name, bank in (("port", ours), ("jax", ref)):
            t0 = time.perf_counter()
            frames[name] = bank.render(i % 16, pose, time=0.5 * (i % 3))
            times[name] += time.perf_counter() - t0
        np.testing.assert_array_equal(frames["port"], frames["jax"])
    print(f"render ms a 128x128 frame (CPU, {len(poses)} frames): port "
          f"{1e3 * times['port'] / len(poses):.3f}, jax "
          f"{1e3 * times['jax'] / len(poses):.3f}")
    for index in (0, 7, 21):
        a, b = ours.example(index), ref.example(index)
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
