"""The port's numpy scene bank (data/synthetic.py) against the JAX package's.

Scenes, poses and the example layout must be identical. The port fills
faces without OpenCV's anti-aliasing, so rendered pixels may differ along
face edges only: held to a mean difference under 3 of 255 levels and under
5% of pixels off by more than 8 levels.
"""

import numpy as np

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
        d = np.abs(a[k].astype(np.int32) - b[k].astype(np.int32))
        assert d.mean() < 3.0 and (d > 8).mean() < 0.05, (d.mean(),
                                                          (d > 8).mean())
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
