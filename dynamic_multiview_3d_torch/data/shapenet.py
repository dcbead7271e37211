"""Reader of the published ShapeNet renderings layout (port of
data/shapenet.py; 3D-R2N2 convention, ``data.source="shapenet_dir"``):

    root/
      <synset_id>/                 # e.g. 02958343 (optional level)
        <model_id>/
          rendering/               # (or the files directly in <model_id>/)
            00.png ... 23.png      # V views, RGBA on transparent bg
            rendering_metadata.txt # per line: az° el° in-plane-rot°
                                   #           distance field-of-view
            renderings.txt         # view filenames (optional)

Each model directory is one static scene; the metadata lines become
(az, el, radius) pose rows (degrees -> radians; the distance column is the
radius), and RGBA frames are composited over white at read time by the JAX
package's integer formula. Sampling and batching are FrameFolderScenes'.
``export_fixture`` writes procedural scenes into this layout (a fixture for
tests and smoke training).
"""

from __future__ import annotations

import os

import numpy as np

from dynamic_multiview_3d_torch.config import DataConfig
from dynamic_multiview_3d_torch.data.frames import FrameFolderScenes
from dynamic_multiview_3d_torch.utils.png import encode_png, read_png

_META_NAME = "rendering_metadata.txt"


def _find_scene_dirs(root: str) -> list[str]:
    """Model directories, as root-relative paths, in sorted order: all
    three published arrangements, <root>/<synset>/<model>/rendering/,
    <root>/<model>/rendering/, and metadata directly in <root>/<model>/."""
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        if _META_NAME in filenames:
            out.append(os.path.relpath(dirpath, root))
            dirnames.clear()              # metadata dirs don't nest
    return sorted(out)


class ShapeNetDirScenes(FrameFolderScenes):
    """Random-access examples over a ShapeNet-renderings directory."""

    def __init__(self, cfg: DataConfig):
        if not cfg.root or not os.path.isdir(cfg.root):
            raise FileNotFoundError(
                f"shapenet_dir dataset root not found: {cfg.root!r}")
        self.cfg = cfg
        self.scenes = _find_scene_dirs(cfg.root)
        if not self.scenes:
            raise FileNotFoundError(
                f"no {_META_NAME} found anywhere under {cfg.root}: not a "
                "ShapeNet renderings layout")
        self._meta_cache: dict[str, dict] = {}
        self._pack_cache: dict[str, np.ndarray] = {}

    def _meta(self, scene: str) -> dict:
        if scene not in self._meta_cache:
            sdir = os.path.join(self.cfg.root, scene)
            # columns: azimuth° elevation° in-plane-rotation° distance fov
            meta_rows = np.loadtxt(os.path.join(sdir, _META_NAME),
                                   dtype=np.float64, ndmin=2)
            poses = np.stack([
                np.deg2rad(meta_rows[:, 0]),
                np.deg2rad(meta_rows[:, 1]),
                meta_rows[:, 3],
            ], axis=-1).astype(np.float32)
            self._meta_cache[scene] = {
                "num_views": int(meta_rows.shape[0]),
                "seq_len": 1,             # renderings are static
                "dynamic": False,
                "poses": poses,
                "packed": False,
            }
        return self._meta_cache[scene]

    def _read_frame(self, scene: str, view: int, t: int) -> np.ndarray:
        del t                             # static: one timestep per view
        img = read_png(os.path.join(self.cfg.root, scene, f"{view:02d}.png"))
        if img.ndim == 2:                 # grayscale -> RGB
            img = np.repeat(img[..., None], 3, axis=-1)
        if img.shape[-1] == 4:            # RGBA -> composite over white
            rgb = img[..., :3].astype(np.uint16)
            a = img[..., 3:4].astype(np.uint16)
            img = ((rgb * a + 255 * (255 - a)) // 255).astype(np.uint8)
        return img[..., :3]


def export_fixture(root: str, num_scenes: int = 4, image_size: int = 64,
                   num_views: int = 8, seed: int = 0,
                   with_synset_level: bool = True, rgba: bool = True,
                   nested_rendering: bool = True,
                   model_prefix: str = "model") -> str:
    """Write procedural scenes in the 3D-R2N2 layout (a fixture).

    rgba adds a fully opaque alpha channel, so the reader's compositing
    runs; with_synset_level nests models one level deeper, as the release
    does; nested_rendering=False puts the files directly in the model
    directory (the flattened arrangement some mirrors ship)."""
    from dynamic_multiview_3d_torch.data.synthetic import SyntheticScenes

    src = SyntheticScenes(num_scenes=num_scenes, image_size=image_size,
                          dynamic=False, seed=seed)
    rng = np.random.default_rng(seed)
    for i in range(num_scenes):
        parts = [root]
        if with_synset_level:
            parts.append("02958343")
        parts.append(f"{model_prefix}{i:04d}")
        if nested_rendering:
            parts.append("rendering")
        sdir = os.path.join(*parts)
        os.makedirs(sdir, exist_ok=True)
        poses = src.sample_poses(rng, num_views)      # (az, el, radius) rad
        rows = []
        for v in range(num_views):
            img = src.render(i, poses[v], time=0.0)   # [H, W, 3] uint8
            if rgba:
                img = np.concatenate(
                    [img, np.full(img.shape[:2] + (1,), 255, np.uint8)],
                    axis=-1)
            with open(os.path.join(sdir, f"{v:02d}.png"), "wb") as f:
                f.write(encode_png(img))
            rows.append(f"{np.rad2deg(poses[v, 0]):.6f} "
                        f"{np.rad2deg(poses[v, 1]):.6f} 0.000000 "
                        f"{poses[v, 2]:.6f} 25.000000")
        with open(os.path.join(sdir, _META_NAME), "w") as f:
            f.write("\n".join(rows) + "\n")
        with open(os.path.join(sdir, "renderings.txt"), "w") as f:
            f.write("\n".join(f"{v:02d}.png" for v in range(num_views)) + "\n")
    return root
