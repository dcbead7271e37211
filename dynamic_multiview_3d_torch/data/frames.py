"""Frame-folder video dataset (port of data/frames.py).

On-disk layout:

    root/
      scene_00000/
        meta.json          # {"num_views": V, "seq_len": T_avail, "dynamic": bool}
        poses.npy          # [V, 3] float32 (az, el, radius) per camera
        v000_t000.png      # frame for view v at time t
        ...

Two frame encodings per scene: PNG files, decoded with the port's own
reader (``utils.png.read_png``), or ``frames.npy``, one uint8
[V, T, H, W, 3] bank memory-mapped at read time (decode-free).
``export_synthetic(fmt="packed")`` writes the second; readers detect it.

``example(index)`` samples a source camera trajectory and K target views at
the final timestep, with the same contract and the same draws as the JAX
package's ``FrameFolderScenes``: on the same files both give the same
uint8 examples. ``SyntheticFrames`` serves that layout with no files: the
port's procedural renderer draws each frame on first access.
"""

from __future__ import annotations

import json
import os

import numpy as np

from dynamic_multiview_3d_torch.config import DataConfig
from dynamic_multiview_3d_torch.data import native
from dynamic_multiview_3d_torch.data.synthetic import SyntheticScenes
from dynamic_multiview_3d_torch.utils.png import encode_png, read_png


class FrameFolderScenes:
    """Random-access examples over a frame-folder dataset."""

    def __init__(self, cfg: DataConfig):
        if not cfg.root or not os.path.isdir(cfg.root):
            raise FileNotFoundError(
                f"frames dataset root not found: {cfg.root!r} "
                "(generate one with data.frames.export_synthetic)")
        self.cfg = cfg
        self.scenes = sorted(
            d for d in os.listdir(cfg.root)
            if d.startswith("scene_")
            and os.path.isdir(os.path.join(cfg.root, d)))
        if not self.scenes:
            raise FileNotFoundError(f"no scene_* dirs under {cfg.root}")
        self._meta_cache: dict[str, dict] = {}
        self._pack_cache: dict[str, np.ndarray] = {}

    def __getstate__(self) -> dict:
        """For worker processes: no memory-mapped banks (they would pickle
        as copies of the data) and no metadata; both are read again."""
        state = dict(self.__dict__)
        state["_meta_cache"] = {}
        state["_pack_cache"] = {}
        return state

    def _meta(self, scene: str) -> dict:
        if scene not in self._meta_cache:
            with open(os.path.join(self.cfg.root, scene, "meta.json")) as f:
                meta = json.load(f)
            meta["poses"] = np.load(
                os.path.join(self.cfg.root, scene, "poses.npy"))
            meta["packed"] = os.path.exists(
                os.path.join(self.cfg.root, scene, "frames.npy"))
            self._meta_cache[scene] = meta
        return self._meta_cache[scene]

    def _packed(self, scene: str) -> np.ndarray:
        """Memory-mapped [V, T, H, W, 3] uint8 frame bank for the scene."""
        if scene not in self._pack_cache:
            self._pack_cache[scene] = np.load(
                os.path.join(self.cfg.root, scene, "frames.npy"),
                mmap_mode="r")
        return self._pack_cache[scene]

    def materialize_packed(self, scenes=None) -> None:
        """Decode every frame once into in-memory uint8 banks, making a
        decode-based source (PNG folders, tfrecords, shapenet_dir) eligible
        for the device-resident path (``data.materialize_packed``).
        Polymorphic over ``_read_frame``, so subclasses inherit it. Host RAM
        holds the whole dataset meanwhile (the bytes the device will);
        scenes already packed are untouched. ``scenes``: only those (a
        scene-sharded bank's share)."""
        s = self.cfg.image_size
        for scene in self.scenes if scenes is None else scenes:
            meta = self._meta(scene)
            if meta.get("packed"):
                continue
            v, t = meta["num_views"], meta["seq_len"]
            bank = np.stack([
                np.stack([self._read_frame(scene, vi, ti)
                          for ti in range(t)]) for vi in range(v)])
            if bank.shape[2:4] != (s, s):     # bank contract: cfg-sized
                bank = self._resize_u8(
                    bank.reshape(v * t, *bank.shape[2:])
                ).reshape(v, t, s, s, 3)
            self._pack_cache[scene] = np.ascontiguousarray(bank)
            meta["packed"] = True

    def _read_frame(self, scene: str, view: int, t: int) -> np.ndarray:
        if self._meta(scene)["packed"]:
            return np.asarray(self._packed(scene)[view, t])
        return read_png(os.path.join(self.cfg.root, scene,
                                     f"v{view:03d}_t{t:03d}.png"))

    def _resize_u8(self, frames: np.ndarray) -> np.ndarray:
        s = self.cfg.image_size
        return native.resize_u8(frames, s, s)

    def sample_indices(self, index: int) \
            -> tuple[int, np.ndarray, np.ndarray, int]:
        """Deterministic draw for example ``index``:
        (scene_i, src_views[T], tgt_views[K], t0). Shared by the host
        decode path (example) and the device-resident gather
        (data.resident), so both produce the identical training stream.

        cfg.src_views="fixed": one camera films the whole sequence
        (src_views is T copies of one draw). "orbit": frame t comes from
        its own camera (distinct views when V >= T)."""
        cfg = self.cfg
        scene_i = index % len(self.scenes)
        meta = self._meta(self.scenes[scene_i])
        v_avail, t_avail = meta["num_views"], meta["seq_len"]
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed + 7, int(index)]))
        t_len = min(cfg.seq_len, t_avail)
        k = cfg.num_targets
        if cfg.src_views == "orbit":
            src_views = rng.choice(v_avail, size=t_len,
                                   replace=(v_avail < t_len))
        else:
            src_views = np.full(t_len, rng.integers(v_avail))
        tgt_views = rng.choice(v_avail, size=k, replace=(v_avail < k))
        t0 = int(rng.integers(t_avail - t_len + 1))
        return scene_i, src_views.astype(np.int64), tgt_views, t0

    def example(self, index: int, raw: bool = False) -> dict:
        """One example; ``raw`` keeps the images uint8 (resized to
        data.image_size), else f32 in [-1, 1] from the packer."""
        cfg = self.cfg
        scene_i, src_views, tgt_views, t0 = self.sample_indices(index)
        scene = self.scenes[scene_i]
        meta = self._meta(scene)
        poses = meta["poses"]
        t_avail = meta["seq_len"]
        t_len = min(cfg.seq_len, t_avail)
        s = cfg.image_size
        src_poses = poses[src_views].astype(np.float32)    # [T, P]

        if not raw and meta["packed"]:
            bank = self._packed(scene)                 # [V, T, H, W, 3]
            if bank.shape[2:4] == (s, s):
                # f32 fast path: one gather + normalize straight off the
                # bank; only the selected rows' pages are touched
                flat = bank.reshape(-1, *bank.shape[2:])
                rows = np.concatenate([
                    src_views * t_avail + t0 + np.arange(t_len),
                    np.asarray(tgt_views) * t_avail + t0 + t_len - 1])
                packed = native.gather_pack(flat, rows,
                                            native=cfg.use_native_packer)
                return {
                    "image_seq": packed[:t_len],
                    "src_poses": src_poses,
                    "tgt_poses": poses[tgt_views].astype(np.float32),
                    "tgt_images": packed[t_len:],
                }

        frames = np.stack([
            self._read_frame(scene, int(src_views[t]), t0 + t)
            for t in range(t_len)])
        targets = np.stack([
            self._read_frame(scene, int(v), t0 + t_len - 1)
            for v in tgt_views])

        if raw:
            # uint8: resized on the host, normalized on the device
            image_seq = self._resize_u8(frames)
            tgt_images = self._resize_u8(targets)
        else:
            image_seq = native.resize_normalize_pack(
                frames, s, s, native=cfg.use_native_packer)
            tgt_images = native.resize_normalize_pack(
                targets, s, s, native=cfg.use_native_packer)
        return {
            "image_seq": image_seq,
            "src_poses": src_poses,
            "tgt_poses": poses[tgt_views].astype(np.float32),
            "tgt_images": tgt_images,
        }

    def batch(self, indices, raw: bool = False) -> dict:
        exs = [self.example(int(i), raw=raw) for i in indices]
        return {k: np.stack([e[k] for e in exs]) for k in exs[0]}


class SyntheticFrames(FrameFolderScenes):
    """Disk-free frame-folder view of the procedural renderer.

    The dataset ``export_synthetic(fmt="packed")`` would write (fixed
    per-scene cameras, [V, T] frame banks), rendered on first access
    instead of read from disk, so every FrameFolderScenes mechanism (orbit
    ``sample_indices``, ``materialize_packed``, the device-resident and
    ``device_sampling`` path) works with no prior setup. This is what
    ``data.source="frames"`` with an empty ``data.root`` resolves to.
    The cameras and draws equal the JAX package's; the pixels differ along
    face edges (the port's renderer fills faces without anti-aliasing).
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.num_views = max(8, cfg.seq_len, cfg.num_targets)
        self._renderer = SyntheticScenes(
            num_scenes=cfg.scene_offset + cfg.num_scenes,
            image_size=cfg.image_size, dynamic=cfg.dynamic, seed=cfg.seed)
        self.scenes = [f"scene_{cfg.scene_offset + i:05d}"
                       for i in range(cfg.num_scenes)]
        self._sid = {name: cfg.scene_offset + i
                     for i, name in enumerate(self.scenes)}
        self._meta_cache: dict[str, dict] = {}
        self._pack_cache: dict[str, np.ndarray] = {}

    def _meta(self, scene: str) -> dict:
        if scene not in self._meta_cache:
            sid = self._sid[scene]
            # per-scene camera draw, seeded like export_synthetic's stream
            rng = np.random.default_rng(
                np.random.SeedSequence([self.cfg.seed + 3, sid]))
            self._meta_cache[scene] = {
                "num_views": self.num_views,
                "seq_len": self.cfg.seq_len,
                "dynamic": self.cfg.dynamic,
                "poses": self._renderer.sample_poses(rng, self.num_views),
                "packed": False,
            }
        return self._meta_cache[scene]

    def _packed(self, scene: str) -> np.ndarray:
        if scene not in self._pack_cache:       # rendered by _read_frame
            raise KeyError(f"{scene} not materialized "
                           "(call materialize_packed)")
        return self._pack_cache[scene]

    def _read_frame(self, scene: str, view: int, t: int) -> np.ndarray:
        if scene in self._pack_cache:
            return np.asarray(self._pack_cache[scene][view, t])
        meta = self._meta(scene)
        return self._renderer.render(self._sid[scene], meta["poses"][view],
                                     time=float(t))


def export_synthetic(root: str, num_scenes: int = 8, image_size: int = 128,
                     num_views: int = 12, seq_len: int = 4,
                     dynamic: bool = True, seed: int = 0,
                     fmt: str = "png", scene_offset: int = 0) -> str:
    """Materialize synthetic scenes as a frame-folder dataset on disk.

    fmt="png": one PNG per frame (real decode work at read time).
    fmt="packed": one memory-mappable ``frames.npy`` uint8 bank per scene.
    scene_offset shifts the procedural scene ids: disjoint offsets give
    disjoint scene geometry (held-out-scene evaluation splits).
    """
    if fmt not in ("png", "packed"):
        raise ValueError(f"unknown frames format: {fmt!r}")
    src = SyntheticScenes(num_scenes=scene_offset + num_scenes,
                          image_size=image_size, dynamic=dynamic, seed=seed)
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(num_scenes):
        sid = scene_offset + i
        sdir = os.path.join(root, f"scene_{sid:05d}")
        os.makedirs(sdir, exist_ok=True)
        poses = src.sample_poses(rng, num_views)
        np.save(os.path.join(sdir, "poses.npy"), poses)
        with open(os.path.join(sdir, "meta.json"), "w") as f:
            json.dump({"num_views": num_views, "seq_len": seq_len,
                       "dynamic": dynamic}, f)
        bank = np.stack([
            np.stack([src.render(sid, poses[v], time=float(t))
                      for t in range(seq_len)])
            for v in range(num_views)])              # [V, T, H, W, 3] u8
        if fmt == "packed":
            np.save(os.path.join(sdir, "frames.npy"), bank)
            continue
        for v in range(num_views):
            for t in range(seq_len):
                with open(os.path.join(sdir, f"v{v:03d}_t{t:03d}.png"),
                          "wb") as f:
                    f.write(encode_png(bank[v, t]))
    return root
