"""Device-resident dataset mode (port of data/resident.py).

The packed uint8 frame banks live on the device for the whole run: they
are uploaded once at start, and a train step receives int32 row indices
(a few KB) instead of megabytes of pixels, or, with
``data.device_sampling``, nothing at all. The gather (``frames[rows]``)
runs on the device and the step normalizes the uint8 pixels there
(``pipeline.preprocess``), as the host uint8 path does.

``index_batch`` draws with the source's ``sample_indices``, so the
resident stream equals the host path's example for example (the JAX
package's arrays, exactly). ``device_draw`` draws (scene, source views,
target views, t0) on the device exactly as the JAX package's
``device_sample`` draws them with ``jax.random`` from the same key
(``kernels/jax_draw.py``, ``utils/jax_random.py``), for the same (step
key, index_offset, meta): a JAX run moved to the card trains on the
examples the JAX run would have drawn. (The device stream is not the host
``sample_indices`` stream, in either package.) It is a pure function of
the step, so resume stays exact. A data-parallel rank draws its rows of
the global batch (``index_offset``, its first row), so the ranks' draws
together are one process's draw of the global batch.

Scene-sharded banks (``num_shards`` > 1, ``data.resident_sharding=
"scenes"``): rank r of n materializes and holds only the r-th contiguous
n-th of the scenes, and its device draw picks among those (the JAX
package's shard-local bank); there is no host index path then.
"""

from __future__ import annotations

import numpy as np
import torch

from dynamic_multiview_3d_torch.config import DataConfig
from dynamic_multiview_3d_torch.kernels.jax_draw import jax_draw


def bank_nbytes(num_scenes: int, num_views: int, t_avail: int,
                image_size: int) -> int:
    """Bytes of a resident uint8 bank [S * V * T, s, s, 3]."""
    return num_scenes * num_views * t_avail * image_size * image_size * 3


def shard_scenes(source, num_shards: int = 1, shard: int = 0) -> list:
    """The scenes of shard ``shard`` of ``num_shards``: a contiguous
    share of ``source.scenes`` (all of them for one shard)."""
    if len(source.scenes) % num_shards:
        raise ValueError(
            f"resident_sharding='scenes' needs the scene count "
            f"({len(source.scenes)}) divisible by the data mesh size "
            f"({num_shards})")
    per = len(source.scenes) // num_shards
    return source.scenes[shard * per:(shard + 1) * per]


def fits_budget(source, cfg: DataConfig, num_shards: int = 1,
                shard: int = 0) -> bool:
    """True when every scene of the shard is packed, uniform, and its
    stacked bank fits cfg.resident_budget_mb (the whole bank for one
    shard; a scene-sharded bank's share on its rank)."""
    try:
        scenes = shard_scenes(source, num_shards, shard)
        metas = [source._meta(s) for s in scenes]
    except (OSError, KeyError, ValueError, AttributeError):
        # expected ineligibility: missing or corrupt meta files, or a
        # source without the packed-bank protocol
        return False
    if not all(m.get("packed") for m in metas):
        return False
    v0, t0 = metas[0]["num_views"], metas[0]["seq_len"]
    if not all(m["num_views"] == v0 and m["seq_len"] == t0 for m in metas):
        return False
    total = bank_nbytes(len(scenes), v0, t0, cfg.image_size)
    return total <= cfg.resident_budget_mb * 1024 * 1024


class ResidentFrames:
    """Device-resident view of a packed FrameFolderScenes dataset: one
    uint8 tensor ``frames`` [S * V * T, H, W, 3] and f32 ``poses``
    [S * V, 3] on ``device``.

    ``index_batch(indices)`` -> small int32 arrays (the only host input
    per step); ``gather(frames, poses, idx)`` -> the standard batch dict on
    the device; ``device_sample(meta, key, batch)`` draws and
    gathers a batch with no host input.
    """

    def __init__(self, source, cfg: DataConfig, device="cuda",
                 num_shards: int = 1, shard: int | None = None):
        """``num_shards`` > 1: the scene-sharded bank of shard ``shard``
        (required then), its contiguous share of the scenes."""
        self.cfg = cfg
        self.source = source
        self.num_shards = num_shards
        if shard is None:
            if num_shards > 1:
                raise ValueError(f"a bank of {num_shards} scene shards "
                                 "needs its shard")
            shard = 0
        # this shard's scenes: [scene_offset, scene_offset + num_scenes)
        scenes = shard_scenes(source, num_shards, shard)
        self.num_scenes = len(scenes)
        self.scene_offset = shard * self.num_scenes
        metas = [source._meta(s) for s in scenes]
        self.num_views = v = metas[0]["num_views"]
        self.t_avail = t = metas[0]["seq_len"]
        self.t_len = min(cfg.seq_len, self.t_avail)
        s = cfg.image_size
        self.nbytes = bank_nbytes(self.num_scenes, v, t, s)
        self.frames = torch.empty((self.num_scenes * v * t, s, s, 3),
                                  dtype=torch.uint8, device=device)
        for i, scene in enumerate(scenes):                # one scene a copy
            bank = np.asarray(source._packed(scene))
            if bank.shape[2:4] != (s, s):
                bank = source._resize_u8(
                    bank.reshape(v * t, *bank.shape[2:]))
            bank = np.require(bank.reshape(v * t, s, s, 3), np.uint8,
                              ["C", "W"])
            self.frames[i * v * t:(i + 1) * v * t].copy_(
                torch.from_numpy(bank))
        poses = np.concatenate([m["poses"][:v] for m in metas])
        self.poses = torch.from_numpy(
            poses.astype(np.float32)).to(device)              # [S*V, P]

    def _flat(self, scene_i: int, view, t) -> np.ndarray:
        return (np.asarray(scene_i) * self.num_views
                + np.asarray(view)) * self.t_avail + np.asarray(t)

    def index_batch(self, indices) -> dict:
        """Host side: the draws of FrameFolderScenes.example, reduced to
        flat row indices (int32; ~16 bytes an image instead of its
        pixels)."""
        if self.num_shards > 1:
            raise ValueError(
                "scene-sharded residency has no host index path (global "
                "row ids cannot address a shard-local bank); use "
                "data.device_sampling")
        seq_idx, tgt_idx, src_pose_idx, tgt_pose_idx = [], [], [], []
        for index in indices:
            scene_i, src_views, tgt_views, t0 = \
                self.source.sample_indices(int(index))
            ts = t0 + np.arange(self.t_len)
            seq_idx.append(self._flat(scene_i, src_views, ts))
            tgt_idx.append(self._flat(scene_i, tgt_views,
                                      t0 + self.t_len - 1))
            src_pose_idx.append(scene_i * self.num_views + src_views)
            tgt_pose_idx.append(scene_i * self.num_views + tgt_views)
        return {
            "seq_idx": np.asarray(seq_idx, np.int32),          # [B, T]
            "tgt_idx": np.asarray(tgt_idx, np.int32),          # [B, K]
            "src_pose_idx": np.asarray(src_pose_idx, np.int32),  # [B, T]
            "tgt_pose_idx": np.asarray(tgt_pose_idx, np.int32),  # [B, K]
        }

    def sample_meta(self) -> dict:
        """Static shape facts the device-side sampler needs."""
        return {"num_scenes": self.num_scenes, "num_views": self.num_views,
                "t_avail": self.t_avail, "t_len": self.t_len,
                "num_targets": self.cfg.num_targets,
                "orbit": self.cfg.src_views == "orbit"}

    @staticmethod
    def device_draw(meta: dict, key: tuple, batch: int, device,
                    index_offset: int = 0) -> dict:
        """The row indices (int64 tensors on ``device``) of ``batch``
        examples drawn as the JAX package's ``device_sample`` draws them
        from a step's sampling key ``key``, a pair of uint32 ints (the
        step's ``k_samp``: ``utils.jax_random.step_keys(seed, step,
        True)[1]``): per example
        ``fold_in(key, index_offset + i)`` split four ways, then a scene,
        T source views (orbit: a permutation's first T when V >= T;
        fixed: one view repeated), K target views (a permutation's first
        K when V >= K) and t0 (``kernels/jax_draw.py``: on CUDA one kernel
        launch, on the CPU its plain version). No host-to-device copy: the
        key and the offset enter as scalars."""
        return jax_draw(meta, key, batch, device, index_offset)

    def device_sample(self, meta: dict, key: tuple, batch: int,
                      index_offset: int = 0) -> dict:
        """``device_draw`` on the bank's device, gathered: a batch with no
        host input (data.device_sampling)."""
        idx = self.device_draw(meta, key, batch, self.frames.device,
                               index_offset)
        return self.gather(self.frames, self.poses, idx)

    @staticmethod
    def gather(frames: torch.Tensor, poses: torch.Tensor, idx: dict) -> dict:
        """Resident rows -> the standard batch (uint8 images, f32 poses)
        on the bank's device; ``idx`` holds integer tensors or arrays."""
        def take(table, rows):
            rows = torch.as_tensor(rows, device=table.device)
            return table.index_select(0, rows.reshape(-1)).reshape(
                *rows.shape, *table.shape[1:])

        return {"image_seq": take(frames, idx["seq_idx"]),   # [B,T,H,W,3]
                "src_poses": take(poses, idx["src_pose_idx"]),  # [B,T,P]
                "tgt_poses": take(poses, idx["tgt_pose_idx"]),  # [B,K,P]
                "tgt_images": take(frames, idx["tgt_idx"])}  # [B,K,H,W,3]
