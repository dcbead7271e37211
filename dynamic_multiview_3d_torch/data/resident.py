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
target views, t0) on the device from a counter-based integer hash of
(seed, step, global example index, slot), written in int64 ops kept
below 2**49 and masked to 32 bits, so the CPU and CUDA give the same
stream. It cannot equal the JAX package's ``fold_in`` stream (the JAX
device stream differs from its own host stream too); it is seeded and a
pure function of the step, so resume stays exact. A data-parallel rank
draws its rows of the global batch (``index_offset``, its first row), so
the ranks' draws together are one process's draw of the global batch.

Scene-sharded banks (``num_shards`` > 1, ``data.resident_sharding=
"scenes"``): rank r of n materializes and holds only the r-th contiguous
n-th of the scenes, and its device draw picks among those (the JAX
package's shard-local bank); there is no host index path then.
"""

from __future__ import annotations

import numpy as np
import torch

from dynamic_multiview_3d_torch.config import DataConfig


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


# --- the counter-based hash of device_draw --------------------------------

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(x, c: int):
    """(x * c) mod 2**32 for x in [0, 2**32): two 16-bit halves of c, so
    no int64 product passes 2**48."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix(x):
    """A 32-bit integer finalizer (lowbias32) on ints or int64 tensors."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _combine(h, word):
    return _mix(((h ^ word) + _GOLDEN) & _M32)


class ResidentFrames:
    """Device-resident view of a packed FrameFolderScenes dataset: one
    uint8 tensor ``frames`` [S * V * T, H, W, 3] and f32 ``poses``
    [S * V, 3] on ``device``.

    ``index_batch(indices)`` -> small int32 arrays (the only host input
    per step); ``gather(frames, poses, idx)`` -> the standard batch dict on
    the device; ``device_sample(meta, seed, step, batch)`` draws and
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
    def device_draw(meta: dict, seed: int, step: int, batch: int,
                    device, index_offset: int = 0) -> dict:
        """The row indices (int64 tensors on ``device``) of ``batch``
        examples drawn for ``step``: per example a scene, T source views
        (orbit: distinct when V >= T; fixed: one view repeated), K target
        views (distinct when V >= K) and t0, each from the hash of (seed,
        step, global example index ``index_offset + i``, slot). A pure
        function of its arguments, the same on the CPU and on CUDA; no
        host-to-device copy (the seed, step and offset enter as
        scalars)."""
        s, v = meta["num_scenes"], meta["num_views"]
        t_avail, t_len, k = meta["t_avail"], meta["t_len"], \
            meta["num_targets"]
        ex = _combine(_combine(_combine(0, seed & _M32), step & _M32),
                      torch.arange(index_offset, index_offset + batch,
                                   device=device)[:, None])          # [B, 1]

        def hashes(base: int, n: int):                  # [B, n] in [0, 2^32)
            return _combine(ex, torch.arange(n, device=device) + base)

        def distinct(base: int, n: int):         # n of v views, no repeats
            return torch.argsort(hashes(base, v), dim=1, stable=True)[:, :n]

        scene = hashes(0, 1) % s                                 # [B, 1]
        t0 = hashes(1, 1) % (t_avail - t_len + 1)                # [B, 1]
        if not meta.get("orbit", False):          # one camera films all T
            src_views = (hashes(2, 1) % v).expand(batch, t_len)
        elif v >= t_len:
            src_views = distinct(1000, t_len)
        else:
            src_views = hashes(2000, t_len) % v
        tgt_views = distinct(3000, k) if v >= k else hashes(4000, k) % v
        ts = t0 + torch.arange(t_len, device=device)
        return {"seq_idx": (scene * v + src_views) * t_avail + ts,
                "tgt_idx": (scene * v + tgt_views) * t_avail + t0 + t_len
                - 1,
                "src_pose_idx": scene * v + src_views,
                "tgt_pose_idx": scene * v + tgt_views}

    def device_sample(self, meta: dict, seed: int, step: int,
                      batch: int, index_offset: int = 0) -> dict:
        """``device_draw`` on the bank's device, gathered: a batch with no
        host input (data.device_sampling)."""
        idx = self.device_draw(meta, seed, step, batch, self.frames.device,
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
