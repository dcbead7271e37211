"""Input pipeline (port of data/pipeline.py): in-step preprocessing and the
example source.

``preprocess`` does on the device what the JAX package does inside its
jitted step: batches travel host -> device as uint8 (a quarter of the f32
bytes) and are normalized there, and ``targets_per_step`` optionally
subsamples the K target views of each example.

The subsample draws from a ``torch.Generator`` per example, seeded from
(data seed, step, example index in the batch). It is reproducible, like
the JAX package's ``fold_in(fold_in(key(seed), step), index)`` stream, but
it cannot equal that stream: ``jax.random`` and torch's generators give
different numbers for the same seed.
"""

from __future__ import annotations

import numpy as np
import torch

from dynamic_multiview_3d_torch.config import DataConfig
from dynamic_multiview_3d_torch.data.synthetic import SyntheticScenes


def _example_generator(seed: int, step: int, index: int) -> torch.Generator:
    state = np.random.SeedSequence([seed, step, index]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def preprocess(batch: dict, *, device=None, seed: int | None = None,
               step: int = 0, targets_per_step: int = 0) -> dict:
    """Batch of numpy arrays or tensors -> tensors on ``device``.

    uint8 images (``image_seq``, ``tgt_images``) are copied as uint8 and
    mapped to [-1, 1] f32 on the device (x / 127.5 - 1); other floating
    arrays become f32. With ``seed`` given and ``targets_per_step`` fewer
    than the K targets, each example keeps ``targets_per_step`` of them,
    drawn as a random permutation's first entries.
    """
    out = {}
    for name, x in batch.items():
        t = torch.as_tensor(x, device=device)
        if name in ("image_seq", "tgt_images") and t.dtype == torch.uint8:
            t = t.to(torch.float32) / 127.5 - 1.0
        elif t.is_floating_point():
            t = t.to(torch.float32)
        out[name] = t
    b, k_avail = out["tgt_poses"].shape[:2]
    if targets_per_step and seed is not None and k_avail > targets_per_step:
        idx = torch.stack([
            torch.randperm(k_avail, generator=_example_generator(
                seed, step, i))[:targets_per_step]
            for i in range(b)]).to(out["tgt_poses"].device)   # [B, K']
        rows = torch.arange(b, device=idx.device)[:, None]
        for name in ("tgt_poses", "tgt_images"):
            out[name] = out[name][rows, idx]
    return out


def make_source(cfg: DataConfig):
    """The example source of ``cfg``: ``batch(indices)`` is a pure function
    of the indices. Only the synthetic scene bank is ported."""
    if cfg.source == "synthetic":
        return SyntheticScenes(
            num_scenes=cfg.num_scenes, image_size=cfg.image_size,
            seq_len=cfg.seq_len, num_targets=cfg.num_targets,
            dynamic=cfg.dynamic, seed=cfg.seed,
            scene_offset=cfg.scene_offset, src_views=cfg.src_views)
    if cfg.source in ("frames", "tfrecords", "shapenet_dir"):
        raise NotImplementedError(
            f"data.source={cfg.source!r} is not ported yet: ROADMAP.md "
            "queue 1 item 9 (data sources, with the training loop)")
    raise ValueError(f"unknown data source: {cfg.source}")
