"""Input pipeline (port of data/pipeline.py): in-step preprocessing, the
example sources and the stream iterator.

``preprocess`` does on the device what the JAX package does inside its
jitted step: batches travel host -> device as uint8 (a quarter of the f32
bytes) and are normalized there, and ``targets_per_step`` optionally
subsamples the K target views of each example.

The subsample draws from a ``torch.Generator`` per example, seeded from
(data seed, step, global example index: ``index_offset`` plus the index in
the batch, so data-parallel ranks draw independent subsets and the ranks'
draws together equal one process's on the global batch). It is
reproducible, like the JAX package's ``fold_in(fold_in(key(seed), step),
index)`` stream, but it cannot equal that stream: ``jax.random`` and
torch's generators give different numbers for the same seed.

``make_source(cfg)`` gives an indexable example source (``batch(indices)``
a pure function of the indices, so the loop's stream is a function of the
step). ``make_stream_iterator(cfg)`` is the counterpart of the JAX
package's ``make_grain_iterator``: a ``torch.utils.data.DataLoader`` whose
worker processes render or decode whole per-rank batches ahead of the
consumer (``data.grain_workers`` workers, ``data.prefetch`` batches each),
in an order that is a pure function of (seed, epoch); its state, the
number of batches the consumer took, restores it exactly.
"""

from __future__ import annotations

import inspect
import warnings

import numpy as np
import torch
import torch.utils.data

from dynamic_multiview_3d_torch.config import DataConfig
from dynamic_multiview_3d_torch.data.synthetic import SyntheticScenes


def _example_generator(seed: int, step: int, index: int) -> torch.Generator:
    state = np.random.SeedSequence([seed, step, index]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def preprocess(batch: dict, *, device=None, seed: int | None = None,
               step: int = 0, targets_per_step: int = 0,
               index_offset: int = 0) -> dict:
    """Batch of numpy arrays or tensors -> tensors on ``device``.

    uint8 images (``image_seq``, ``tgt_images``) are copied as uint8 and
    mapped to [-1, 1] f32 on the device (x / 127.5 - 1); other floating
    arrays become f32. With ``seed`` given and ``targets_per_step`` fewer
    than the K targets, each example keeps ``targets_per_step`` of them,
    drawn as a random permutation's first entries; example i's draw is
    seeded by its global index ``index_offset + i`` (a data-parallel rank's
    first row in the global batch).
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
                seed, step, index_offset + i))[:targets_per_step]
            for i in range(b)]).to(out["tgt_poses"].device)   # [B, K']
        rows = torch.arange(b, device=idx.device)[:, None]
        for name in ("tgt_poses", "tgt_images"):
            out[name] = out[name][rows, idx]
    return out


def make_source(cfg: DataConfig):
    """The example source of ``cfg``: ``batch(indices)`` is a pure function
    of the indices."""
    if cfg.source == "synthetic":
        return SyntheticScenes(
            num_scenes=cfg.num_scenes, image_size=cfg.image_size,
            seq_len=cfg.seq_len, num_targets=cfg.num_targets,
            dynamic=cfg.dynamic, seed=cfg.seed,
            scene_offset=cfg.scene_offset, src_views=cfg.src_views)
    if cfg.source == "frames":
        from dynamic_multiview_3d_torch.data.frames import (FrameFolderScenes,
                                                            SyntheticFrames)
        if not cfg.root:
            # no export on disk: render the same layout procedurally (fixed
            # per-scene cameras, the packed-bank protocol), so the frames
            # presets (c3mf, c3md) run with no prior setup
            warnings.warn(
                "data.source='frames' with empty data.root: using the "
                "in-memory synthetic frame bank (SyntheticFrames); point "
                "data.root at a cli.make_dataset export for real data",
                stacklevel=2)
            return SyntheticFrames(cfg)
        return FrameFolderScenes(cfg)
    if cfg.source == "tfrecords":
        from dynamic_multiview_3d_torch.data.tfrecords import TFRecordScenes
        return TFRecordScenes(cfg)
    if cfg.source == "shapenet_dir":
        from dynamic_multiview_3d_torch.data.shapenet import ShapeNetDirScenes
        return ShapeNetDirScenes(cfg)
    raise ValueError(f"unknown data source: {cfg.source}")


def num_records(cfg: DataConfig, source) -> int:
    """One nominal epoch: a pass over the scene bank (frames datasets know
    their true scene count), at least one batch."""
    return max(len(getattr(source, "scenes", ())),
               getattr(source, "num_scenes", 0), cfg.batch_size)


def stack_examples(examples: list[dict]) -> dict:
    """The stream's collate: numpy examples -> a numpy batch."""
    return {k: np.stack([e[k] for e in examples]) for k in examples[0]}


class _Examples(torch.utils.data.Dataset):
    """Map-style view of a source for the DataLoader: item i is example
    i (uint8 images with ``raw``). Pickled into each worker process."""

    def __init__(self, source, size: int, raw: bool):
        self.source, self.size, self.raw = source, size, raw
        self.has_raw = "raw" in inspect.signature(source.example).parameters

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, index: int) -> dict:
        if self.has_raw:
            return self.source.example(int(index), raw=self.raw)
        return self.source.example(int(index))


class StreamOrder:
    """This rank's batches of example indices, from batch ``start`` on.

    Epoch e is a permutation of the ``num_records`` indices, seeded by
    (seed, e); rank r of w takes its r-th contiguous share of it (the
    remainder dropped, as Grain's ``ShardOptions(drop_remainder=True)``
    does), and the shares of consecutive epochs form one stream, cut into
    batches of ``local_batch``. Batch b is a pure function of b."""

    def __init__(self, num_records: int, local_batch: int, seed: int,
                 rank: int, world_size: int, num_epochs: int | None,
                 start: int = 0):
        self.num_records, self.local_batch = num_records, local_batch
        self.seed, self.rank, self.world_size = seed, rank, world_size
        self.num_epochs, self.start = num_epochs, start
        self.per_rank = num_records // world_size
        self._share = (None, None)          # (epoch, this rank's share)

    def _epoch(self, epoch: int) -> np.ndarray:
        if self._share[0] != epoch:
            perm = np.random.default_rng(np.random.SeedSequence(
                [self.seed, epoch])).permutation(self.num_records)
            self._share = (epoch, perm[self.rank * self.per_rank:
                                       (self.rank + 1) * self.per_rank])
        return self._share[1]

    def batch(self, b: int) -> list[int] | None:
        """Indices of batch ``b``; None past the last epoch."""
        lo = b * self.local_batch
        hi = lo + self.local_batch
        if self.num_epochs is not None \
                and hi > self.per_rank * self.num_epochs:
            return None
        return [int(self._epoch(p // self.per_rank)[p % self.per_rank])
                for p in range(lo, hi)]

    def __iter__(self):
        b = self.start
        while (indices := self.batch(b)) is not None:
            yield indices
            b += 1


class StreamIterator:
    """Batches from a DataLoader over a source, with a checkpointable
    position: ``get_state()`` holds the number of batches the consumer has
    taken (not those the workers prefetched), and ``set_state()`` restarts
    the workers at that batch. ``close()`` stops the workers."""

    def __init__(self, dataset: _Examples, order: StreamOrder, workers: int,
                 prefetch: int, identity: dict):
        self.dataset, self.order = dataset, order
        self.workers, self.prefetch = workers, prefetch
        self.identity = identity
        self.taken = 0
        self._it = None

    def _start(self):
        self.order.start = self.taken
        kw = {}
        if self.workers:
            # spawn: forking a process that holds a CUDA context is unsafe
            kw = dict(prefetch_factor=self.prefetch,
                      multiprocessing_context="spawn")
        loader = torch.utils.data.DataLoader(
            self.dataset, batch_sampler=self.order, num_workers=self.workers,
            collate_fn=stack_examples, **kw)
        return iter(loader)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if self._it is None:
            self._it = self._start()
        batch = next(self._it)
        self.taken += 1
        return batch

    def get_state(self) -> dict:
        return dict(self.identity, batches_taken=self.taken)

    def set_state(self, state: dict) -> None:
        mine = {k: state.get(k) for k in self.identity}
        if mine != self.identity:
            raise ValueError(f"stream state of another stream: {mine}, "
                             f"this one is {self.identity}")
        self.close()
        self.taken = int(state["batches_taken"])

    def close(self) -> None:
        it, self._it = self._it, None
        if it is not None and hasattr(it, "_shutdown_workers"):
            it._shutdown_workers()


def make_stream_iterator(cfg: DataConfig, rank: int | None = None,
                         world_size: int | None = None,
                         num_epochs: int | None = None) -> StreamIterator:
    """Worker processes render or decode whole batches of
    ``batch_size // world_size`` examples ahead of the consumer (uint8
    images with ``device_preprocess``). ``rank`` and ``world_size`` are
    the data axis's (``parallel.mesh.Mesh.data_rank``, ``data_size``: the
    loop passes them, so that model peers read the same rows); by default
    ``torch.distributed``'s when it is initialised (one process per data
    rank), else 0 and 1."""
    dist = torch.distributed
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    if world_size is None:
        world_size = dist.get_world_size() if dist.is_initialized() else 1
    if cfg.batch_size % world_size:
        raise ValueError(f"batch {cfg.batch_size} not divisible by "
                         f"{world_size} processes")
    source = make_source(cfg)
    size = num_records(cfg, source)
    order = StreamOrder(size, cfg.batch_size // world_size, cfg.seed, rank,
                        world_size, num_epochs)
    identity = {"source": cfg.source, "num_records": size, "seed": cfg.seed,
                "image_size": cfg.image_size,
                "local_batch": order.local_batch, "rank": rank,
                "world_size": world_size}
    return StreamIterator(_Examples(source, size, cfg.device_preprocess),
                          order, cfg.grain_workers, cfg.prefetch, identity)
