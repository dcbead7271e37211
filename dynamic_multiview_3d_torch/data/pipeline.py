"""Input pipeline (port of data/pipeline.py): in-step preprocessing, the
example sources and the stream iterator.

``preprocess`` does on the device what the JAX package does inside its
jitted step: batches travel host -> device as uint8 (a quarter of the f32
bytes) and are normalized there, and ``targets_per_step`` optionally
subsamples the K target views of each example.

The subsample is the JAX package's: example i keeps
``permutation(fold_in(key, index_offset + i), K)[:K']`` of its targets,
drawn with the port's copy of ``jax.random`` (``utils/jax_random.py``)
from the step's key (a pair of Python ints, ``jax_random.step_keys``) at
its global index (``index_offset`` plus the index in the batch, so
data-parallel ranks draw independent subsets and the ranks' draws
together equal one process's on the global batch). A JAX run moved to the
card keeps its subsets; the draw runs on the batch's device from the key
as scalars, with no host-to-device copy.

``make_source(cfg)`` gives an indexable example source (``batch(indices)``
a pure function of the indices, so the loop's stream is a function of the
step). ``make_stream_iterator(cfg)`` is the counterpart of the JAX
package's ``make_grain_iterator``: a ``torch.utils.data.DataLoader`` whose
worker processes render or decode whole per-rank batches ahead of the
consumer (``data.grain_workers`` workers, ``data.prefetch`` batches each).
Its batches hold the records the JAX package's Grain iterator yields, in
its order (``data/grain_order.py``: Grain's shuffle, epochs and worker
interleave), and its state is that iterator's state, so a streamed run
resumes in either package where the other stopped; no Grain is imported.
"""

from __future__ import annotations

import inspect
import warnings

import numpy as np
import torch
import torch.utils.data

from dynamic_multiview_3d_torch.config import DataConfig
from dynamic_multiview_3d_torch.data.grain_order import GrainOrder
from dynamic_multiview_3d_torch.data.synthetic import SyntheticScenes
from dynamic_multiview_3d_torch.utils import jax_random as jr


def preprocess(batch: dict, *, device=None, key: tuple | None = None,
               targets_per_step: int = 0, index_offset: int = 0) -> dict:
    """Batch of numpy arrays or tensors -> tensors on ``device``.

    uint8 images (``image_seq``, ``tgt_images``) are copied as uint8 and
    mapped to [-1, 1] f32 on the device (x / 127.5 - 1); other floating
    arrays become f32. With ``key`` given and ``targets_per_step`` fewer
    than the K targets, example i keeps the targets
    ``permutation(fold_in(key, index_offset + i), K)[:targets_per_step]``
    (``index_offset``: a data-parallel rank's first row in the global
    batch), as the JAX package's ``preprocess`` does.
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
    if targets_per_step and key is not None and k_avail > targets_per_step:
        dev = out["tgt_poses"].device
        keys = jr.fold_in(key, torch.arange(index_offset, index_offset + b,
                                            device=dev))
        idx = jr.permutation(keys, k_avail)[:, :targets_per_step]  # [B, K']
        rows = torch.arange(b, device=dev)[:, None]
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


class _RankBatches:
    """The DataLoader's batch sampler: rows ``[lo, hi)`` of each of the
    order's batches, from batch ``start`` on."""

    def __init__(self, order: GrainOrder, lo: int, hi: int):
        self.order, self.lo, self.hi = order, lo, hi
        self.start = 0

    def __iter__(self):
        j = self.start
        while True:
            yield self.order.batch(j)[self.lo:self.hi]
            j += 1


class StreamIterator:
    """Batches from a DataLoader over a source in Grain's order, with a
    checkpointable position: ``get_state()`` is the state Grain's iterator
    has after the batches the consumer took (not those the workers
    prefetched), ``set_state()`` takes such a state (the JAX loop's
    ``grain_state_<step>_p<process>.json``) and restarts the workers
    there. ``writes_state``: whether this data rank writes its shard's
    state (``stream_shard``).
    ``close()`` stops the workers."""

    def __init__(self, dataset: _Examples, order: GrainOrder, rows: tuple,
                 workers: int, prefetch: int, writes_state: bool = True):
        self.dataset, self.order = dataset, order
        self.batches = _RankBatches(order, *rows)
        self.writes_state = writes_state
        self.workers, self.prefetch = workers, prefetch
        self.taken = 0
        self._it = None

    def _start(self):
        self.batches.start = self.taken
        kw = {}
        if self.workers:
            # spawn: forking a process that holds a CUDA context is unsafe
            kw = dict(prefetch_factor=self.prefetch,
                      multiprocessing_context="spawn")
        loader = torch.utils.data.DataLoader(
            self.dataset, batch_sampler=self.batches,
            num_workers=self.workers, collate_fn=stack_examples, **kw)
        return iter(loader)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if self._it is None:
            self._it = self._start()
        batch = next(self._it)
        self.taken += 1
        return batch

    def shard(self, order: GrainOrder, rows: tuple,
              writes_state: bool) -> None:
        """Stream rows ``rows`` of ``order``'s batches instead (a JAX run's
        process shard: ``stream_shard``), from its first batch; only
        before the first batch is taken."""
        if self.taken or self._it is not None:
            raise RuntimeError("a stream is sharded before its first batch")
        self.order = order
        self.batches = _RankBatches(order, *rows)
        self.writes_state = writes_state

    def get_state(self) -> dict:
        return self.order.state(self.taken)

    def set_state(self, state: dict) -> None:
        """Raises ValueError for a state of another stream (worker count,
        sampler or data source, as Grain refuses it) and for the batch
        count an earlier version of the port kept, whose order was not
        Grain's."""
        if "batches_taken" in state:
            raise ValueError(
                f"a stream state of an earlier version of the port "
                f"({state}): its record order was not Grain's, so the run "
                "cannot resume the stream exactly where it stopped")
        taken = self.order.position(state)
        self.close()
        self.taken = taken

    def close(self) -> None:
        it, self._it = self._it, None
        if it is not None and hasattr(it, "_shutdown_workers"):
            it._shutdown_workers()


def source_repr(cfg: DataConfig, size: int) -> str:
    """The ``repr`` of the JAX package's Grain data source
    (``make_grain_iterator``'s ``DMV3DSource``), which a Grain state
    holds."""
    return (f"DMV3DSource(source={cfg.source!r}, n={size}, "
            f"seed={cfg.seed}, size={cfg.image_size})")


def stream_shard(cfg: DataConfig, size: int, rank: int, world_size: int,
                 processes: int = 1) -> tuple:
    """The order and rows data rank ``rank`` of ``world_size`` streams when
    the stream is that of a JAX run of ``processes`` processes: process p
    streams Grain shard p of ``processes`` (``ShardOptions(shard_index=p,
    shard_count=processes)``) in batches of ``batch_size // processes``,
    and its batch is the contiguous block p of the global batch. Rank r
    belongs to process ``r // (world_size // processes)`` and takes its
    rows of that process's batch, so its global rows stay ``[r B /
    world_size, (r + 1) B / world_size)``. -> (``GrainOrder``, (lo, hi),
    whether the rank writes the shard's state: the first of its group).
    Raises where ``processes`` does not divide ``world_size``."""
    if cfg.batch_size % world_size:
        raise ValueError(f"batch {cfg.batch_size} not divisible by "
                         f"{world_size} processes")
    if world_size % processes:
        raise ValueError(
            f"a stream of {processes} JAX processes' Grain shards cannot be "
            f"split over {world_size} data ranks: {processes} does not "
            f"divide {world_size}")
    group = world_size // processes
    shard, j = divmod(rank, group)
    order = GrainOrder(size, cfg.batch_size // processes, cfg.seed,
                       shard_index=shard, shard_count=processes,
                       worker_count=cfg.grain_workers,
                       data_source=source_repr(cfg, size))
    local = cfg.batch_size // world_size
    return order, (j * local, (j + 1) * local), j == 0


def make_stream_iterator(cfg: DataConfig, rank: int | None = None,
                         world_size: int | None = None) -> StreamIterator:
    """Worker processes render or decode whole batches of
    ``batch_size // world_size`` examples ahead of the consumer (uint8
    images with ``device_preprocess``), in the order of the JAX package's
    Grain iterator (``GrainOrder``: ``data.seed``, ``data.grain_workers``
    workers' interleave). A JAX run on one host streams one iterator and
    splits its global batch by rows, and so does this: data rank ``r`` of
    ``N`` takes rows ``[r B / N, (r + 1) B / N)`` of each batch, and
    renders only those. (A JAX run of several processes streams a Grain
    shard each; ``StreamIterator.shard`` with ``stream_shard`` takes a
    rank's share of one.) ``rank`` and ``world_size`` are the data
    axis's (``parallel.mesh.Mesh.data_rank``, ``data_size``: the loop
    passes them, so that model peers read the same rows); by default
    ``torch.distributed``'s when it is initialised (one process per data
    rank), else 0 and 1."""
    dist = torch.distributed
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    if world_size is None:
        world_size = dist.get_world_size() if dist.is_initialized() else 1
    source = make_source(cfg)
    size = num_records(cfg, source)
    order, rows, writes = stream_shard(cfg, size, rank, world_size)
    return StreamIterator(_Examples(source, size, cfg.device_preprocess),
                          order, rows, cfg.grain_workers, cfg.prefetch,
                          writes)
