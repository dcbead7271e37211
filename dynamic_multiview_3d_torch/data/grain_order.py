"""Grain's record order and iterator state, in numpy, with no Grain.

The JAX package streams its training batches through a ``grain.DataLoader``
(its ``data/pipeline.py`` ``make_grain_iterator``): an ``IndexSampler``
with ``shuffle=True`` over ``ShardOptions(drop_remainder=True)``, a
``Batch`` operation and ``worker_count`` worker processes. This module
gives the same record indices, batch for batch, and reads and writes the
same iterator state, so that a streamed run moves between the two packages
where it stopped. The contract, in Grain 0.2's sources:

- the shard (``grain/_src/core/sharding.py`` ``even_split``): process
  ``shard_index`` of ``shard_count`` takes the contiguous records
  ``[start, start + L)``, ``L = num_records // shard_count``;
- the shuffle (``grain/_src/python/dataset/transformations/shuffle.py``
  ``ShuffleMapDataset``): position ``p`` of the process's endless stream
  is record ``start + index_shuffle(p % L, L - 1, (seed + p // L) mod
  2**32, rounds=4)``, a new permutation each epoch, so a batch may
  straddle two epochs and hold a record twice;
- the workers (``grain/_src/python/dataset/transformations/prefetch.py``
  ``MultiprocessPrefetchIterDataset``): worker ``i`` of ``w`` takes the
  positions ``i, i + w, i + 2w, ...`` and batches them itself; the
  consumer takes the workers' batches round robin, so batch ``j`` is
  worker ``j % w``'s batch ``j // w``. ``w = 0`` (no worker process) and
  ``w = 1`` batch the one stream in order;
- the state (``grain/_src/python/data_loader.py``
  ``_DataLoaderStateDatasetIterator`` and ``DataLoader._validate_state``):
  JSON with the last position each worker took, the last worker the
  consumer read from, the worker count and the ``repr`` of the sampler and
  of the data source; a state whose worker count, sampler or data source
  is not the loader's is refused.

``index_shuffle`` is the permutation of Grain's compiled
``index_shuffle_module`` (``grain/_src/python/experimental/index_shuffle``),
not its pure-Python ``index_shuffle_python``, which gives another one: a
Simon block cipher over an even number of bits, at least 16, whose round
keys are ``std::seed_seq{seed}.generate`` of ``rounds`` 32-bit words,
cycle-walked into ``[0, max_index]``.
"""

from __future__ import annotations

import math

import numpy as np

STATE_VERSION = 2           # Grain's _CHECKPOINT_VERSION_NUMBER
MIN_BLOCK_BITS = 16         # Grain's kMinBlockSize
EPOCH_TABLE_BITS = 20       # GrainOrder: whole epochs up to this block
_U32 = 0xFFFFFFFF


def seed_seq_generate(seed: int, n: int) -> list[int]:
    """``std::seed_seq{seed}.generate`` of ``n`` 32-bit words (the C++
    standard's [rand.util.seedseq] algorithm, one seed word)."""
    v = [seed & _U32]
    s = len(v)
    out = [0x8B8B8B8B] * n
    if n == 0:
        return out
    t = (11 if n >= 623 else 7 if n >= 68 else 5 if n >= 39
         else 3 if n >= 7 else (n - 1) // 2)
    p = (n - t) // 2
    q = p + t
    m = max(s + 1, n)

    def mix(x):
        return x ^ (x >> 27)
    for k in range(m):
        r1 = (1664525 * mix(out[k % n] ^ out[(k + p) % n]
                            ^ out[(k - 1) % n])) & _U32
        if k == 0:
            r2 = r1 + s
        elif k <= s:
            r2 = r1 + k % n + v[k - 1]
        else:
            r2 = r1 + k % n
        r2 &= _U32
        out[(k + p) % n] = (out[(k + p) % n] + r1) & _U32
        out[(k + q) % n] = (out[(k + q) % n] + r2) & _U32
        out[k % n] = r2
    for k in range(m, m + n):
        r3 = (1566083941 * mix((out[k % n] + out[(k + p) % n]
                                + out[(k - 1) % n]) & _U32)) & _U32
        r4 = (r3 - k % n) & _U32
        out[(k + p) % n] ^= r3
        out[(k + q) % n] ^= r4
        out[k % n] = r4
    return out


def block_bits(max_index: int) -> int:
    """The cipher's block width for ``[0, max_index]``: ``ceil(log2(
    max_index))`` in doubles, rounded up to even, at least 16."""
    bits = math.ceil(math.log2(float(max_index)))
    bits += bits % 2
    return max(bits, MIN_BLOCK_BITS)


def _simon(x: np.ndarray, keys: list[int], half: int) -> np.ndarray:
    """One Simon encryption of the ``2 * half``-bit blocks ``x`` (unsigned;
    bits above the block are dropped), two Feistel rounds a key pair."""
    dt = x.dtype.type
    mask = dt((1 << half) - 1)

    def f(v):
        def rotl(r):
            return ((v >> dt(half - r)) | (v << dt(r))) & mask
        return (rotl(1) & rotl(8)) ^ rotl(2)
    left, right = (x >> dt(half)) & mask, x & mask
    for i in range(0, len(keys), 2):
        left ^= f(right) ^ dt(keys[i] & int(mask))
        right ^= f(left) ^ dt(keys[i + 1] & int(mask))
    return (left << dt(half)) | right


def _cipher(max_index: int, seed: int, rounds: int) -> tuple:
    """(round keys, half width, the unsigned type that holds a block)."""
    if rounds < 4 or rounds % 2:
        raise ValueError(f"rounds must be even and at least 4: {rounds}")
    half = block_bits(max_index) // 2
    return (seed_seq_generate(seed, rounds), half,
            np.uint32 if half <= 16 else np.uint64)


def index_shuffle(index, max_index: int, seed: int, rounds: int = 4):
    """The position of ``index`` in Grain's permutation of ``[0,
    max_index]`` under ``seed``: an int for an int, an int64 array for an
    array of indices (one cipher pass over all of them, then again over
    those that fell past ``max_index``)."""
    scalar = np.ndim(index) == 0
    if max_index == 0:
        x = np.zeros(np.shape(index), np.int64)
    else:
        keys, half, dt = _cipher(max_index, seed, rounds)
        x = _simon(np.array(index, dtype=np.uint64, ndmin=1).astype(dt),
                   keys, half)
        while (past := x > max_index).any():
            x[past] = _simon(x[past], keys, half)
    return int(x.reshape(-1)[0]) if scalar else x.astype(np.int64)


def epoch_order(max_index: int, seed: int, rounds: int = 4) -> np.ndarray:
    """``index_shuffle(i, max_index, seed)`` for every ``i`` in ``[0,
    max_index]``: the cipher over its whole block once, then the cycle
    walk as lookups in that table. A block is at least 2**16 wide, so for
    a few hundred records this is far cheaper than walking each index
    through the cipher (about 128 encryptions an index at 512 records)."""
    if max_index == 0:
        return np.zeros(1, np.int64)
    keys, half, dt = _cipher(max_index, seed, rounds)
    table = _simon(np.arange(1 << 2 * half, dtype=dt), keys,
                   half).astype(np.intp)
    out = table[:max_index + 1].copy()
    todo = np.flatnonzero(out > max_index)
    while todo.size:
        out[todo] = table[out[todo]]
        todo = todo[out[todo] > max_index]
    return out.astype(np.int64)


def sampler_repr(num_records: int, seed: int, shard_index: int = 0,
                 shard_count: int = 1) -> str:
    """``repr`` of the JAX package's ``grain.IndexSampler``, which Grain
    checks on restore."""
    return (f"IndexSampler(num_records={num_records}, shard_options="
            f"ShardOptions(shard_index={shard_index}, shard_count="
            f"{shard_count}, drop_remainder=True), shuffle=True, "
            f"num_epochs=None, seed={seed})")


class GrainOrder:
    """The record indices of the batches a ``grain.DataLoader`` yields
    (``IndexSampler(num_records, ShardOptions(shard_index, shard_count,
    drop_remainder=True), shuffle=True, num_epochs=None, seed)``, a
    ``Batch(local_batch, drop_remainder=True)``, ``worker_count`` workers)
    and its iterator state after a number of batches.

    ``data_source`` is the ``repr`` of the loader's data source, written
    into the state and checked on restore."""

    def __init__(self, num_records: int, local_batch: int, seed: int,
                 shard_index: int = 0, shard_count: int = 1,
                 worker_count: int = 0, data_source: str = ""):
        if not 0 <= seed < 2 ** 32:
            raise ValueError(f"Grain's seed is a 32-bit integer: {seed}")
        self.length = num_records // shard_count        # even_split
        if self.length == 0:
            raise ValueError(f"{num_records} records in {shard_count} "
                             "shards leave a shard empty")
        self.start = self.length * shard_index
        self.num_records, self.local_batch, self.seed = (
            num_records, local_batch, seed)
        self.shard_index, self.shard_count = shard_index, shard_count
        self.worker_count = worker_count
        self.sampler = sampler_repr(num_records, seed, shard_index,
                                    shard_count)
        self.data_source = data_source
        self._epochs = {}       # epoch -> its order, for small blocks

    def positions(self, j: int) -> np.ndarray:
        """The stream positions of batch ``j``: worker ``j % w``'s batch
        ``j // w``."""
        w = max(self.worker_count, 1)
        k = (j // w) * self.local_batch + np.arange(self.local_batch)
        return j % w + k * w

    def records(self, positions: np.ndarray) -> np.ndarray:
        """The record at each stream position. Where the cipher's block is
        at most 2**EPOCH_TABLE_BITS wide, each epoch's whole order is
        computed once (``epoch_order``) and the last few are kept; past
        that, the positions go through ``index_shuffle``."""
        epoch, within = np.divmod(np.asarray(positions, np.int64),
                                  self.length)
        out = np.empty_like(within)
        whole = block_bits(max(self.length - 1, 1)) <= EPOCH_TABLE_BITS
        for e in np.unique(epoch).tolist():
            at = epoch == e
            seed = (self.seed + e) % 2 ** 32
            if not whole:
                out[at] = index_shuffle(within[at], self.length - 1, seed)
                continue
            if e not in self._epochs:
                self._epochs = {k: v for k, v in self._epochs.items()
                                if k > e - 4}
                self._epochs[e] = epoch_order(self.length - 1, seed)
            out[at] = self._epochs[e][within[at]]
        return self.start + out

    def batch(self, j: int) -> list[int]:
        """The record indices of batch ``j`` (0 the first)."""
        return self.records(self.positions(j)).tolist()

    def _taken(self, batches: int) -> list[int]:
        """How many batches each worker has made after ``batches``."""
        w = max(self.worker_count, 1)
        return [max(0, -(-(batches - i) // w)) for i in range(w)]

    def state(self, batches: int) -> dict:
        """Grain's iterator state after the consumer took ``batches``
        batches (``DataLoaderIterator.get_state``, JSON-decoded)."""
        w, sc = max(self.worker_count, 1), self.shard_count
        last = {str(i): self.shard_index + i * sc
                + (n * self.local_batch - 1) * w * sc
                for i, n in enumerate(self._taken(batches))}
        worker = -1 if batches == 0 or self.worker_count == 0 \
            else (batches - 1) % w
        return {"version": STATE_VERSION, "last_seen_indices": last,
                "last_worker_index": worker,
                "worker_count": self.worker_count,
                "sampler": self.sampler, "data_source": self.data_source}

    def position(self, state: dict) -> int:
        """The number of batches taken at Grain's iterator ``state``. Raises
        ValueError where the state is another loader's (worker count,
        sampler or data source: both named, as Grain's ``_validate_state``
        does) or not a position of this order."""
        for key, mine in (("worker_count", self.worker_count),
                          ("sampler", self.sampler),
                          ("data_source", self.data_source)):
            if state.get(key) != mine:
                raise ValueError(
                    f"the Grain state's {key} does not match this stream's: "
                    f"{state.get(key)!r} in the state, {mine!r} here")
        w, sc = max(self.worker_count, 1), self.shard_count
        try:
            last = state["last_seen_indices"]
            made = [(int(last[str(i)]) + w * sc - self.shard_index - i * sc)
                    // (w * sc) for i in range(w)]
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"not a Grain iterator state: {e!r}") from e
        batches = sum(m // self.local_batch for m in made)
        if self.state(batches) != dict(state):
            raise ValueError(
                f"the Grain state is no position of this order: {state}, "
                f"nearest {self.state(batches)}")
        return batches
