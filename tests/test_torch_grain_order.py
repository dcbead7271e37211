"""The port's copy of Grain's record order and iterator state
(dynamic_multiview_3d_torch/data/grain_order.py) against Grain itself, on
the CPU.

- ``index_shuffle`` bitwise against Grain's compiled
  ``index_shuffle_module`` on 10,530 (index, max_index, seed) triples:
  ``max_index`` on each side of every step of the cipher's block width
  (2**16, 2**18, ..., 2**40), seeds 0, 1 and 2**32 - 1; ``epoch_order``
  equal to it index by index.
- ``GrainOrder`` bitwise against a ``grain.DataLoader`` built as the JAX
  package's ``make_grain_iterator`` builds it, over a stub source whose
  item is its index, for 200 batches: 0 to 3 workers, one shard or the
  second of two, batches that straddle epochs.
- ``state()`` / ``position()`` against the loader's ``get_state()`` /
  ``set_state()`` at several points, both ways.

Grain's workers are processes; here they run in this process
(``_InProcessPool`` stands in for ``grain_pool.MultiProcessIterator``):
each worker's producer is Grain's own, on its own copy of the dataset,
read round robin from the worker after the last one read, as the pool
reads them. Real worker processes (each imports Grain anew, seconds each)
made the committed streamed JAX run, whose records and states the order
reproduces.
"""

import json
import os

import cloudpickle
import grain.python as grain
import numpy as np
import pytest
from grain._src.python import grain_pool
from grain._src.python.experimental.index_shuffle.python import \
    index_shuffle_module

from dynamic_multiview_3d_torch import config
from dynamic_multiview_3d_torch.data import grain_order, pipeline

SEEDS = (0, 1, 2 ** 32 - 1)


@pytest.mark.parametrize("seed", SEEDS)
def test_index_shuffle_is_grains_compiled_shuffle(seed):
    """3,510 triples a seed; the scalar form and the array form agree."""
    rng = np.random.default_rng(seed % 1000)
    checked = 0
    for bits in range(16, 42, 2):
        for max_index in (2 ** bits - 1, 2 ** bits, 2 ** bits + 1):
            index = rng.integers(0, max_index + 1, 90, dtype=np.int64)
            index[:2] = (0, max_index)
            want = [index_shuffle_module.index_shuffle(
                int(i), max_index=max_index, seed=seed, rounds=4)
                for i in index]
            got = grain_order.index_shuffle(index, max_index, seed)
            assert got.tolist() == want, (max_index, seed)
            assert grain_order.index_shuffle(int(index[2]), max_index,
                                             seed) == want[2]
            checked += len(index)
    assert checked == 3510
    for max_index in (0, 1, 2, 9, 511, 70_000):
        whole = grain_order.epoch_order(max_index, seed)
        assert whole.tolist() == [index_shuffle_module.index_shuffle(
            i, max_index=max_index, seed=seed, rounds=4)
            for i in range(max_index + 1)]
        assert sorted(whole.tolist()) == list(range(max_index + 1))


def test_seed_seq_and_block_width():
    """The round keys (``std::seed_seq``) and the block widths behind the
    permutation above; the worked example of ten records."""
    # std::seed_seq{s}.generate of 4 and 6 words, as libstdc++ gives them
    assert grain_order.seed_seq_generate(0, 4) == [
        2963817213, 69796629, 1973464570, 532167439]
    assert grain_order.seed_seq_generate(2 ** 32 - 1, 6) == [
        3720787203, 3907108480, 2827134131, 3608858096, 2996318809,
        2773703061]
    assert [grain_order.block_bits(m) for m in
            (1, 9, 2 ** 16 - 1, 2 ** 16, 2 ** 16 + 1, 2 ** 17 + 1)] == [
        16, 16, 16, 16, 18, 18]
    assert grain_order.epoch_order(9, 0).tolist() == [
        0, 4, 6, 7, 8, 3, 1, 9, 5, 2]
    with pytest.raises(ValueError, match="rounds"):
        grain_order.index_shuffle(3, 9, 0, rounds=3)


class _Stub(grain.RandomAccessDataSource):
    """Item i is i: the order, with nothing rendered."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, index):
        return np.int64(index)

    def __repr__(self):
        return f"Stub(n={self.n})"


class _InProcessPool:
    """``grain_pool.MultiProcessIterator`` with Grain's per-worker producers
    run in this process."""

    def __init__(self, get_element_producer_fn, multiprocessing_options,
                 worker_index_to_start_reading, *args, **kwargs):
        w = multiprocessing_options.num_workers
        payload = get_element_producer_fn.serialize()
        self._producers = [cloudpickle.loads(payload)(
            worker_index=i, worker_count=w) for i in range(w)]
        self._last = worker_index_to_start_reading - 1

    def start_prefetch(self):
        pass

    def stop_prefetch(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def __iter__(self):
        return self

    def __next__(self):
        self._last = (self._last + 1) % len(self._producers)
        return next(self._producers[self._last])

    def get_last_worker_index(self):
        return self._last


@pytest.fixture()
def in_process(monkeypatch):
    monkeypatch.setattr(grain_pool, "MultiProcessIterator", _InProcessPool)


def _loader(n, batch, seed, shard, workers):
    """The JAX package's ``make_grain_iterator`` loader over ``_Stub(n)``."""
    sampler = grain.IndexSampler(
        num_records=n,
        shard_options=grain.ShardOptions(shard_index=shard[0],
                                         shard_count=shard[1],
                                         drop_remainder=True),
        shuffle=True, num_epochs=None, seed=seed)
    return grain.DataLoader(
        data_source=_Stub(n), sampler=sampler,
        operations=[grain.Batch(batch, drop_remainder=True)],
        worker_count=workers,
        read_options=grain.ReadOptions(prefetch_buffer_size=2))


def _order(n, batch, seed, shard, workers):
    return grain_order.GrainOrder(n, batch, seed, shard_index=shard[0],
                                  shard_count=shard[1], worker_count=workers,
                                  data_source=repr(_Stub(n)))


def _take(it, count):
    return [np.asarray(next(it)).tolist() for _ in range(count)]


@pytest.mark.parametrize("workers,shard", [
    (0, (0, 1)), (1, (1, 2)), (2, (1, 2)), (3, (0, 1))],
    ids=["0-1-shard", "1-2nd-of-2", "2-2nd-of-2", "3-1-shard"])
def test_order_and_state_are_grains(in_process, workers, shard):
    """97 records (48 a shard of two), batches of 5, seed 7: 200 batches
    bitwise; the state after 0, 1, 6, 37 and 200 batches equal to the
    loader's and the order's position of it; the loader restored from the
    order's state after 0, 37 and 200 goes on with the order's batches."""
    n, batch, seed = 97, 5, 7
    order = _order(n, batch, seed, shard, workers)
    it = iter(_loader(n, batch, seed, shard, workers))
    states = {0: it.get_state()}
    got = []
    for j in (1, 6, 37, 200):
        got += _take(it, j - len(got))
        states[j] = it.get_state()
    assert got == [order.batch(j) for j in range(200)]
    assert sum(len(set(order.positions(j) // order.length)) > 1
               for j in range(200)) >= 8          # batches across epochs
    for j, raw in states.items():
        state = json.loads(raw)
        assert order.state(j) == state, j
        assert order.position(state) == j
        assert json.dumps(order.state(j), indent=4).encode() == raw
        if j not in (0, 37, 200):
            continue
        again = iter(_loader(n, batch, seed, shard, workers))
        again.set_state(json.dumps(order.state(j)).encode())
        assert _take(again, 3) == [order.batch(j + k) for k in range(3)]


def test_a_batch_straddles_epochs_and_repeats_a_record():
    """Ten records in batches of three (the worked example): batch 3 takes
    the last record of epoch 0 and two of epoch 1; with two workers batch
    2 holds record 5 twice."""
    one = grain_order.GrainOrder(10, 3, 0)
    assert [one.batch(j) for j in range(5)] == [
        [0, 4, 6], [7, 8, 3], [1, 9, 5], [2, 5, 7], [6, 0, 4]]
    two = grain_order.GrainOrder(10, 3, 0, worker_count=2)
    assert [two.batch(j) for j in range(5)] == [
        [0, 6, 8], [4, 7, 3], [1, 5, 5], [9, 2, 7], [6, 4, 9]]


def test_position_refuses_another_loaders_state():
    """Another worker count, sampler or data source is refused with both
    values named (Grain's ``_validate_state``); a state that is no
    position of the order too."""
    order = _order(97, 5, 7, (0, 1), 2)
    state = order.state(9)
    for key, value, match in (
            ("worker_count", 3, "worker_count.*3 in the state, 2 here"),
            ("sampler", _order(97, 5, 8, (0, 1), 2).sampler,
             "sampler.*seed=8.*seed=7"),
            ("data_source", "Stub(n=96)", "data_source.*n=96.*n=97")):
        with pytest.raises(ValueError, match=match):
            order.position(dict(state, **{key: value}))
    torn = dict(state, last_seen_indices={"0": 3, "1": 1})
    with pytest.raises(ValueError, match="no position of this order"):
        order.position(torn)


def test_the_streamed_fixture_is_this_order():
    """The committed streamed JAX run (tests/torch_goldens/jax_orbax/
    c2_stream_run, made by Grain's real worker processes, 2 of them): its
    Grain state after step 2 is position 2 of the order, the order's
    batches are the records the run took, and its state after step 4 is
    the run's. No worker process here."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_goldens", "jax_orbax")
    run = os.path.join(root, "c2_stream_run")
    with open(os.path.join(run, "train_config.json")) as f:
        data = config.from_dict(json.load(f)).data
    with open(os.path.join(run, "grain_state_2_p0.json")) as f:
        state = json.load(f)
    expected = np.load(os.path.join(root, "expected.npz"))
    size = pipeline.num_records(data, pipeline.make_source(data))
    order = grain_order.GrainOrder(
        size, data.batch_size, data.seed, worker_count=data.grain_workers,
        data_source=pipeline.source_repr(data, size))
    assert (size, data.batch_size, data.grain_workers) == (5, 2, 2)
    assert order.position(state) == 2
    assert [order.batch(j) for j in range(4)] == \
        expected["c2_stream_run/records"].tolist()
    assert order.state(4) == json.loads(
        str(expected["c2_stream_run/grain_state_4"]))
