"""The port's stream iterator (data/pipeline.py ``make_stream_iterator``,
the counterpart of the JAX package's Grain iterator) and the training
loop's streaming branch, on the CPU.

Batch j of the stream is the JAX package's Grain iterator's batch j
(``make_grain_iterator``: Grain's per-epoch shuffle and its workers'
interleave, data/grain_order.py, held to Grain in
tests/test_torch_grain_order.py), bitwise, and the stream's state is that
iterator's state; a data rank takes its rows of it. Each batch equals the
source's ``batch`` of its record indices (the source's examples are held
to the JAX package's in tests/test_torch_sources.py). Worker processes
(spawned) give those batches, and the state restores the stream exactly;
so a streamed run killed and resumed ends bitwise equal to an
uninterrupted one.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from grain._src.python import grain_pool
from test_torch_grain_order import _InProcessPool

from dynamic_multiview_3d_torch import config as tconfig
from dynamic_multiview_3d_torch.data import frames as tframes
from dynamic_multiview_3d_torch.data import pipeline as tpipeline
from dynamic_multiview_3d_torch.data.grain_order import GrainOrder
from dynamic_multiview_3d_torch.train import loop as tloop
from dynamic_multiview_3d_tpu import config as jconfig
from dynamic_multiview_3d_tpu.data import pipeline as jpipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["model.image_size=32", "model.num_levels=3", "model.base_features=8",
        "model.max_features=16", "model.gru_features=16",
        "model.pose_embed_dim=8", "model.dtype=float32",
        "data.image_size=32", "data.batch_size=4", "data.num_scenes=6",
        "data.streaming=true", "data.grain_workers=0", "train.lr=1e-3",
        "train.num_steps=4", "train.log_every=2", "train.ckpt_every=2"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tiny models: the suite runs
    several worker processes on a few cores, and torch's default of a
    thread per core each makes them wait on one another's threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stream(cfg, workers, rows):
    """The port's stream of ``cfg`` in Grain's order at ``workers`` Grain
    workers, rows ``rows`` of each batch, rendered in this process."""
    src = tpipeline.make_source(cfg)
    size = tpipeline.num_records(cfg, src)
    order = GrainOrder(size, cfg.batch_size, cfg.seed, worker_count=workers,
                       data_source=tpipeline.source_repr(cfg, size))
    return tpipeline.StreamIterator(tpipeline._Examples(src, size, True),
                                    order, rows, 0, 2)


def test_stream_order_is_a_pure_function_sharded_by_rank(monkeypatch):
    """The port's stream and the JAX package's Grain iterator on one
    config (6 records in batches of 4: batches straddle epochs), at 0 and
    2 Grain workers: 5 batches bitwise and the state after each equal;
    data rank r of 2 takes rows [2r, 2r + 2) of each; the order is a
    function of the seed and the worker count. Grain's workers run in this
    process (tests/test_torch_grain_order.py ``_InProcessPool``)."""
    monkeypatch.setattr(grain_pool, "MultiProcessIterator", _InProcessPool)
    for workers in (0, 2):
        _same_as_grain(workers)


def _same_as_grain(workers):
    sets = TINY + [f"data.grain_workers={workers}"]
    cfg = tconfig.get_config("default", sets).data
    jit = jpipeline.make_grain_iterator(
        jconfig.get_config("default", sets).data, num_epochs=None)
    ours = _stream(cfg, workers, (0, 4))
    ranks = [_stream(cfg, workers, (2 * r, 2 * r + 2)) for r in range(2)]
    for _ in range(5):
        want, got = next(jit), next(ours)
        halves = [next(r) for r in ranks]
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            np.testing.assert_array_equal(
                np.concatenate([h[k] for h in halves]), want[k])
        assert ours.get_state() == json.loads(jit.get_state())
        assert ranks[1].get_state() == ours.get_state()
    straddle = [ours.order.batch(j) for j in range(5)]
    assert straddle == [GrainOrder(6, 4, 0, worker_count=workers).batch(j)
                        for j in range(5)]
    assert any(len(set(b)) < 4 for b in straddle)
    assert straddle[0] != GrainOrder(6, 4, 1, worker_count=workers).batch(0)


def test_stream_in_process_matches_source_batches_and_restores():
    cfg = tconfig.get_config("default", TINY).data
    stream = tpipeline.make_stream_iterator(cfg)
    src = tpipeline.make_source(cfg)
    size = tpipeline.num_records(cfg, src)
    order = GrainOrder(size, 4, 0, data_source=tpipeline.source_repr(
        cfg, size))
    got = [next(stream) for _ in range(3)]
    for b, batch in enumerate(got):
        want = src.batch(order.batch(b), raw=True)
        for k in want:
            np.testing.assert_array_equal(batch[k], want[k])
    state = stream.get_state()
    assert state == order.state(3) and json.loads(json.dumps(state)) \
        == state
    nxt = next(stream)
    fresh = tpipeline.make_stream_iterator(cfg)
    fresh.set_state(state)
    again = next(fresh)
    for k in nxt:
        np.testing.assert_array_equal(nxt[k], again[k])
    other = tpipeline.make_stream_iterator(
        tconfig.get_config("default", TINY + ["data.seed=1"]).data)
    with pytest.raises(ValueError, match="sampler does not match"):
        other.set_state(state)
    with pytest.raises(ValueError, match="earlier version of the port"):
        fresh.set_state({"batches_taken": 3, "seed": 0})


def test_stream_rank_and_world_size():
    """Rank r of 2 renders rows [2r, 2r + 2) of the one-process batch."""
    cfg = tconfig.get_config("default", TINY).data
    assert not torch.distributed.is_initialized()
    stream = tpipeline.make_stream_iterator(cfg)
    assert (stream.batches.lo, stream.batches.hi) == (0, 4)
    whole = next(stream)
    halves = [tpipeline.make_stream_iterator(cfg, rank=r, world_size=2)
              for r in range(2)]
    batches = [next(h) for h in halves]
    assert all(b["image_seq"].shape[0] == 2 for b in batches)
    for k in whole:
        np.testing.assert_array_equal(
            np.concatenate([b[k] for b in batches]), whole[k])
    assert halves[1].get_state() == stream.get_state()
    with pytest.raises(ValueError, match="divisible"):
        tpipeline.make_stream_iterator(cfg, world_size=3)


WORKERS = """
import json, sys
import numpy as np
from dynamic_multiview_3d_torch import config
from dynamic_multiview_3d_torch.data import pipeline, tfrecords

root = sys.argv[1]
tfrecords.export_tfrecords(root, num_scenes=3, image_size=32, num_views=4,
                           seq_len=2, shards=2)
sets = ["data.source=tfrecords", f"data.root={root}", "data.image_size=32",
        "data.seq_len=2", "data.num_targets=2", "data.batch_size=4"]
def stream(workers):
    return pipeline.make_stream_iterator(config.get_config(
        "default", sets + [f"data.grain_workers={workers}"]).data)
source = pipeline.make_source(config.get_config("default", sets).data)
spawned = stream(2)
want = [source.batch(spawned.order.batch(j), raw=True) for j in range(4)]
got = [next(spawned) for _ in range(2)]
state = spawned.get_state()
spawned.close()
resumed = stream(2)
resumed.set_state(state)
got += [next(resumed) for _ in range(2)]
resumed.close()
same = [all(np.array_equal(g[k], w[k]) for k in w) for g, w in zip(got, want)]
print(json.dumps({"same": same, "state": state,
                  "want": spawned.order.state(2)}))
"""


def test_stream_workers_match_in_process(tmp_path):
    """Two spawned workers (a tfrecords source: its memory maps reopen in
    each worker) give the source's batches of the order's record indices
    (Grain's order at two workers), and the state taken after two batches,
    Grain's, restarts new workers at the third. In a subprocess with a
    time limit of its own."""
    run = subprocess.run(
        [sys.executable, "-c", WORKERS, str(tmp_path / "tfr")], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-3000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert out["same"] == [True] * 4
    assert out["state"] == out["want"]
    assert out["state"]["worker_count"] == 2
    assert out["state"]["last_worker_index"] == 1


def _same_state(a, b):
    assert a.step == b.step
    for (n, p), q in zip(a.module.named_parameters(), b.module.parameters()):
        assert torch.equal(p, q), n
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[k], sb[k]), (n, k)


@pytest.mark.parametrize("spd", [1, 2])
def test_streaming_loop_resumes_exactly(tmp_path, spd):
    """A streamed run killed after its first dispatch and resumed ends
    bitwise equal to an uninterrupted one; the stream's state, Grain's,
    lies beside each manager step under the JAX loop's name."""
    extra = [f"train.steps_per_dispatch={spd}"]

    def cfg(name, *more):
        return tconfig.get_config("default", TINY + extra + [
            f"train.ckpt_dir={tmp_path / name}", *more])
    straight, _ = tloop.train(cfg("a"), device="cpu")
    with pytest.raises(tloop.FaultInjected):
        tloop.train(cfg("b", f"train.fail_after_step={spd - 1}"),
                    device="cpu")
    with open(tmp_path / "b" / f"grain_state_{spd}_p0.json") as f:
        assert json.load(f) == tpipeline.make_stream_iterator(
            cfg("b").data).order.state(spd)
    resumed, _ = tloop.train(cfg("b"), device="cpu")
    _same_state(straight, resumed)
    for step in (2, 4) if spd == 2 else (1, 2, 4):
        assert os.path.exists(tmp_path / "a" / f"grain_state_{step}_p0.json")
    assert not [f for f in os.listdir(tmp_path / "a")
                if f.startswith("stream_state")]


def test_streaming_takes_the_stream_in_order(tmp_path):
    """Two steps a dispatch take the stream's batches as two dispatches of
    one step do; a resume without the stream's state refuses to guess."""
    runs = {}
    for spd in (1, 2):
        runs[spd], _ = tloop.train(tconfig.get_config("default", TINY + [
            f"train.steps_per_dispatch={spd}",
            f"train.ckpt_dir={tmp_path / str(spd)}"]), device="cpu")
    _same_state(runs[1], runs[2])
    os.remove(tmp_path / "1" / "grain_state_4_p0.json")
    with pytest.raises(FileNotFoundError, match="stream state"):
        tloop.train(tconfig.get_config("default", TINY + [
            "train.num_steps=6", f"train.ckpt_dir={tmp_path / '1'}"]),
            device="cpu")


def test_streamed_source_pickles_without_caches(tmp_path):
    """What a worker receives: no memory-mapped banks, no metadata."""
    import pickle
    root = tframes.export_synthetic(str(tmp_path / "p"), num_scenes=2,
                                    image_size=32, num_views=3, seq_len=2,
                                    fmt="packed")
    src = tframes.FrameFolderScenes(tconfig.DataConfig(
        source="frames", root=root, image_size=32, seq_len=2))
    want = src.batch(range(3), raw=True)
    assert src._pack_cache and src._meta_cache
    copy = pickle.loads(pickle.dumps(src))
    assert not copy._pack_cache and not copy._meta_cache
    got = copy.batch(range(3), raw=True)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
