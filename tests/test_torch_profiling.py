"""The program's spans (utils/profiling.py): off outside a profiler, on
inside one (host and device, or the device alone), on the profiler's
clock, flat in ``Model.predict`` and in the train step, one unit a call,
bounded, and absent from an exported program.

No JAX here: the card runs this file's ``cuda`` test with ``-m cuda``.
"""

import contextlib
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dynamic_multiview_3d_torch import config as tconfig
from dynamic_multiview_3d_torch import serving
from dynamic_multiview_3d_torch.api import Model
from dynamic_multiview_3d_torch.data.synthetic import SyntheticScenes
from dynamic_multiview_3d_torch.train import step as tstep
from dynamic_multiview_3d_torch.utils import profiling

TINY = ["model.image_size=32", "model.num_levels=3", "model.base_features=8",
        "model.max_features=16", "model.gru_features=16",
        "model.pose_embed_dim=8", "model.dtype=float32",
        "data.image_size=32", "data.batch_size=2", "data.num_targets=2",
        "train.lr=1e-3"]
MODEL = ["dmv3d.encode", "dmv3d.decode", "dmv3d.synthesis"]
SUB_STEP = (["dmv3d.train.inputs", "dmv3d.train.optimizer"] + MODEL
            + ["dmv3d.train.loss", "dmv3d.train.backward",
               "dmv3d.train.optimizer"])


def _cfg(*extra):
    return tconfig.get_config("default", TINY + list(extra))


def _session(activities=(ProfilerActivity.CPU,)):
    return profile(activities=list(activities))


def _last():
    return profiling.recordings()[-1]


def _check_flat(rec, per_unit: list[str], units: int):
    """Every span of ``rec`` lies in one of its ``units`` units, in the
    order ``per_unit`` names, none inside another."""
    assert len(rec.units) == units and rec.dropped == 0
    ids = [u.unit for u in rec.units]
    assert len(set(ids)) == units
    assert [s.name for s in rec.spans] == per_unit * units
    assert [s.unit for s in rec.spans] == \
        [i for i in ids for _ in per_unit]
    assert all(s.parent is None for s in rec.spans)
    for u in rec.units:
        mine = [s for s in rec.spans if s.unit == u.unit]
        assert u.start_ns <= mine[0].start_ns
        assert mine[-1].end_ns <= u.end_ns
        for a, b in zip(mine, mine[1:]):
            assert a.start_ns <= a.end_ns <= b.start_ns


def test_off_outside_a_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name) or real(name))
    before = len(profiling.recordings())
    with profiling.unit():
        with profiling.span("dmv3d.test"):
            pass
    model = Model.init_random(_cfg(), device="cpu")
    model.predict(np.zeros((1, 32, 32, 3), np.float32),
                  np.zeros((2, 3), np.float32))
    assert entered == []
    assert len(profiling.recordings()) == before


def test_span_lies_inside_its_profiler_event():
    with _session():                       # the first ranges' set-up
        with profiling.span("dmv3d.warm"):
            pass
    with _session() as prof:
        for i in range(3):
            with profiling.span(f"dmv3d.test{i}"):
                torch.ones(64, 64).sum()
    rec = _last()
    assert [s.name for s in rec.spans] == [f"dmv3d.test{i}"
                                           for i in range(3)]
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("dmv3d.test")}
    for s in rec.spans:
        ev = events[s.name]
        lo, hi = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        assert lo <= s.start_ns <= s.end_ns <= hi
        assert s.start_ns - lo < 1_000_000 and hi - s.end_ns < 1_000_000


def test_each_session_is_one_recording():
    before = len(profiling.recordings())
    for n in (1, 2):
        with _session():
            for _ in range(n):
                with profiling.span("dmv3d.test"):
                    pass
    with _session():
        pass
    recs = profiling.recordings()[before:]
    assert [len(r.spans) for r in recs] == [1, 2, 0]


@pytest.mark.parametrize("synthesis", ["flow", "multidepth"])
def test_predict_records_its_flat_phases(synthesis):
    extra = ["model.synthesis=multidepth", "data.seq_len=2"] \
        if synthesis == "multidepth" else []
    model = Model.init_random(_cfg(*extra), device="cpu")
    t = model.cfg.data.seq_len
    rng = np.random.default_rng(0)
    args = (rng.uniform(-1, 1, (2, t, 32, 32, 3)).astype(np.float32),
            rng.uniform(0, 1, (2, 2, 3)).astype(np.float32))
    kw = {"source_poses": rng.uniform(0, 1, (2, t, 3)).astype(np.float32)}
    with _session():
        for _ in range(2):
            model.predict(*args, **kw)
    _check_flat(_last(), ["dmv3d.predict.inputs"] + MODEL, 2)


@pytest.mark.parametrize("spd", [1, 2])
def test_train_step_records_its_flat_phases(spd):
    cfg = _cfg("data.seq_len=2", f"train.steps_per_dispatch={spd}")
    src = SyntheticScenes(num_scenes=2, image_size=32, seq_len=2,
                          num_targets=2)
    batches = [src.batch(range(2 * i, 2 * i + 2), raw=True)
               for i in range(spd)]
    batch = batches[0] if spd == 1 else \
        {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    state = tstep.init_state(cfg, seed=0, device="cpu")
    step = tstep.make_train_step(cfg, device="cpu")
    with _session():
        for _ in range(2):
            state, _ = step(state, batch)
    per_unit = (["dmv3d.train.inputs"] if spd > 1 else []) \
        + SUB_STEP * spd + ["dmv3d.train.sync"]
    _check_flat(_last(), per_unit, 2)


def test_a_span_on_another_thread_has_no_unit(monkeypatch):
    # the profiler covers the threads that inherit its state, autograd's
    # among them; a plain thread stands in for one here
    monkeypatch.setattr(profiling, "_profiler_enabled", lambda: True)

    def other():
        with profiling.span("dmv3d.other"):
            pass
    with _session():
        with profiling.unit():
            with profiling.span("dmv3d.outer"):
                worker = threading.Thread(target=other)
                worker.start()
                worker.join(timeout=30)
                assert not worker.is_alive()
                with profiling.span("dmv3d.inner"):
                    pass
    spans = {s.name: s for s in _last().spans}
    assert spans["dmv3d.other"].unit is None
    assert spans["dmv3d.other"].parent is None
    assert spans["dmv3d.other"].thread != spans["dmv3d.outer"].thread
    assert spans["dmv3d.outer"].unit == _last().units[0].unit
    assert spans["dmv3d.inner"].unit == spans["dmv3d.outer"].unit
    assert _last().spans[spans["dmv3d.inner"].parent] == spans["dmv3d.outer"]


def test_a_nested_unit_joins_the_outer_one():
    with _session():
        with profiling.unit():
            with profiling.unit():
                with profiling.span("dmv3d.test"):
                    pass
    rec = _last()
    assert len(rec.units) == 1
    assert rec.spans[0].unit == rec.units[0].unit


def test_a_recording_drops_spans_past_its_bound(monkeypatch):
    monkeypatch.setattr(profiling, "LIMIT", 5)
    with _session():
        for _ in range(3):
            with profiling.unit():
                for _ in range(3):
                    with profiling.span("dmv3d.test"):
                        pass
    rec = _last()
    assert len(rec.spans) == 5 and len(rec.units) == 3
    assert rec.dropped == 4
    assert all(s.end_ns is not None for s in rec.spans)


def test_an_export_under_a_profiler_holds_no_profiler_node():
    model = Model.init_random(_cfg(), device="cpu")
    with _session():
        programs, _ = serving.trace_predict(model, batch=2)
    assert _last().spans == []
    for program in programs.values():
        targets = [str(n.target) for n in program.graph.nodes]
        assert not [t for t in targets if "profiler" in t]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: it reads the card's kernels")
    return torch.device("cuda")


# A device-only session in a fresh interpreter: once a process holds
# CUDA graphs (tests/test_torch_step_graph.py's, when both files run in
# one pytest process), torch 2.11's profiler with CUDA 12.8 loses the
# kernel records of most later sessions (CUPTI torn down at each
# session's end and set up again), whatever this module's own code does.
_DEVICE_ONLY = """
import json
import torch
from torch.profiler import ProfilerActivity, profile
from dynamic_multiview_3d_torch.utils import profiling
x = torch.randn(2048, 2048, device="cuda")
x @ x
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    with profiling.unit():
        for i in range(3):
            with profiling.span(f"dmv3d.test{i}"):
                x @ x
            torch.cuda.synchronize()
rec = profiling.recordings()[-1]
print(json.dumps({
    "units": [u.end_ns for u in rec.units],
    "spans": [[s.name, s.start_ns] for s in rec.spans],
    "kernels": [e.start_ns() for e in prof.profiler.kineto_results.events()
                if e.device_type() == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation()]}))
"""


@pytest.mark.cuda
def test_device_only_session_records_on_the_kernels_clock(cuda):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    out = subprocess.run([sys.executable, "-c", _DEVICE_ONLY], cwd=root,
                         env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(rec["units"]) == 1
    assert [name for name, _ in rec["spans"]] == [f"dmv3d.test{i}"
                                                  for i in range(3)]
    kernels = rec["kernels"]
    # each span's matmul starts on the card after the span began and
    # before the next span (the host waits for it in between)
    edges = [start for _, start in rec["spans"]] + [rec["units"][0]]
    for lo, hi in zip(edges, edges[1:]):
        assert any(lo < k < hi for k in kernels), (lo, hi, kernels)
    assert min(kernels) > edges[0]


def _remat_step(t, remat=True):
    """A tiny remat train step of ``t`` frames and a batch for it."""
    cfg = _cfg(f"data.seq_len={t}", "data.dynamic=true",
               f"model.remat_scan={str(remat).lower()}")
    src = SyntheticScenes(num_scenes=2, image_size=32, seq_len=t,
                          num_targets=2, dynamic=True)
    state = tstep.init_state(cfg, seed=0, device="cpu")
    return state, tstep.make_train_step(cfg, device="cpu"), \
        src.batch(range(2), raw=True)


@pytest.mark.parametrize("t", [1, 4])
def test_remat_recompute_is_a_child_of_the_backward(t):
    state, step, batch = _remat_step(t)
    with _session():
        for _ in range(2):
            state, _ = step(state, batch)
    rec = _last()
    assert len(rec.units) == 2 and rec.dropped == 0
    for u in rec.units:
        mine = [(i, s) for i, s in enumerate(rec.spans) if s.unit == u.unit]
        back = [i for i, s in mine if s.name == "dmv3d.train.backward"]
        again = [s for _, s in mine if s.name == "dmv3d.encode.recompute"]
        assert len(back) == 1 and len(again) == t
        outer = rec.spans[back[0]]
        for s in again:
            assert s.parent == back[0]
            assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
        # every other span stays flat
        assert all(s.parent is None for _, s in mine
                   if s.name != "dmv3d.encode.recompute")
    # both steps eager: a CPU step never replays a graph
    assert rec.counters == {"dmv3d.encode.recomputed_frames": 2 * t,
                            "dmv3d.train.graph.eager_steps": 2}


@pytest.mark.parametrize("case", ["no_remat", "predict", "no_session"])
def test_no_recompute_span_without_a_recomputation(case):
    state, step, batch = _remat_step(2, remat=case != "no_remat")
    before = len(profiling.recordings())
    session = contextlib.nullcontext() if case == "no_session" \
        else _session()
    with session:
        if case == "predict":
            model = Model(state.module.cfg, state.module)
            model.predict(batch["image_seq"].astype(np.float32) / 127.5 - 1,
                          batch["tgt_poses"],
                          source_poses=batch["src_poses"])
        else:
            step(state, batch)
    recs = profiling.recordings()[before:]
    assert len(recs) == (0 if case == "no_session" else 1)
    for rec in recs:
        assert "dmv3d.encode.recompute" not in {s.name for s in rec.spans}
        assert rec.counters == ({} if case == "predict" else
                                {"dmv3d.train.graph.eager_steps": 1})


def test_an_adopting_span_lends_other_threads_its_parent_and_unit(
        monkeypatch):
    # autograd's CUDA thread, where a recomputation opens its span, stands
    # in as a plain thread; a thread's own open span still comes first
    monkeypatch.setattr(profiling, "_profiler_enabled", lambda: True)

    def other():
        with profiling.span("dmv3d.other"):
            with profiling.span("dmv3d.other.inner"):
                pass
    with _session():
        with profiling.unit():
            with profiling.span("dmv3d.outer", adopt=True):
                worker = threading.Thread(target=other)
                worker.start()
                worker.join(timeout=30)
                assert not worker.is_alive()
            with profiling.span("dmv3d.after"):
                worker = threading.Thread(target=other)
                worker.start()
                worker.join(timeout=30)
    spans = _last().spans
    names = [s.name for s in spans]
    assert names == ["dmv3d.outer", "dmv3d.other", "dmv3d.other.inner",
                     "dmv3d.after", "dmv3d.other", "dmv3d.other.inner"]
    unit = _last().units[0].unit
    assert [s.parent for s in spans] == [None, 0, 1, None, None, 4]
    assert [s.unit for s in spans] == [unit, unit, unit, unit, None, None]
    assert spans[1].thread != spans[0].thread


@pytest.mark.cuda
def test_cuda_recompute_on_autograd_thread_is_a_child_of_the_backward(cuda):
    cfg = _cfg("data.seq_len=3", "data.dynamic=true", "model.remat_scan=true")
    src = SyntheticScenes(num_scenes=2, image_size=32, seq_len=3,
                          num_targets=2, dynamic=True)
    batch = src.batch(range(2), raw=True)
    state = tstep.init_state(cfg, seed=0, device=cuda)
    step = tstep.make_train_step(cfg, device=cuda)
    step(state, batch)
    with _session([ProfilerActivity.CUDA]):
        step(state, batch)
    rec = _last()
    back = [i for i, s in enumerate(rec.spans)
            if s.name == "dmv3d.train.backward"]
    again = [s for s in rec.spans if s.name == "dmv3d.encode.recompute"]
    assert len(back) == 1 and len(again) == 3
    assert all(s.parent == back[0] and s.unit == rec.units[0].unit
               for s in again)
    assert {s.thread for s in again} != {rec.spans[back[0]].thread}
    # a signature's second step: eager, before the graph's capture
    assert rec.counters == {"dmv3d.encode.recomputed_frames": 3,
                            "dmv3d.train.graph.eager_steps": 1}
