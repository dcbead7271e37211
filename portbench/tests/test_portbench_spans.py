"""The readers of the program's spans (``portbench/spans.py`` and the
``program_span`` metrics) on hand-made recordings and slices: self time,
the recording's own count of units, the device-idle seconds inside a
phase, and None where the program records no spans."""

import types

import pytest

from portbench import harness
from portbench.trace import Trace
from dynamic_multiview_3d_torch.utils import profiling

T0 = 1_792_320_405_000_000_000          # ns, a time.time_ns() of 2026
MS = 1_000_000


def _ns(ms):
    return T0 + round(ms * MS)


def _recording(phases):
    """A recording of units, each a list of (name, start ms, end ms,
    parent index or None), times from T0."""
    rec = profiling.Recording(profiling.LIMIT)
    for uid, spans in phases.items():
        lo = min(s for _, s, _, _ in spans)
        hi = max(e for _, _, e, _ in spans)
        rec.add(rec.units, profiling.Unit(uid, 1, _ns(lo), _ns(hi)))
        for name, s, e, parent in spans:
            rec.add(rec.spans, profiling.Span(name, uid, parent, 1, _ns(s),
                                              _ns(e)))
    return rec


SERVE = {
    7: [("dmv3d.predict.inputs", 0, 2, None),
        ("dmv3d.encode", 2, 5, None),
        ("dmv3d.child", 3, 4, 1),          # inside the encode span
        ("dmv3d.decode", 5, 6, None),
        ("dmv3d.synthesis", 6, 7, None)],
    8: [("dmv3d.predict.inputs", 10, 13, None),
        ("dmv3d.encode", 13, 15, None),
        ("dmv3d.decode", 15, 17, None),
        ("dmv3d.synthesis", 17, 18, None)],
}
TRAIN = {
    1: [("dmv3d.train.inputs", 0, 1, None),
        ("dmv3d.train.optimizer", 1, 1.5, None),
        ("dmv3d.encode", 1.5, 3, None),
        ("dmv3d.decode", 3, 5, None),
        ("dmv3d.synthesis", 5, 5.5, None),
        ("dmv3d.train.loss", 5.5, 6, None),
        ("dmv3d.train.backward", 6, 10, None),
        ("dmv3d.train.optimizer", 10, 12, None),
        ("dmv3d.train.sync", 12, 13, None)],
}


def _slice(ops_ms):
    """A device-only slice of operations (start ms, end ms) from T0."""
    ops = [("k", T0 * 1e-9 + s * 1e-3, (e - s) * 1e-3) for s, e in ops_ms]
    return Trace(2, 0.02, 0.0, ops, {}, len(ops))


def _read(name, monkeypatch, recs, trace=None):
    monkeypatch.setattr(profiling, "recordings", lambda: recs, raising=False)
    return harness.run_reader(name, types.SimpleNamespace(trace=trace))


@pytest.mark.parametrize("name,want", [
    ("inputs_ms_per_request.serve", (2 + 3) / 2),
    ("encode_ms_per_request.serve", ((3 - 1) + 2) / 2),   # less its child
    ("decode_ms_per_request.serve", (1 + 2) / 2),
])
def test_serve_readers_give_self_ms_per_unit(monkeypatch, name, want):
    other = _recording({9: [("dmv3d.encode", 0, 100, None)]})
    got = _read(name, monkeypatch, [_recording(SERVE), other])
    assert got == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name,want", [
    ("forward_ms_per_step.train", 1.5 + 2 + 0.5),
    ("backward_ms_per_step.train", 4.0),
    ("optimizer_ms_per_step.train", 0.5 + 2),           # both of its spans
    ("sync_wait_ms_per_step.train", 1.0),
])
def test_train_readers_give_self_ms_per_step(monkeypatch, name, want):
    got = _read(name, monkeypatch, [_recording(TRAIN)])
    assert got == pytest.approx(want, rel=1e-9)


def test_inputs_idle_share_is_the_idle_time_inside_the_input_spans(
        monkeypatch):
    # busy [1, 1.5], [4, 12] (two overlapping ops), [14, 20]: idle
    # (1.5, 4) and (12, 14), 4.5 ms; inside the inputs spans [0, 2] and
    # [10, 13]: 0.5 + 1 ms
    trace = _slice([(1, 1.5), (4, 9), (8, 12), (14, 20)])
    got = _read("inputs_idle_share.serve", monkeypatch,
                [_recording(SERVE)], trace)
    # the slice keeps its times as float seconds, 0.24 us apart at T0
    assert got == pytest.approx(100 * 1.5 / 4.5, abs=0.02)


def test_a_busy_slice_or_no_slice_reads_none(monkeypatch):
    rec = _recording(SERVE)
    assert _read("inputs_idle_share.serve", monkeypatch, [rec],
                 _slice([(0, 20)])) is None
    assert _read("inputs_idle_share.serve", monkeypatch, [rec]) is None


@pytest.mark.parametrize("name", [
    "inputs_ms_per_request.serve", "inputs_idle_share.serve",
    "encode_ms_per_request.serve", "decode_ms_per_request.serve",
    "forward_ms_per_step.train", "backward_ms_per_step.train",
    "optimizer_ms_per_step.train", "sync_wait_ms_per_step.train"])
def test_a_program_without_spans_reads_none(monkeypatch, name):
    trace = _slice([(1, 2), (4, 5)])
    run = types.SimpleNamespace(trace=trace)
    # a program older than its recorder, one that recorded nothing, and a
    # recording of another phase
    monkeypatch.delattr(profiling, "recordings")
    assert harness.run_reader(name, run) is None
    assert _read(name, monkeypatch, [], trace) is None
    other = _recording({3: [("dmv3d.other", 0, 3, None)]})
    assert _read(name, monkeypatch, [other], trace) is None


def test_self_time_clips_children_to_their_parent():
    from portbench import spans
    rec = _recording({1: [("dmv3d.a", 0, 10, None),
                          ("dmv3d.b", 2, 6, 0),
                          ("dmv3d.c", 5, 12, 0)]})
    times = {s.name: t / MS for s, t in spans.self_ns(rec)}
    assert times == {"dmv3d.a": 10 - 8, "dmv3d.b": 4, "dmv3d.c": 7}
