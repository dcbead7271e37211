"""The reader of ``graph_step_share.train``: the program's graph counters
in the device-only slice's recording, and None where it counts no step."""

import types

import pytest

from portbench import harness
from dynamic_multiview_3d_torch.utils import profiling

NAME = "graph_step_share.train"


def _read(monkeypatch, recs):
    monkeypatch.setattr(profiling, "recordings", lambda: recs, raising=False)
    return harness.run_reader(NAME, types.SimpleNamespace(trace=None))


def _recording(**counters):
    rec = profiling.Recording(profiling.LIMIT)
    for name, n in counters.items():
        rec.bump(f"dmv3d.train.graph.{name}", n)
    return rec


@pytest.mark.parametrize("counters,want", [
    ({"replays": 32}, 100.0),
    ({"replays": 30, "eager_steps": 2, "captures": 1}, 100.0 * 30 / 32),
    ({"eager_steps": 16}, 0.0),
])
def test_the_share_of_steps_that_replayed(monkeypatch, counters, want):
    other = _recording(replays=0, eager_steps=5)     # a later session's
    got = _read(monkeypatch, [_recording(**counters), other])
    assert got == pytest.approx(want, rel=1e-12)


def test_no_step_counted_reads_none(monkeypatch):
    assert _read(monkeypatch, [_recording(replays=0, eager_steps=0)]) is None
    assert _read(monkeypatch, [_recording()]) is None


def test_no_recording_reads_none(monkeypatch):
    assert _read(monkeypatch, []) is None
    # a program older than its recorder
    monkeypatch.delattr(profiling, "recordings")
    assert harness.run_reader(NAME, types.SimpleNamespace(trace=None)) is None
