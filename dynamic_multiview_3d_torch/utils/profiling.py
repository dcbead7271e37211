"""Tracing (port of utils/profiling.py), and the program's spans.

``TraceWindow`` captures a ``torch.profiler`` trace (host ops, and the
card's kernels when CUDA is present) of a step window inside the training
loop and writes it under ``logdir`` as a Chrome trace
(``trace_steps_<first>-<end>.json``; chrome://tracing or Perfetto read
it). The train CLI exposes it as ``--profile-dir`` + ``--profile-steps``.

``span(name)`` marks a phase of the program and ``unit()`` one request or
one train step. They record exactly while a ``torch.profiler`` session
records (host and device, or the device alone) and never while
``torch.export`` traces the program; otherwise a span costs one check of
the profiler's state and enters no ``record_function``. On, a span enters
``torch.profiler.record_function(name)``, so the phase lands on the
profiler's timeline (the Chrome trace, a benchmark's slice), and appends
a ``Span`` to the session's ``Recording``, stamped with ``time.time_ns()``
inside the range: the clock the profiler stamps its host events and the
device's kernels with, so a reader can lay the spans over the kernels. A
unit is no range of the profiler's, so the phases are the program's
outermost ranges there. ``recordings()`` holds one ``Recording`` per
profiler session of the process, in order.

The spans, flat (none encloses another), by where they are opened:

    api.Model.predict            dmv3d.predict.inputs  the inputs' float32
                                 conversion and copy to the device, the
                                 default source pose
    models.dmv3d.DMV3D.forward   dmv3d.encode  the frames' layout and the
                                 recurrent encoder over T
                                 dmv3d.decode  the pose codes, the
                                 bottleneck, the decoder and its heads
                                 dmv3d.synthesis  the warp or composite
                                 kernels and the outputs' assembly
    train.step's step            dmv3d.train.inputs  the host-to-device
                                 copy, the resident gather or the device
                                 draw, ``pipeline.preprocess``
                                 (then the three model spans)
                                 dmv3d.train.loss  ``total_loss``
                                 dmv3d.train.backward  ``loss.backward()``
                                 dmv3d.train.optimizer  the lr and
                                 ``zero_grad`` before the forward; the
                                 gradients' average, the optimizer's step
                                 and the EMA after the backward
                                 dmv3d.train.sync  the metrics' stack,
                                 all-reduce and ``.tolist()``: the host's
                                 wait for the card

``Model.predict`` and the step each open one unit per call.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler


class TraceWindow:
    """Windowed trace over a step loop.

    Captures steps [start, stop) of a loop that may advance several
    optimizer steps per host dispatch (train.steps_per_dispatch > 1): the
    window snaps outward to dispatch boundaries, since a dispatch is the
    smallest traceable unit.

        tw = TraceWindow(logdir, (10, 15))
        for step in range(0, n, spd):
            tw.maybe_start(step, step + spd)
            out = dispatch(...)
            tw.maybe_stop(step + spd)
    """

    def __init__(self, logdir: str | None, window: tuple[int, int] = (10, 15)):
        self.logdir = logdir
        self.start, self.stop = window
        self.active = False
        self._prof = None
        self._first = 0

    def maybe_start(self, step: int, end: int) -> None:
        """Start tracing if [step, end) covers the window's first step."""
        if self.logdir and not self.active and step <= self.start < end:
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()
            self._first = step
            self.active = True

    def maybe_stop(self, end: int) -> None:
        """Stop once ``end`` completed steps reach the window's stop, after
        waiting for the card, so the trace holds the steps' kernels and not
        just their launches."""
        if self.active and end >= self.stop:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self._write(end)

    def close(self) -> None:
        """End an open trace (the loop left inside the window) and write
        what it holds."""
        if self.active:
            self._write(None)

    def _write(self, end: int | None) -> None:
        self._prof.stop()
        os.makedirs(self.logdir, exist_ok=True)
        tail = "" if end is None else str(end)
        self._prof.export_chrome_trace(os.path.join(
            self.logdir, f"trace_steps_{self._first}-{tail}.json"))
        self._prof = None
        self.active = False


LIMIT = 100_000               # spans (and units) a recording keeps


class Span(NamedTuple):
    name: str
    unit: int | None          # the unit open on its thread, if any
    parent: int | None        # index in ``Recording.spans`` of the span
                              # that encloses it on its thread, if any
    thread: int
    start_ns: int             # time.time_ns()
    end_ns: int | None        # None while the span is open


class Unit(NamedTuple):
    unit: int
    thread: int
    start_ns: int
    end_ns: int | None


class Recording:
    """The spans and units of one profiler session, in the order they were
    opened: at most ``limit`` of each; past that they are dropped and
    counted in ``dropped``."""

    def __init__(self, limit: int):
        self.limit = limit
        self.spans: list[Span] = []
        self.units: list[Unit] = []
        self.dropped = 0
        self._lock = threading.Lock()

    def add(self, items: list, item) -> int | None:
        """Append ``item`` to ``items`` (``spans`` or ``units``) -> its
        index, or None where the recording is full."""
        with self._lock:
            if len(items) >= self.limit:
                self.dropped += 1
                return None
            items.append(item)
            return len(items) - 1

    def close(self, items: list, index: int | None, end_ns: int) -> None:
        if index is not None:
            items[index] = items[index]._replace(end_ns=end_ns)


_recordings: list[Recording] = []
_current: Recording | None = None           # the running session's
_unit_ids = itertools.count()
_local = threading.local()                   # .unit, .stack: this thread's
_OFF = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def recordings() -> list[Recording]:
    """One recording per ``torch.profiler`` session of this process (a
    session that ran no span included), in the order the sessions
    started."""
    return list(_recordings)


def _session_started() -> None:
    global _current
    _current = Recording(LIMIT)
    _recordings.append(_current)


def _session_stopped() -> None:
    global _current
    _current = None


def _hook(name: str, after) -> None:
    """Run ``after`` when the profiler calls ``torch.autograd.profiler``'s
    ``name`` (it does at each session's start and stop, whatever its
    activities)."""
    original = getattr(_autograd_profiler, name, None)
    if original is None:          # sessions then share one recording
        return

    def hooked():
        original()
        after()
    setattr(_autograd_profiler, name, hooked)


_hook("_run_on_profiler_start", _session_started)
_hook("_run_on_profiler_stop", _session_stopped)


def _on() -> bool:
    return _profiler_enabled() and not torch.compiler.is_exporting()


def _recording() -> Recording:
    if _current is None:          # a session this module saw no start of
        _session_started()
    return _current


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "rf", "rec", "index")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        rec = self.rec = _recording()
        stack = _stack()
        parent = stack[-1] if stack and stack[-1][0] is rec else None
        self.index = rec.add(rec.spans, Span(
            self.name, getattr(_local, "unit", None),
            None if parent is None else parent[1], threading.get_ident(),
            time.time_ns(), None))
        stack.append((rec, self.index))
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _stack().pop()
        self.rec.close(self.rec.spans, self.index, end)
        self.rf.__exit__(*exc)
        return False


class _Unit:
    __slots__ = ("rec", "index")

    def __enter__(self):
        rec = self.rec = _recording()
        _local.unit = next(_unit_ids)
        self.index = rec.add(rec.units, Unit(
            _local.unit, threading.get_ident(), time.time_ns(), None))
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _local.unit = None
        self.rec.close(self.rec.units, self.index, end)
        return False


def span(name: str):
    """A context manager that records the phase ``name`` while a profiler
    session records (see the module's docstring), and does nothing else
    otherwise."""
    return _Span(name) if _on() else _OFF


def unit():
    """A context manager that opens one request or step while a profiler
    session records: the spans its thread opens inside it share its id.
    Inside an open unit it opens none, so a call nested in another joins
    the outer call's unit."""
    if getattr(_local, "unit", None) is None and _on():
        return _Unit()
    return _OFF
