"""Tracing (port of utils/profiling.py), and the program's spans.

``TraceWindow`` captures a ``torch.profiler`` trace (host ops, and the
card's kernels when CUDA is present) of a step window inside the training
loop and writes it under ``logdir`` as a Chrome trace
(``trace_steps_<first>-<end>.json``; chrome://tracing or Perfetto read
it). The train CLI exposes it as ``--profile-dir`` + ``--profile-steps``.

``span(name)`` marks a phase of the program, ``unit()`` one request or
one train step, and ``count(name, n)`` adds to a counter. A span opened
with ``adopt=True`` also stands, while it is open, as the parent of the
spans opened on threads that have none of their own open, and lends them
its unit: autograd's engine runs a CUDA backward on a thread of its own,
where the recomputation of a checkpointed step opens its span. They record
exactly while a ``torch.profiler`` session records (host and device, or
the device alone) and never while ``torch.export`` traces the program
(``on()``); otherwise each costs one check of the profiler's state, and a
span enters no ``record_function``. On, a span enters
``torch.profiler.record_function(name)``, so the phase lands on the
profiler's timeline (the Chrome trace, a benchmark's slice), and appends
a ``Span`` to the session's ``Recording``, stamped with ``time.time_ns()``
inside the range: the clock the profiler stamps its host events and the
device's kernels with, so a reader can lay the spans over the kernels. A
unit is no range of the profiler's, so the phases are the program's
outermost ranges there. A counter adds to the ``counters`` dict of the
session's ``Recording``. ``recordings()`` holds one ``Recording`` per
profiler session of the process, in order.

The spans, flat (none encloses another but for the recomputation, which
the backward encloses), by where they are opened:

    api.Model.predict            dmv3d.predict.inputs  the inputs' float32
                                 conversion; on a CUDA device each host
                                 input's one pass into a pinned block and
                                 its enqueued non-blocking copy (the
                                 default source pose's too)
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
                                 (adopting autograd's threads' spans)
                                 dmv3d.train.graph  in a step that
                                 replays the captured CUDA graph
                                 (``train.step.StepGraph``), in place of
                                 the model, loss and backward spans: the
                                 batch's copy into the graph's inputs,
                                 the capture where it happens, and the
                                 replay's launch
                                 dmv3d.train.optimizer  the lr and
                                 ``zero_grad`` before the forward; the
                                 gradients' average, the optimizer's step
                                 and the EMA after the backward
                                 dmv3d.train.sync  the metrics' stack,
                                 all-reduce and ``.tolist()``: the host's
                                 wait for the card
    models.dmv3d.DMV3D._encode   dmv3d.encode.recompute  inside the
    (in the backward)            backward, under ``remat_scan``: one
                                 frame's recurrent step run again for the
                                 activations it did not keep (a child of
                                 dmv3d.train.backward, on any thread)

``Model.predict`` and the step each open one unit per call.

The counters, all counted by ``api.Model.predict`` on a CUDA device:

    dmv3d.predict.inputs.staged        host inputs staged through a
                                       pinned block
    dmv3d.predict.inputs.staged_bytes  the float32 bytes they hold
    dmv3d.predict.inputs.host_allocs   fresh pinned blocks the staging
                                       took from CUDA (the rest came from
                                       the caching host allocator's cache)

by ``models.dmv3d.DMV3D._encode``'s recomputation in a backward:

    dmv3d.encode.recomputed_frames     frames whose recurrent step the
                                       backward ran again (an eager
                                       backward's, or a capture's: a
                                       replay runs no Python)

and by ``train.step``'s step, one per optimizer step:

    dmv3d.train.graph.eager_steps      steps whose forward, loss and
                                       backward ran eagerly
    dmv3d.train.graph.captures         captures of the step's CUDA graph
    dmv3d.train.graph.replays          replays of it (a capture's step
                                       replays once too)
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
    counted in ``dropped``. ``counters`` holds the session's counters by
    name."""

    def __init__(self, limit: int):
        self.limit = limit
        self.spans: list[Span] = []
        self.units: list[Unit] = []
        self.counters: dict[str, int] = {}
        self.dropped = 0
        self._lock = threading.Lock()

    def bump(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

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
                                             # (rec, span index, unit)s
_adopter = None          # (recording, span index, unit) of the open span
                         # that adopts other threads' spans, if any
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


def on() -> bool:
    """Whether the program records: a profiler session records, and
    ``torch.export`` is not tracing."""
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
    __slots__ = ("name", "adopt", "rf", "rec", "index", "before")

    def __init__(self, name: str, adopt: bool = False):
        self.name, self.adopt = name, adopt

    def __enter__(self):
        global _adopter
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        rec = self.rec = _recording()
        stack = _stack()
        unit = getattr(_local, "unit", None)
        parent = None
        # the thread's own open span, else the adopting one
        outer = stack[-1] if stack else _adopter
        if outer is not None and outer[0] is rec:
            _, parent, lent = outer
            unit = lent if unit is None else unit
        self.index = rec.add(rec.spans, Span(
            self.name, unit, parent, threading.get_ident(), time.time_ns(),
            None))
        stack.append((rec, self.index, unit))
        if self.adopt:
            self.before, _adopter = _adopter, (rec, self.index, unit)
        return self

    def __exit__(self, *exc):
        global _adopter
        end = time.time_ns()
        if self.adopt:
            _adopter = self.before
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


def span(name: str, adopt: bool = False):
    """A context manager that records the phase ``name`` while a profiler
    session records (see the module's docstring), and does nothing else
    otherwise. ``adopt``: while it is open, a span opened on a thread with
    no span of its own open takes it as its parent, and its unit."""
    return _Span(name, adopt) if on() else _OFF


def unit():
    """A context manager that opens one request or step while a profiler
    session records: the spans its thread opens inside it share its id.
    Inside an open unit it opens none, so a call nested in another joins
    the outer call's unit."""
    if getattr(_local, "unit", None) is None and on():
        return _Unit()
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the running session's recording
    while the program records (``on()``), and do nothing else otherwise."""
    if on():
        _recording().bump(name, n)
