"""Tracing (port of utils/profiling.py).

``TraceWindow`` captures a ``torch.profiler`` trace (host ops, and the
card's kernels when CUDA is present) of a step window inside the training
loop and writes it under ``logdir`` as a Chrome trace
(``trace_steps_<first>-<end>.json``; chrome://tracing or Perfetto read
it). The train CLI exposes it as ``--profile-dir`` + ``--profile-steps``.
"""

from __future__ import annotations

import os

import torch


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
