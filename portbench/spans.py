"""The program's own spans, as the per-layer readers of ``source``
``program_span`` read them.

The program (``dynamic_multiview_3d_torch.utils.profiling``) records its
phases while a ``torch.profiler`` session records, one recording a
session. A ``--trace 1`` run's first session is the device-only slice of
``traffic["trace"][1]`` units, so the readers read ``recordings()[0]``; a
program without the recorder gives None, and so does every reader. A
span's time is its self time: its length less what the spans that name it
their parent cover. Times are ``time.time_ns()``, the clock the profiler
stamps the device's operations with (``trace.Trace.device_ops``, seconds).
"""

from __future__ import annotations

import bisect
from collections import defaultdict


def recording():
    """The program's recording of the device-only slice, or None."""
    try:
        from dynamic_multiview_3d_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "recordings", None)
    recs = read() if read is not None else []
    return recs[0] if recs else None


def _union(intervals) -> list[tuple]:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def self_ns(rec) -> list[tuple]:
    """``(span, self ns)`` for each span of ``rec``."""
    children = defaultdict(list)
    for s in rec.spans:
        if s.parent is not None:
            children[s.parent].append((s.start_ns, s.end_ns))
    out = []
    for i, s in enumerate(rec.spans):
        covered = sum(min(e, s.end_ns) - max(b, s.start_ns)
                      for b, e in _union(children[i])
                      if min(e, s.end_ns) > max(b, s.start_ns))
        out.append((s, s.end_ns - s.start_ns - covered))
    return out


def ms_per_unit(names: set, rec=None) -> float | None:
    """The self milliseconds of the spans ``names`` over the recording's
    units, or None where it holds no such span or no unit."""
    rec = recording() if rec is None else rec
    if rec is None or not rec.units:
        return None
    times = [t for s, t in self_ns(rec) if s.name in names]
    if not times:
        return None
    return 1e-6 * sum(times) / len(rec.units)


def idle_share_inside(trace, names: set, rec=None) -> float | None:
    """% of the device-idle seconds of the slice ``trace`` (the gaps
    between the union of its device operations, from the first to the
    last) that lie inside the spans ``names``, or None."""
    rec = recording() if rec is None else rec
    if rec is None or trace is None or not trace.device_ops:
        return None
    spans = _union((1e-9 * s.start_ns, 1e-9 * s.end_ns)
                   for s in rec.spans if s.name in names)
    if not spans:
        return None
    busy = _union((s, s + d) for _, s, d in trace.device_ops)
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    idle = sum(e - s for s, e in gaps)
    if idle <= 0:
        return None
    starts = [s for s, _ in spans]
    inside = 0.0
    for g0, g1 in gaps:
        i = max(bisect.bisect_right(starts, g0) - 1, 0)
        while i < len(spans) and spans[i][0] < g1:
            inside += max(0.0, min(g1, spans[i][1]) - max(g0, spans[i][0]))
            i += 1
    return 100.0 * inside / idle
