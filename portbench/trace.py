"""The profiled part of a ``--trace 1`` run, reduced to what the metrics read.

``torch.profiler`` (CPU and CUDA activities) records a slice run after
the measured window closes, so that profiling costs the window nothing:
``traffic["trace"] = [first, count]`` units (requests or steps), the
first ones unrecorded so that the slice is steady. The reduction keeps
the device's operations (kernels, copies, fills) as intervals, the
slice's length (from its first to its last event, host or device), the
seconds in which some operation ran on the device (the union of the
intervals), and the idle gaps, each named by what the host was doing
then: the benchmark's own span (``portbench.*``) and the outermost
operator the host was inside.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import Counter, defaultdict

import torch


# spans the profiler mirrors onto the device's timeline: no device work
ANNOTATIONS = ("portbench.", "ProfilerStep", "Optimizer.")


@dataclasses.dataclass
class Trace:
    units: int                      # requests or steps launched in the slice
    window_s: float
    busy_s: float
    device_ops: list                # [(name, start_s, dur_s)] on the device
    idle_by_host: dict              # host activity -> idle seconds
    kernel_count: int

    def kernel_times(self, name_part: str) -> list[float]:
        return [d for n, _, d in self.device_ops if name_part in n]

    def breakdown(self) -> dict:
        by_name = Counter()
        for n, _, d in self.device_ops:
            by_name[n] += d
        return {"device_ops": [[n, s] for n, s in by_name.most_common(10)],
                "idle_gaps": [[n, s] for n, s in sorted(
                    self.idle_by_host.items(), key=lambda kv: -kv[1])[:10]]}


def _is_kernel(ev) -> bool:
    kind = str(ev.activity_type()).lower() if hasattr(ev, "activity_type") \
        else ""
    name = ev.name()
    if "memcpy" in kind or "memset" in kind:
        return False
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def reduce(events, units: int, window_s: float | None = None) -> Trace:
    """The device's intervals of ``events``; the slice's length is
    ``window_s`` where given (the host clock around the slice), else from
    its first to its last event."""
    dev, host = [], []
    for ev in events:
        start, dur = ev.start_ns() * 1e-9, ev.duration_ns() * 1e-9
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if ev.is_user_annotation() or ev.name().startswith(ANNOTATIONS):
                continue        # a host span's mirror on the device's row
            dev.append((ev.name(), start, dur, _is_kernel(ev)))
        else:
            host.append((ev.name(), start, dur))
    if not dev:
        return Trace(units, 0.0, 0.0, [], {}, 0)
    ends = [s + d for _, s, d, _ in dev] + [s + d for _, s, d in host]
    lo = min([s for _, s, _, _ in dev] + [s for _, s, _ in host])
    hi = max(ends)
    # the union of the device intervals, and the gaps between them
    busy, gaps, cur_s, cur_e = 0.0, [], None, None
    for _, s, d, _ in sorted(dev, key=lambda x: x[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            else:
                gaps.append((lo, s))
            cur_s, cur_e = s, s + d
        else:
            cur_e = max(cur_e, s + d)
    busy += cur_e - cur_s
    gaps.append((cur_e, hi))
    return Trace(units, hi - lo if window_s is None else window_s, busy,
                 [(n, s, d) for n, s, d, _ in dev],
                 _name_gaps(gaps, host),
                 sum(1 for *_, k in dev if k))


def _top_level(spans):
    """The spans not inside an earlier one (one host thread), by start."""
    out, end = [], float("-inf")
    for n, s, d in sorted(spans, key=lambda x: x[1]):
        if s >= end:
            out.append((n, s, s + d))
            end = s + d
    return out


def _name_gaps(gaps, host) -> dict:
    ours = _top_level([h for h in host if h[0].startswith("portbench.")])
    ops = _top_level([h for h in host if not h[0].startswith(
        ("portbench.", "ProfilerStep"))])
    starts_ours = [s for _, s, _ in ours]
    starts_ops = [s for _, s, _ in ops]

    def at(spans, starts, t):
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and spans[i][2] >= t:
            return spans[i][0]
        return None

    idle = defaultdict(float)
    for s, e in gaps:
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        span = at(ours, starts_ours, mid) or "outside any span"
        op = at(ops, starts_ops, mid)
        idle[f"{span} / {op}" if op else span] += e - s
    return dict(idle)
