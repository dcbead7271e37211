"""One run of one cell: set up, measure the window, check, report.

``run_cell`` does everything but the look for a card: it loads the
program (``dynamic_multiview_3d_torch``, imported here from the checkout),
draws the weights and the traffic from the seed, warms up the cell's
shapes, measures ``seconds`` of the traffic's load, reads the profiled
slice where ``trace``, then frees the program and checks what the timed
calls produced against the plain reference. ``run.py`` is the command.

What belongs to one cell sits in files of its own, found by name:
``BENCHMARK.json`` (the cell, its metrics), ``configs/<config>.json`` (the
program's configuration as it is run), ``traffic/<traffic>.json`` (the
mix), ``kinds/<kind>.py`` (the driver of the mix's ``kind``: its load,
what it keeps, its check, its control and faults), ``limits/<cell>.json``
(each compared number's limit) and ``metrics/<metric>.py`` (a per-layer
metric's reader).
"""

from __future__ import annotations

import collections
import json
import statistics
import time
from pathlib import Path

import torch

from portbench import byname, check, counts, traffic as traffic_lib, weights
from portbench import trace as trace_lib
from portbench.reference import dmv3d

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
GIB = 2.0 ** 30


def load_cell(name: str) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic, limits and metric entries."""
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    cell = dict(cells[name])
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cell["config_file"] = json.loads((CHECKOUT / conf["file"]).read_text())
    cell["traffic_file"] = traffic_lib.load(cell["traffic"])
    cell["limits"] = json.loads((ROOT / "limits" / f"{name}.json")
                                .read_text())

    def applies(metric):
        return name in metric.get("workloads", [name])
    cell["end_to_end"] = [m for m in bench["end_to_end"] if applies(m)]
    cell["per_layer"] = [m for m in bench["per_layer"] if applies(m)]
    return cell


def kind(cell: dict):
    """``kinds/<kind>.py`` of the cell's traffic: ``Work`` (the driver),
    ``flops``, ``control``, ``FAULTS`` and ``NUMBERS``."""
    return byname.load("kinds", cell["traffic_file"]["kind"])


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read(run)``."""
    return byname.load("metrics", name).read


def _profiler(device, host: bool):
    """``torch.profiler`` of the device's activity, and of the host's
    operators where ``host`` (which slows the host's launches)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] if host or device.type != "cuda" else []
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


class Run:
    """What the per-layer readers read: the cell, the window's units and
    length, the host spans of the program's calls, the profiled slice, the
    FLOPs of one unit, the kernels' bounds."""

    def __init__(self, cell, work, trace, flops_per_unit):
        self.cell = cell
        self.traffic = cell["traffic_file"]
        self.image_size = cell["config_file"]["config"]["model"]["image_size"]
        self.units = work.units
        self.window_s = work.window_s
        self.host_s = work.host_s
        self.latencies = getattr(work, "latencies", [])
        self.trace = trace
        self.flops_per_unit = flops_per_unit

    def roofline(self, work, name_part: str):
        """% of the bound of a kernel's ``work(b, t, k, hw)`` -> (bytes,
        operations) at the cell's shape over the mean device time of the
        kernels whose name holds ``name_part``, or None."""
        if self.trace is None:
            return None
        times = self.trace.kernel_times(name_part)
        if not times:
            return None
        t = self.traffic
        bound = counts.bound_s(work(t["batch"], t["seq_len"], t["targets"],
                                    self.image_size))
        return 100.0 * bound / statistics.fmean(times)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, phases: dict | None = None) -> dict:
    """One run of ``cell`` on ``device``; ``t_start`` is the process's
    start on the ``time.perf_counter`` clock, ``phases`` the seconds of
    set-up spent before the call, by name. Returns the result line's
    fields, with the checks last."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    t = cell["traffic_file"]
    model_cfg = cell["config_file"]["config"]["model"]
    phases = dict(phases or {})
    phases["to_run_cell"] = time.perf_counter() - t_start \
        - sum(phases.values())
    params = weights.draw(dmv3d.param_shapes(model_cfg), seed, device)
    if cuda:
        torch.cuda.synchronize()
    phases["weights"] = time.perf_counter() - t_start - sum(phases.values())
    driver = kind(cell)
    work = driver.Work(cell, seed, device, params)
    phases.update(work.setup)
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    work.window(seconds)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    slice_ = None
    if trace:
        # after the window: settle, profile the device alone (its busy
        # share and kernels), then a shorter slice with the host's
        # operators to name the idle gaps
        first, count = t["trace"]
        work.traced(first)
        if cuda:
            torch.cuda.synchronize()
        with _profiler(device, host=False) as prof:
            t0 = time.perf_counter()
            work.traced(count)        # ends once the device has finished
            slice_s = time.perf_counter() - t0
        slice_ = trace_lib.reduce(prof.profiler.kineto_results.events(),
                                  count, slice_s)
        with _profiler(device, host=True) as prof:
            work.traced(max(2, count // 4))
        slice_.idle_by_host = trace_lib.reduce(
            prof.profiler.kineto_results.events(), 0).idle_by_host
    run = Run(cell, work, slice_, driver.flops(cell["config_file"], t))
    e2e = work.end_to_end()
    e2e["peak_mem_gib"] = window_peak / GIB
    e2e["setup_s"] = setup_s
    attempted = work.units
    work.free()
    if cuda:
        torch.cuda.empty_cache()
    checks = work.check(cell, params)
    names = cell["per_layer"] if trace else cell["end_to_end"]
    metrics = {}
    for m in names:
        value = run_reader(m["name"], run) if trace else e2e.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell["chips"],
           "memory_peak_bytes": max(setup_peak, window_peak) if cuda else 0}
    out = {"correct": check.passed(checks, cell["limits"]),
           "attempted": attempted, "failed": 0,
           "metrics": metrics, "device": dev}
    if trace and slice_ is not None:
        dev.update(busy_s=slice_.busy_s, window_s=slice_.window_s)
        out["breakdown"] = slice_.breakdown()
    if not trace:
        # what the kind measures beside the cell's end-to-end metrics
        out["not_gated"] = {k: v for k, v in e2e.items() if k not in metrics}
    out["setup_phases_s"] = phases
    out["window_rates_per_5s"] = _rates(work.marks, 5.0)
    out["readings"] = checks
    out["checks"] = {k: {"value": checks.get(k), "limit": v}
                     for k, v in cell["limits"].items()}
    return out


def _rates(marks, width):
    """Units completed per second in each ``width``-second stretch of the
    window (the last, partial one left out)."""
    bins = collections.Counter(int(m // width) for m in marks)
    full = int(marks[-1] // width) if marks else 0
    return [bins[i] / width for i in range(full)]


def run_reader(name: str, run: Run):
    value = metric_reader(name)(run)
    return None if value is None else float(value)
