"""``serve_closed``: ``clients`` closed-loop clients of ``Model.predict``.

Each client has one request outstanding, on one host thread. A client
submits (host float32 arrays, as a user passes them), the call returns
with its views on the card, an event is recorded after it; the client
waits for that event before it submits again, while the other client's
request runs. A request's latency runs from its submit to its event,
placed on the host clock against an anchor event. ``traffic["compare"]``
requests of the window, a reservoir sample drawn from the seed, keep
their views for the check, which runs the reference over each.

Faults planted under the timed path (``FAULTS``): ``altered`` (each
request's first example gets the second example's views),
``half_batch`` (the second half of each request's examples get the first
half's views).
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from portbench import check, counts, drive
from portbench import traffic as traffic_lib

NUMBERS = ("view_rms_gap", "view_rms_gap.all")


class Work:
    def __init__(self, cell, seed, device, params):
        from dynamic_multiview_3d_torch import api
        self.t = cell["traffic_file"]
        self.device = device
        clock = drive.Clock(device)
        self.prog = drive.Program(cell["config_file"], params, device,
                                  train=False)
        self.model = api.Model(self.prog.cfg, self.prog.module)
        clock.lap("program")
        self.pool = traffic_lib.pool(self.t, self.prog.cfg.model.image_size,
                                     seed, device)
        clock.lap("traffic")
        self.rng = np.random.default_rng([seed, 2])
        self.views_per_unit = self.t["batch"] * self.t["targets"]
        self._loop(2 * self.t["clients"], keep=False)        # warm-up
        clock.lap("warm_up")
        self.setup = clock.laps

    def request(self, i):
        r = self.pool[i % len(self.pool)]
        return self.model.predict(r["image_seq"], r["tgt_poses"],
                                  source_poses=r["src_poses"])

    def _event(self):
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _loop(self, limit, keep=True, seconds=None):
        """Requests until ``limit`` are submitted or ``seconds`` pass;
        -> (requests, seconds from the first submit to the last
        completion, latencies, host seconds of each call, completions'
        seconds from the first submit)."""
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
        t_anchor = time.perf_counter()
        anchor = self._event()
        start = time.perf_counter()
        deadline = None if seconds is None else start + seconds
        pending = collections.deque()
        latencies, host_s, marks = [], [], []
        submitted = 0

        def submit():
            nonlocal submitted
            i = submitted
            submitted += 1
            t0 = time.perf_counter()
            with drive.span("predict"):
                views = self.request(i)
            host_s.append(time.perf_counter() - t0)
            pending.append((t0, self._event()))
            if keep:
                self._reservoir(i, views)

        def more():
            return submitted < limit if deadline is None \
                else time.perf_counter() < deadline

        for _ in range(self.t["clients"]):
            submit()
        end = start
        while pending:
            t0, ev = pending.popleft()
            with drive.span("wait"):
                if cuda:
                    ev.synchronize()
                    done = t_anchor + anchor.elapsed_time(ev) * 1e-3
                else:
                    done = time.perf_counter()
            latencies.append(done - t0)
            marks.append(done - start)
            end = max(end, done)
            if more():
                submit()
        return submitted, end - start, latencies, host_s, marks

    def _reservoir(self, i, views):
        m = self.t["compare"]
        if i < m:
            self.kept[i] = views
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < m:
                del self.kept[sorted(self.kept)[j]]
                self.kept[i] = views

    def window(self, seconds):
        self.kept = {}
        self.units, self.window_s, self.latencies, self.host_s, \
            self.marks = self._loop(None, seconds=seconds)

    def traced(self, units):
        self._loop(units, keep=False)

    def end_to_end(self) -> dict:
        return {"views_per_s": self.units * self.views_per_unit
                / self.window_s,
                "latency_p95_ms": 1e3 * float(np.percentile(self.latencies,
                                                            95))}

    def free(self):
        del self.model, self.prog

    def check(self, cell, params):
        """The kept requests' views against the reference's."""
        views = {i: (i % len(self.pool), v)
                 for i, v in sorted(self.kept.items())}
        return check.serve(cell, params, self.pool, views)


def flops(config: dict, traffic: dict) -> float:
    """A request's: the forward."""
    return counts.forward_flops(config["config"]["model"], traffic["batch"],
                                traffic["seq_len"], traffic["targets"])


def control(cell, params, pool) -> dict:
    """The numbers the check reads where the reference one precision below
    the configuration's (fp8) stands in the program's place, on as many
    requests as a run keeps."""
    t = cell["traffic_file"]
    with torch.no_grad():
        views = {i: (i % t["pool"], check.reference_views(
            cell, params, pool[i % t["pool"]], check.fp8))
            for i in range(t["compare"])}
        return check.serve(cell, params, pool, views)


def _fault(kind):
    def make(predict):
        def faulty(self, *args, **kw):
            views = predict(self, *args, **kw).clone()
            if kind == "altered":
                views[0] = views[1]
            else:
                half = views.shape[0] // 2
                views[half:2 * half] = views[:half]
            return views
        return faulty

    def plant():
        from dynamic_multiview_3d_torch import api
        return drive.patched(api.Model, "predict", make)
    return plant


FAULTS = {"altered": _fault("altered"), "half_batch": _fault("half_batch")}
