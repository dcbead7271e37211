"""``train_hostbatch``: back-to-back calls of the program's
``make_train_step`` step on host batches, cycling a pool; the state
persists.

Set-up builds the state and drives its first three steps through the same
call on the pool's first three batches, recording each step's loss, the
first gradient as the optimizer holds it after step 1 (Adam's first
moment over 1 - beta1, copied to the host) and each parameter's change
after step 3. It then keeps a copy of the state on the host (the
parameters, Adam's moments, the updates done) and hands the same state
to the window. The window's first three steps record their losses,
Adam's first moment after the first and the parameters after the third
(copies on the card). The check follows both: the reference steps from
the benchmark's weights over set-up's batches, and from the host copy of
the state over the window's (``window.*`` numbers).

Faults planted under the timed path (``FAULTS``): ``unchanged`` (the
step leaves the parameters and the optimizer as they were),
``half_batch`` (the step sees the first half of the batch alone, its loss
the mean over that half), ``double`` (the update at twice the learning
rate); ``<fault>.window`` leaves set-up's three steps sound.
"""

from __future__ import annotations

import copy
import time

import torch

from portbench import check, counts, drive
from portbench import traffic as traffic_lib
from portbench.reference import train as ref_train

FIRST = 3           # steps set-up drives, and window steps the check follows
NUMBERS = tuple(f"{p}{n}" for p in ("", "window.") for n in check.TRAIN)


def _host(named: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in named.items()}


class Work:
    def __init__(self, cell, seed, device, params):
        from dynamic_multiview_3d_torch.train import step as tstep
        self.t = cell["traffic_file"]
        self.device = device
        clock = drive.Clock(device)
        self.prog = drive.Program(cell["config_file"], params, device,
                                  train=True)
        cfg = self.prog.cfg
        module = self.prog.module
        self.b1 = cfg.train.beta1
        self.state = tstep.TrainState(
            module, tstep.make_optimizer(cfg, module.parameters()))
        self.step = tstep.make_train_step(cfg, device=device)
        clock.lap("program")
        self.pool = traffic_lib.pool(self.t, cfg.model.image_size, seed,
                                     device)
        clock.lap("traffic")
        self.views_per_unit = self.t["batch"] * self.t["targets"]
        self.named = dict(module.named_parameters())
        losses = []
        for i in range(FIRST):
            _, metrics = self.step(self.state, self.pool[i])
            losses.append(metrics["loss/total"])
            if i == 0:
                # the first gradient as the optimizer holds it, kept on
                # the host so that the window's memory is the program's
                first = _host({k: m / (1.0 - self.b1) for k, m in
                               self._moment("exp_avg").items()})
        with torch.no_grad():
            change = {k: float((p - params[k]).norm())
                      for k, p in self.named.items()}
        self.first = _summary(losses, first, change)
        self.done = FIRST
        clock.lap("first_steps")
        self.start = {"params": _host(self.named),
                      "exp_avg": _host(self._moment("exp_avg")),
                      "exp_avg_sq": _host(self._moment("exp_avg_sq")),
                      "count": self.state.step}
        clock.lap("copy_state")
        self.setup = clock.laps

    def _moment(self, key) -> dict:
        opt = self.state.optimizer.state
        return {k: opt[p][key] if p in opt else torch.zeros_like(p)
                for k, p in self.named.items()}

    def _steps(self, seconds=None, limit=None, keep=False):
        """Steps until ``seconds`` pass (and the ``FIRST`` that ``keep``
        keeps are done) or ``limit`` are done -> (steps, seconds, each
        step's end in seconds from the start)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        start = time.perf_counter()
        steps, marks = 0, []
        while (time.perf_counter() - start < seconds
               or (keep and steps < FIRST)) if limit is None \
                else steps < limit:
            with drive.span("step"):
                # returns once the step's metrics are on the host
                _, metrics = self.step(
                    self.state, self.pool[self.done % len(self.pool)])
            self.done += 1
            steps += 1
            marks.append(time.perf_counter() - start)
            if keep and steps <= FIRST:
                self._keep(steps, metrics)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return steps, time.perf_counter() - start, marks

    def _keep(self, steps, metrics):
        self.kept["losses"].append(metrics["loss/total"])
        with torch.no_grad():
            if steps == 1:
                self.kept["exp_avg"] = {k: m.clone() for k, m in
                                        self._moment("exp_avg").items()}
            if steps == FIRST:
                self.kept["params"] = {k: p.detach().clone()
                                       for k, p in self.named.items()}

    def window(self, seconds):
        self.kept = {"losses": []}
        self.units, self.window_s, self.marks = self._steps(seconds,
                                                            keep=True)
        self.host_s = []

    def traced(self, units):
        self._steps(limit=units)

    def end_to_end(self) -> dict:
        return {"train_views_per_s": self.units * self.views_per_unit
                / self.window_s}

    def free(self):
        del self.state, self.step, self.prog, self.named

    def window_summary(self) -> dict:
        """What the window's first steps produced, as ``self.first``."""
        k = self.kept
        b1, m0, p0 = self.b1, self.start["exp_avg"], self.start["params"]
        with torch.no_grad():
            first = {n: ((m - b1 * m0[n].to(m)) / (1.0 - b1)).cpu()
                     for n, m in k["exp_avg"].items()}
            change = {n: float((p - p0[n].to(p)).norm())
                      for n, p in k["params"].items()}
        return _summary(k["losses"], first, change)

    def check(self, cell, params):
        return numbers(cell, params, self.pool, self.first,
                       self.window_summary(), self.start)


def _summary(losses, first_grads, change_norms) -> dict:
    return {"losses": list(losses), "first_grads": first_grads,
            "grad_norms": {k: float(g.norm()) for k, g in first_grads.items()},
            "change_norms": change_norms}


def _batches(pool, device, first):
    return [{k: torch.as_tensor(v, device=device)
             for k, v in pool[i % len(pool)].items()}
            for i in range(first, first + FIRST)]


def _start(state, device) -> tuple[dict, dict]:
    """The parameters and the optimizer's state of a host copy, on
    ``device``."""
    return ({k: v.to(device) for k, v in state["params"].items()},
            {"exp_avg": state["exp_avg"], "exp_avg_sq": state["exp_avg_sq"],
             "count": state["count"]})


def numbers(cell, params, pool, first, window, start) -> dict:
    """The reference's steps from ``params`` over set-up's batches, and
    from the state ``start`` over the window's, against what ``first`` and
    ``window`` recorded; the reference in bfloat16 gives each first
    gradient's yardstick."""
    conf = cell["config_file"]["config"]
    device = next(iter(params.values())).device
    p0, opt0 = _start(start, device)
    out = {}
    for pre, side, p, opt, at in (("", first, params, None, 0),
                                  ("window.", window, p0, opt0, FIRST)):
        batches = _batches(pool, device, at)
        ref = ref_train.run_steps(conf["model"], conf["train"], p, batches,
                                  state=opt)
        yard = ref_train.run_steps(conf["model"], conf["train"], p,
                                   batches[:1], check.bf16, state=opt)
        out.update({f"{pre}{k}": v for k, v in
                    check.train_numbers(side, ref, yard).items()})
    return out


def flops(config: dict, traffic: dict) -> float:
    """A step's: forward and backward of the loss."""
    return counts.step_flops(config["config"], traffic["batch"],
                             traffic["seq_len"], traffic["targets"])


def control(cell, params, pool) -> dict:
    """The numbers the check reads where the reference one precision below
    the configuration's (fp8) stands in the program's place: its three
    steps from the weights, then three from the state they leave."""
    conf = cell["config_file"]["config"]
    device = next(iter(params.values())).device
    one = ref_train.run_steps(conf["model"], conf["train"], params,
                              _batches(pool, device, 0), check.fp8,
                              keep_state=True)
    start = {"params": {k: params[k] + c for k, c in one["change"].items()},
             **one["state"]}
    p0, opt0 = _start(start, device)
    two = ref_train.run_steps(conf["model"], conf["train"], p0,
                              _batches(pool, device, FIRST), check.fp8,
                              state=opt0)

    def summary(out):
        return _summary(out["losses"], out["first_grads"],
                        {k: float(c.norm()) for k, c in out["change"].items()})
    return numbers(cell, params, pool, summary(one), summary(two), start)


def _fault(kind, after=0):
    """The fault ``kind`` on every call of the step after the first
    ``after``."""
    def make(make_train_step):
        def faulty_maker(cfg, *args, **kw):
            step = make_train_step(cfg, *args, **kw)
            calls = [0]

            def faulty(state, batch=None):
                calls[0] += 1
                if calls[0] <= after:
                    return step(state, batch)
                if kind == "half_batch":
                    half = len(batch["tgt_poses"]) // 2
                    return step(state, {k: v[:half] for k, v in batch.items()})
                if kind == "double":
                    for group in state.optimizer.param_groups:
                        group["lr"] = 2 * cfg.train.lr
                    return step(state, batch)
                params = [p.detach().clone()
                          for p in state.module.parameters()]
                opt = copy.deepcopy(state.optimizer.state_dict())
                state, metrics = step(state, batch)
                with torch.no_grad():
                    for p, before in zip(state.module.parameters(), params):
                        p.copy_(before)
                state.optimizer.load_state_dict(opt)
                state.step -= 1
                return state, metrics
            return faulty
        return faulty_maker

    def plant():
        from dynamic_multiview_3d_torch.train import step as tstep
        return drive.patched(tstep, "make_train_step", make)
    return plant


FAULTS = {f"{kind}{suffix}": _fault(kind, after)
          for kind in ("unchanged", "half_batch", "double")
          for suffix, after in (("", 0), (".window", FIRST))}
