"""``train_resident``: back-to-back dispatches of the program's
``make_train_step`` step on the configuration's device-resident frame
bank, each dispatch drawing its examples on the card
(``data.device_sampling``); the state persists. One unit is one ``step``
call: ``train.steps_per_dispatch`` optimizer steps of ``batch`` examples.

Set-up builds the bank as the training loop does for the configuration
(a ``data.source`` of frames with no root: the synthetic frames, rendered
on the host from the run's seed as ``data.seed``, packed, and uploaded
within ``data.resident_budget_mb``), then the state, and drives the first
dispatch. It keeps a copy of the state on the host (the parameters,
Adam's moments, the updates done) and hands the same state to the
window.

Set-up's dispatch and the window's first are kept. For those two alone,
patches of the program record the batch each optimizer step drew (the
bank's ``device_sample``'s output, copied) and Adam's first moment after
the dispatch's first update; the dispatch's loss (its steps' mean, as the
step reports it) and the parameters after it are kept too. The check runs
the reference's steps over the recorded batches at the schedule's
learning rates, from the benchmark's weights and from the host copy of
the state (``window.*``), and reads ``train_hostbatch``'s numbers: the
loss is the dispatch's mean, the first gradient the first update's, the
change the whole dispatch's. The draw itself is not checked here: it is
held bitwise to ``jax.random`` by the program's own tests.

Faults planted on the dispatch (``FAULTS``): ``unchanged`` (the dispatch
leaves the parameters and the optimizer as they were), ``half_batch``
(each optimizer step trains on the first half of the batch it drew),
``double`` (every update at twice the schedule's learning rate);
``<fault>.window`` leaves set-up's dispatch sound.

The traffic file gives the batch, the frames an example, the targets and
the cameras, which the configuration's own draw then takes (the cell's
are the configuration's); it has no pool of host inputs (``pool`` 0).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import statistics
import time
import warnings

import torch

from portbench import byname, check, counts, drive
from portbench.reference import train as ref_train

hostbatch = byname.load("kinds", "train_hostbatch")

FIRST = 1           # dispatches set-up drives, and window dispatches kept
NUMBERS = hostbatch.NUMBERS
_rendered: dict = {}     # the last bank's host source, by data config


def _config(cell, seed):
    """The program's configuration of the cell, with the traffic's batch,
    frames a source, targets and cameras (the cell's are the
    configuration's own) and the run's seed as ``data.seed`` (a 32-bit
    integer, as the draw's keys take it)."""
    from dynamic_multiview_3d_torch import config as config_lib
    cfg = config_lib.from_dict(cell["config_file"]["config"])
    t = cell["traffic_file"]
    if not cfg.data.device_sampling:
        raise ValueError("train_resident draws on the card: the "
                         "configuration needs data.device_sampling")
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, batch_size=t["batch"], seq_len=t["seq_len"],
        num_targets=t["targets"], src_views=t["src_views"],
        seed=seed % 2 ** 32))


def _source(cfg):
    """The configuration's frame source with every scene packed on the
    host, as the training loop materializes it; the process keeps the
    last one, which a calibration's later runs of the seed reuse."""
    from dynamic_multiview_3d_torch.data import pipeline
    if cfg.data not in _rendered:
        _rendered.clear()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # the synthetic bank's note
            source = pipeline.make_source(cfg.data)
        if cfg.data.materialize_packed:
            source.materialize_packed()
        _rendered[cfg.data] = source
    return _rendered[cfg.data]


def bank(cfg, device):
    """The device-resident bank the training loop builds for ``cfg``."""
    from dynamic_multiview_3d_torch.data import resident
    source = _source(cfg)
    if cfg.data.device_resident == "off" \
            or not resident.fits_budget(source, cfg.data):
        raise ValueError("the configuration's frames are not resident")
    return resident.ResidentFrames(source, cfg.data, device)


def draws(cfg, frames, first, count) -> list:
    """The batches the program's optimizer steps ``first`` to ``first +
    count - 1`` draw from the bank ``frames``."""
    from dynamic_multiview_3d_torch.utils import jax_random
    meta = frames.sample_meta()
    return [frames.device_sample(
        meta, jax_random.step_keys(cfg.data.seed, s, True)[1],
        cfg.data.batch_size) for s in range(first, first + count)]


class Work:
    def __init__(self, cell, seed, device, params):
        from dynamic_multiview_3d_torch.train import step as tstep
        self.t = cell["traffic_file"]
        self.device = device
        clock = drive.Clock(device)
        cfg = _config(cell, seed)
        self.bank = bank(cfg, device)
        clock.lap("bank")
        self.prog = drive.Program(cell["config_file"], params, device,
                                  train=True)
        module = self.prog.module
        self.b1 = cfg.train.beta1
        self.spd = cfg.train.steps_per_dispatch
        self.state = tstep.TrainState(
            module, tstep.make_optimizer(cfg, module.parameters()))
        self.step = tstep.make_train_step(cfg, device=device,
                                          resident=self.bank)
        self.named = dict(module.named_parameters())
        self.views_per_unit = self.t["batch"] * self.t["targets"] * self.spd
        clock.lap("program")
        with self._recorded() as kept:
            _, metrics = self.step(self.state)
        self.first = _summary(kept, metrics, params, None, self.b1,
                              to_host=True)
        clock.lap("first_dispatch")
        self.start = {"params": hostbatch._host(self.named),
                      "exp_avg": hostbatch._host(self._moment("exp_avg")),
                      "exp_avg_sq":
                          hostbatch._host(self._moment("exp_avg_sq")),
                      "count": self.state.step}
        clock.lap("copy_state")
        self.setup = clock.laps

    def _moment(self, key) -> dict:
        opt = self.state.optimizer.state
        return {k: opt[p][key] if p in opt else torch.zeros_like(p)
                for k, p in self.named.items()}

    @contextlib.contextmanager
    def _recorded(self):
        """Within the block: each drawn batch, copied, and Adam's first
        moment after the first update; after it the parameters."""
        kept = {"batches": [], "exp_avg": None}

        def draw(device_sample):
            def recorded(*args, **kw):
                batch = device_sample(*args, **kw)
                kept["batches"].append({k: v.clone()
                                        for k, v in batch.items()})
                return batch
            return recorded

        def after_update(optimizer, args, kwargs):
            if kept["exp_avg"] is None:
                kept["exp_avg"] = {k: m.clone() for k, m in
                                   self._moment("exp_avg").items()}
        hook = self.state.optimizer.register_step_post_hook(after_update)
        self.bank.device_sample = draw(self.bank.device_sample)
        try:
            yield kept
        finally:
            hook.remove()
            # the class's method again: an instance attribute holding the
            # bank's own bound method would keep the bank (1.5 GiB on the
            # card) alive until the cyclic collector runs
            del self.bank.device_sample
        with torch.no_grad():
            kept["params"] = {k: p.detach().clone()
                              for k, p in self.named.items()}

    def _dispatches(self, seconds=None, limit=None, keep=False):
        """Dispatches until ``seconds`` pass (and the ``FIRST`` that
        ``keep`` keeps are done) or ``limit`` are done -> (dispatches,
        seconds, each one's end in seconds from the start)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        start = time.perf_counter()
        units, marks = 0, []
        while (time.perf_counter() - start < seconds
               or (keep and units < FIRST)) if limit is None \
                else units < limit:
            kept = self._recorded() if keep and units < FIRST \
                else contextlib.nullcontext()
            with drive.span("step"), kept as rec:
                # returns once the dispatch's metrics are on the host
                _, metrics = self.step(self.state)
            if rec is not None:
                self.kept = (rec, metrics)
            units += 1
            marks.append(time.perf_counter() - start)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return units, time.perf_counter() - start, marks

    def window(self, seconds):
        self.units, self.window_s, self.marks = self._dispatches(
            seconds, keep=True)
        self.host_s = []

    def traced(self, units):
        self._dispatches(limit=units)

    def end_to_end(self) -> dict:
        return {"train_views_per_s": self.units * self.views_per_unit
                / self.window_s}

    def free(self):
        del self.state, self.step, self.prog, self.named, self.bank

    def check(self, cell, params):
        kept, metrics = self.kept
        window = _summary(kept, metrics, self.start["params"],
                          self.start["exp_avg"], self.b1)
        return numbers(cell, params, self.first, window, self.start)


def _summary(kept, metrics, p0, m0, b1, to_host=False) -> dict:
    """What a kept dispatch produced: its batches, its loss, the first
    gradient as Adam's first moment gives it (``m0`` the moment before,
    None for none) and each parameter's change from ``p0``."""
    with torch.no_grad():
        first = {n: (m if m0 is None else m - b1 * m0[n].to(m))
                 / (1.0 - b1) for n, m in kept["exp_avg"].items()}
        change = {n: float((p - p0[n].to(p)).norm())
                  for n, p in kept["params"].items()}
    out = hostbatch._summary([metrics["loss/total"]],
                             hostbatch._host(first), change)
    out["batches"] = [hostbatch._host(b) for b in kept["batches"]] \
        if to_host else kept["batches"]
    return out


def _mean_loss(ref: dict) -> dict:
    """The reference's steps as the dispatch reports them: one loss, the
    steps' mean."""
    return dict(ref, losses=[statistics.fmean(ref["losses"])])


def numbers(cell, params, first, window, start) -> dict:
    """The reference's steps over each kept dispatch's batches, from
    ``params`` and from the state ``start``, against what ``first`` and
    ``window`` recorded; the reference in bfloat16 at the first update
    gives each first gradient's yardstick."""
    conf = cell["config_file"]["config"]
    device = next(iter(params.values())).device
    p0, opt0 = hostbatch._start(start, device)
    out = {}
    for pre, side, p, opt in (("", first, params, None),
                              ("window.", window, p0, opt0)):
        batches = [{k: v.to(device) for k, v in b.items()}
                   for b in side["batches"]]
        ref = ref_train.run_steps(conf["model"], conf["train"], p, batches,
                                  state=opt)
        yard = ref_train.run_steps(conf["model"], conf["train"], p,
                                   batches[:1], check.bf16, state=opt)
        out.update({f"{pre}{k}": v for k, v in
                    check.train_numbers(side, _mean_loss(ref),
                                        yard).items()})
    return out


def flops(config: dict, traffic: dict) -> float:
    """A dispatch's: forward and backward of the loss, ``steps_per_
    dispatch`` times."""
    spd = config["config"]["train"]["steps_per_dispatch"]
    return spd * counts.step_flops(config["config"], traffic["batch"],
                                   traffic["seq_len"], traffic["targets"])


def control(cell, params, pool) -> dict:
    """The numbers the check reads where the reference one precision below
    the configuration's (fp8) stands in the program's place, on the
    batches the program's set-up dispatch and the window's first draw
    (the draw is a function of the step alone), from the bank of the
    process's last run, else the configuration's own ``data.seed``
    (``calibrate.py`` runs ``--seeds`` before ``--control-seeds``: a
    control seed given as a seed too reads that run's bank and batches).
    ``pool`` is unused."""
    device = next(iter(params.values())).device
    conf = cell["config_file"]["config"]
    seed = next(iter(_rendered)).seed if _rendered \
        else cell["config_file"]["config"]["data"]["seed"]
    cfg = _config(cell, seed)
    frames = bank(cfg, device)
    spd = cfg.train.steps_per_dispatch
    one_b, two_b = draws(cfg, frames, 0, spd), draws(cfg, frames, spd, spd)
    del frames
    one = ref_train.run_steps(conf["model"], conf["train"], params, one_b,
                              check.fp8, keep_state=True)
    start = {"params": {k: params[k] + c for k, c in one["change"].items()},
             **one["state"]}
    p0, opt0 = hostbatch._start(start, device)
    two = ref_train.run_steps(conf["model"], conf["train"], p0, two_b,
                              check.fp8, state=opt0)

    def summary(out, batches):
        s = hostbatch._summary(
            [statistics.fmean(out["losses"])], out["first_grads"],
            {k: float(c.norm()) for k, c in out["change"].items()})
        return dict(s, batches=batches)
    return numbers(cell, params, summary(one, one_b), summary(two, two_b),
                   start)


def _fault(kind, after=0):
    """The fault ``kind`` on every dispatch after the first ``after``."""
    def make(make_train_step):
        def faulty_maker(cfg, *args, **kw):
            step = make_train_step(cfg, *args, **kw)
            calls = [0]

            def faulty(state, batch=None):
                calls[0] += 1
                if calls[0] <= after:
                    return step(state, batch)
                if kind == "half_batch":
                    from dynamic_multiview_3d_torch.data import pipeline

                    def halve(preprocess):
                        def halved(batch, **kw):
                            half = len(batch["tgt_poses"]) // 2
                            return preprocess({k: v[:half] for k, v
                                               in batch.items()}, **kw)
                        return halved
                    with drive.patched(pipeline, "preprocess", halve):
                        return step(state, batch)
                if kind == "double":
                    def twice(optimizer, args, kwargs):
                        for group in optimizer.param_groups:
                            group["lr"] *= 2
                    hook = state.optimizer.register_step_pre_hook(twice)
                    try:
                        return step(state, batch)
                    finally:
                        hook.remove()
                params = [p.detach().clone()
                          for p in state.module.parameters()]
                opt = copy.deepcopy(state.optimizer.state_dict())
                done = state.step
                state, metrics = step(state, batch)
                with torch.no_grad():
                    for p, before in zip(state.module.parameters(), params):
                        p.copy_(before)
                state.optimizer.load_state_dict(opt)
                state.step = done
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
