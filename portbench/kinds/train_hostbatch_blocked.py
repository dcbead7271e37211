"""``train_hostbatch_blocked``: ``train_hostbatch``'s load, kept steps,
faults and counts (loaded by name and reused), checked against the plain
reference taken over blocks of the batch's examples
(``reference/train_blocked.py``).

For a batch whose float32 reference does not fit the card at once: at
batch 128 of 256² frames the reference's saved activations come to about
100 GB. The program is freed before the check, so a block may take the
whole card; ``BLOCK`` examples at a time, the blocks' gradients averaged
before Adam's one update. The numbers, their names and the control are
``train_hostbatch``'s.
"""

from __future__ import annotations

import math

from portbench import byname, check
from portbench.reference import train_blocked

base = byname.load("kinds", "train_hostbatch")

BLOCK = 32          # examples of the reference's step at a time
FIRST = base.FIRST
NUMBERS = base.NUMBERS
FAULTS = base.FAULTS
flops = base.flops


class Work(base.Work):
    def check(self, cell, params):
        return numbers(cell, params, self.pool, self.first,
                       self.window_summary(), self.start)


def _run(conf, params, batches, quant=None, state=None, keep_state=False):
    """The blocked reference's steps, in the largest blocks of at most
    ``BLOCK`` examples that split the batch evenly."""
    block = math.gcd(len(batches[0]["tgt_poses"]), BLOCK)
    return train_blocked.run_steps(conf["model"], conf["train"], params,
                                   batches, block, quant, state=state,
                                   keep_state=keep_state)


def numbers(cell, params, pool, first, window, start) -> dict:
    """``train_hostbatch.numbers`` with the blocked reference."""
    conf = cell["config_file"]["config"]
    device = next(iter(params.values())).device
    p0, opt0 = base._start(start, device)
    out = {}
    for pre, side, p, opt, at in (("", first, params, None, 0),
                                  ("window.", window, p0, opt0, FIRST)):
        batches = base._batches(pool, device, at)
        ref = _run(conf, p, batches, state=opt)
        yard = _run(conf, p, batches[:1], check.bf16, state=opt)
        out.update({f"{pre}{k}": v for k, v in
                    check.train_numbers(side, ref, yard).items()})
    return out


def control(cell, params, pool) -> dict:
    """``train_hostbatch.control`` with the blocked reference: fp8 in the
    program's place over set-up's three steps and the window's three."""
    conf = cell["config_file"]["config"]
    device = next(iter(params.values())).device
    one = _run(conf, params, base._batches(pool, device, 0), check.fp8,
               keep_state=True)
    start = {"params": {k: params[k] + c for k, c in one["change"].items()},
             **one["state"]}
    p0, opt0 = base._start(start, device)
    two = _run(conf, p0, base._batches(pool, device, FIRST), check.fp8,
               state=opt0)

    def summary(out):
        return base._summary(out["losses"], out["first_grads"],
                             {k: float(c.norm())
                              for k, c in out["change"].items()})
    return numbers(cell, params, pool, summary(one), summary(two), start)
