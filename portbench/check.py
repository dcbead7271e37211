"""Whether what the timed calls produced is right: the numbers compared.

The traffic kinds (``kinds/<kind>.py``) call these comparisons on what
their window and set-up kept.

The plain reference works everything out again from the same weights and
inputs, in float32 with TF32 off. A cell compares the numbers its
``limits/<cell>.json`` names, each within its limit; the others are
reported as readings.

Serving: every kept request's views against the reference's views of the
same request. ``view_rms_gap``: the worst view's root-mean-square gap
over its pixels and channels. ``view_rms_gap.all``: the root-mean-square
gap over every kept view together.

Training: the reference follows the program's first three steps from the
same weights on the same batches, and the window's first three from the
state the window started from (``window.`` before each name). ``loss_gap``: the worst step's gap
between the losses over the reference's loss. ``grad_norm_gap``: by the
worst parameter, the gap between the norms of the first gradient, over
the larger of the reference's norm of that parameter and the median
parameter's; ``grad_norm_gap.median``: the same gap of the median
parameter. ``grad_error.all``: the distance between the program's and the
reference's whole first gradient, all parameters together, over the
reference's norm; ``grad_error.median`` and ``grad_error.low20``: each
parameter's own distance over its own norm, their median and the mean of
the fifth of the parameters that read smallest (those under the rule
below left out); ``.over_bf16`` after each: the same over what the
reference computed in bfloat16 (``bf16``) reads, at the same step from
the same state: a yardstick of how far rounding at the configuration's
precision moves this seed's gradient. The gradient's rounding gathers from the loss
backwards, so the parameters nearest the loss (the heads, the last
decoder level) keep the precision the step computes in, where deeper
ones read the noise both precisions amplify alike; ``low20`` reads the
former. ``change_norm_gap`` (and ``.median``): the same for the change
of each parameter over the three steps, leaving out the parameters whose
reference gradient is under a thousandth of the median parameter's
(biases ahead of a GroupNorm, whose gradient is nought but for rounding,
move under Adam by rounding alone).

The control puts the reference computed one precision below the
configuration's (``fp8``) in the program's place and reads the same
numbers.
"""

from __future__ import annotations

import statistics
from collections import defaultdict

import torch

from portbench.reference import dmv3d

# the precision one below the configurations' bfloat16: the control's
fp8 = dmv3d.fp8_round_trip
# the configurations' own: the yardstick of a train step's gradient error
bf16 = dmv3d.bf16_round_trip
TRAIN = ("loss_gap", "grad_error.all", "grad_error.median", "grad_error.low20",
         "grad_norm_gap", "change_norm_gap", "grad_norm_gap.median",
         "change_norm_gap.median", "grad_error.all.over_bf16",
         "grad_error.median.over_bf16", "grad_error.low20.over_bf16")


def _worst(values) -> float:
    """The largest of ``values``; NaN where any is NaN."""
    values = [float(v) for v in values]
    return float("nan") if any(v != v for v in values) else max(values)


def _tensors(item: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in item.items()}


def _model_cfg(cell):
    return cell["config_file"]["config"]["model"]


def reference_views(cell, params, item: dict, quant=None):
    x = _tensors(item, next(iter(params.values())).device)
    with dmv3d.exact_f32(), torch.no_grad():
        return dmv3d.Net(_model_cfg(cell), params, quant).forward(
            x["image_seq"], x["src_poses"], x["tgt_poses"])["view"]


def serve(cell, params, pool, views) -> dict:
    """``views``: request -> (pool item, views [B,K,H,W,3])."""
    by_item = defaultdict(list)
    for item, v in views.values():
        by_item[item].append(v)
    worst, squares, count = [], 0.0, 0
    for item, outs in sorted(by_item.items()):
        ref = reference_views(cell, params, pool[item])
        for v in outs:
            sq = (v.to(ref.dtype) - ref).square().mean((-3, -2, -1))
            worst.append(sq.sqrt().amax())
            squares += float(sq.sum())
            count += sq.numel()
    return {"view_rms_gap": _worst(worst),
            "view_rms_gap.all": (squares / count) ** 0.5}


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """Each parameter's gap of the first gradient's norm and, for the
    parameters the reference moves, of the change's norm (each over the
    larger of the reference's norm and the median parameter's)."""
    grad = {k: float(g.norm()) for k, g in ref["first_grads"].items()}
    med = statistics.median(grad.values())
    moved = [k for k, g in grad.items() if g >= 1e-3 * med]
    change = {k: float(ref["change"][k].norm()) for k in moved}
    med_c = statistics.median(change.values())
    return {"grad": {k: abs(prog["grad_norms"][k] - g) / max(g, med)
                     for k, g in grad.items()},
            "change": {k: abs(prog["change_norms"][k] - c) / max(c, med_c)
                       for k, c in change.items()}}


def grad_errors(prog: dict, ref: dict) -> dict:
    """The distance between the program's and the reference's first
    gradient over the reference's norm: of the whole gradient (every
    parameter together), and, among the parameters whose reference
    gradient is a thousandth of the median parameter's or more, each
    parameter's own: their median, and the mean over the fifth of them
    that read smallest."""
    sq = norm = 0.0
    each = {}
    for k, g in ref["first_grads"].items():
        d = float((prog["first_grads"][k].to(g.device) - g).square().sum())
        n = float(g.square().sum())
        sq, norm, each[k] = sq + d, norm + n, (d ** 0.5, n ** 0.5)
    med = statistics.median(n for _, n in each.values())
    rel = sorted(d / n for d, n in each.values() if n >= 1e-3 * med)
    low = rel[:max(1, len(rel) // 5)]
    return {"all": (sq / norm) ** 0.5, "median": statistics.median(rel),
            "low20": sum(low) / len(low)}


def train_numbers(prog: dict, ref: dict, yard: dict | None = None) -> dict:
    """``yard``, where given: the first gradient of the reference in
    bfloat16 (``first_grads``); each gradient error is also read over its
    own (``.over_bf16``)."""
    gaps = leaf_gaps(prog, ref)
    errors = grad_errors(prog, ref)
    over = {}
    if yard is not None:
        base = grad_errors(yard, ref)
        over = {f"grad_error.{k}.over_bf16": v / base[k] if base[k] else
                float("inf") for k, v in errors.items()}
    return {"loss_gap": _worst(abs(p - r) / abs(r) for p, r
                               in zip(prog["losses"], ref["losses"])),
            "grad_error.all": errors["all"],
            "grad_error.median": errors["median"],
            "grad_error.low20": errors["low20"],
            "grad_norm_gap": _worst(gaps["grad"].values()),
            "change_norm_gap": _worst(gaps["change"].values()),
            "grad_norm_gap.median": statistics.median(gaps["grad"].values()),
            "change_norm_gap.median":
                statistics.median(gaps["change"].values()), **over}


def passed(checks: dict, limits: dict) -> bool:
    """Every number the cell's limits name within its limit (NaN fails);
    a cell with no limit fails."""
    return bool(limits) and all(
        k in checks and checks[k] <= v for k, v in limits.items())
