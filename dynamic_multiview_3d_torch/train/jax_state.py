"""A JAX run's train state <-> the port's ``TrainState``.

A manager step of the JAX package (``<step>/default/``, Orbax) holds its
flax ``TrainState``: ``step``, ``params``, ``ema_params`` (None without an
EMA) and ``opt_state``, the optax state of its ``make_optimizer``. Read
flat (``train/orbax.py`` ``read_orbax(..., none_leaves=True)``), the
optimizer state is a tuple, one element per transformation of the chain:

    adam    (ScaleByAdamState, lr)
    adamw   (ScaleByAdamState, EmptyState, lr)     also adam, weight_decay > 0
    sgd     (EmptyState, lr)

where lr is ``ScaleState()`` under a constant learning rate and
``ScaleByScheduleState(count)`` under a schedule. Empty states are stored
as None leaves; a namedtuple's fields (``count``, ``mu``, ``nu``) are dict
keys. ``ScaleByAdamState``'s ``mu`` / ``nu`` are params-shaped trees: they
become each parameter's ``exp_avg`` / ``exp_avg_sq`` through
``weights.from_flax`` (HWIO -> OIHW, [in, out] -> [out, in], as for the
param), and its ``count`` each parameter's ``step`` (the float32 scalar
``torch.optim.Adam`` / ``AdamW`` keep); ``torch.optim.SGD`` keeps none.
``step``, the Adam count and the schedule's count are all the number of
updates done, which the port's schedule reads (``train/step.py``
``make_lr``), so they must agree. ``count`` and ``step`` are int32.

What does not carry over: the random draws. The port's are its own
(``data/pipeline.py``), so a run that samples targets, draws on the
device or reads a resident bank continues with the port's draws from the
resumed step; a host-rendered synthetic run (c2) takes the same batches
in both packages. A streamed JAX run's grain iterator position cannot be
taken over (``train/loop.py`` refuses it).
"""

from __future__ import annotations

import numpy as np
import torch

from dynamic_multiview_3d_torch import weights
from dynamic_multiview_3d_torch.config import Config

ADAM, SCHEDULE = "adam", "schedule"       # None: an empty state
_LAYOUTS = {(ADAM, None): "adam with a constant lr",
            (ADAM, SCHEDULE): "adam with an lr schedule",
            (ADAM, None, None): "adamw with a constant lr",
            (ADAM, None, SCHEDULE): "adamw with an lr schedule",
            (None, None): "sgd with a constant lr",
            (None, SCHEDULE): "sgd with an lr schedule"}


def opt_layout(cfg: Config) -> tuple:
    """The elements of the optax state the JAX package's ``make_optimizer``
    builds for ``cfg``: ADAM, SCHEDULE or None (an empty state)."""
    t = cfg.train
    lr = None if t.lr_schedule == "constant" else SCHEDULE
    if t.optimizer == "sgd":
        return (None, lr)
    if t.optimizer == "adamw" or (t.optimizer == "adam"
                                  and t.weight_decay > 0):
        return (ADAM, None, lr)
    if t.optimizer == "adam":
        return (ADAM, lr)
    raise ValueError(f"unknown optimizer: {t.optimizer}")


def _describe(layout: tuple) -> str:
    return _LAYOUTS.get(layout, f"an optax state {layout}")


def _found_layout(flat: dict) -> tuple:
    """The layout of a flat JAX state's ``opt_state`` (None leaves kept)."""
    index = {int(k.split("/")[1]) for k in flat if k.startswith("opt_state/")}
    out = []
    for i in range(max(index) + 1 if index else 0):
        keys = {k.split("/")[2] for k in flat
                if k.startswith(f"opt_state/{i}/")}
        if f"opt_state/{i}" in flat and flat[f"opt_state/{i}"] is None:
            out.append(None)
        elif keys == {"count", "mu", "nu"}:
            out.append(ADAM)
        elif keys == {"count"}:
            out.append(SCHEDULE)
        else:
            out.append(tuple(sorted(keys)))
    return tuple(out)


def _subtree(flat: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in flat.items()
            if k.startswith(prefix + "/")}


def _opt_params(state) -> list:
    """[(parameter name, parameter)] in the optimizer's order; the port
    builds one group over ``module.parameters()``."""
    named = list(state.module.named_parameters())
    group = state.optimizer.param_groups
    if len(group) != 1 or len(group[0]["params"]) != len(named) or any(
            p is not q for (_, p), q in zip(named, group[0]["params"])):
        raise ValueError("the optimizer is not one group over "
                         "module.parameters() (train.step.init_state)")
    return named


def state_from_jax(flat: dict, state, cfg: Config):
    """Fill ``state`` (a ``train.step.TrainState`` of ``cfg``, one-process
    layout) in place from a JAX train state's flat tree (None leaves kept)
    and return it. Raises ``ValueError`` naming what differs when the
    step's optimizer or schedule is not the config's, when its counts
    disagree, or when one side has an EMA and the other not."""
    want, found = opt_layout(cfg), _found_layout(flat)
    if found != want:
        t = cfg.train
        raise ValueError(
            f"the JAX step's optimizer state is {_describe(found)}; the "
            f"config (train.optimizer={t.optimizer}, train.weight_decay="
            f"{t.weight_decay}, train.lr_schedule={t.lr_schedule}) builds "
            f"{_describe(want)}")
    counts = {"step": int(flat["step"])}
    for i, kind in enumerate(found):
        if kind is not None:
            counts[f"opt_state/{i}/count"] = int(flat[f"opt_state/{i}/count"])
    if len(set(counts.values())) != 1:
        raise ValueError(f"the JAX step's counts of updates disagree: "
                         f"{counts}")
    ema = _subtree(flat, "ema_params")
    if bool(ema) != (state.ema is not None):
        raise ValueError("the JAX step and the template disagree on whether "
                         "the state has an EMA (train.ema_decay)")
    module = state.module
    named = _opt_params(state)
    module.load_state_dict(weights.from_flax(_subtree(flat, "params"),
                                             module))
    if state.ema is not None:
        ema = weights.from_flax(ema, module)
        with torch.no_grad():
            for name, t in state.ema.items():
                t.copy_(ema[name])
    if ADAM in found:
        i = found.index(ADAM)
        mu = weights.from_flax(_subtree(flat, f"opt_state/{i}/mu"), module)
        nu = weights.from_flax(_subtree(flat, f"opt_state/{i}/nu"), module)
        count = float(counts["step"])
        sd = state.optimizer.state_dict()
        sd["state"] = {
            j: {"step": torch.tensor(count, dtype=torch.float32),
                "exp_avg": mu[name], "exp_avg_sq": nu[name]}
            for j, (name, _) in zip(sd["param_groups"][0]["params"], named)}
        state.optimizer.load_state_dict(sd)
    state.step = counts["step"]
    return state


def _flat_keys(tree: dict, prefix: tuple) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_keys(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def state_to_jax(state, cfg: Config) -> dict:
    """``state`` (one-process layout) as the JAX package's train state of
    ``cfg``: a flat tree with tuple keys (int: a sequence index) and None
    leaves, for ``train/orbax.py`` ``write_orbax``."""
    named = _opt_params(state)
    step = np.asarray(state.step, np.int32)
    tree = {("step",): step}
    tree.update(_flat_keys(weights.to_flax(state.module.state_dict()),
                           ("params",)))
    for i, kind in enumerate(opt_layout(cfg)):
        if kind is None:
            tree[("opt_state", i)] = None
        elif kind == SCHEDULE:
            tree[("opt_state", i, "count")] = step
        else:
            opt = [state.optimizer.state.get(p, {}) for _, p in named]
            steps = {float(s["step"]) for s in opt if "step" in s}
            if steps - {float(state.step)} or (not steps and state.step):
                raise ValueError(f"the optimizer's steps {sorted(steps)} "
                                 f"are not the state's {state.step}")
            tree[("opt_state", i, "count")] = step
            for key, moment in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                tree.update(_flat_keys(weights.to_flax({
                    name: s.get(moment, torch.zeros_like(p))
                    for (name, p), s in zip(named, opt)}),
                    ("opt_state", i, key)))
    if state.ema is None:
        tree[("ema_params",)] = None
    else:
        tree.update(_flat_keys(weights.to_flax(state.ema), ("ema_params",)))
    return tree
