"""A training run moves between the JAX package and the port: the port's
loop resumes a JAX run's manager step (``<step>/default/``: params, optax
state, step, EMA; ``train/jax_state.py``) and writes its next steps in
that layout, which the JAX loop resumes.

At the tiny widths of tests/test_torch_loop.py (f32,
``warp_precision=exact``, host-rendered synthetic batches, which both
packages draw alike) the step after a resume is held two ways:

- to the JAX update of the JAX step with the port's own gradients (optax
  ``tx.update`` from the restored optax state): every parameter within
  1e-6, which pins the mapping of the moments, counts and schedule;
- to the JAX loop's own step: the loss within 1e-5 relative
  (test_torch_train.py's train-step bound), the params and EMA within
  1e-4 plus what the update makes of the gradients' difference
  (``_bounds``). On flat synthetic scenes the two packages' f32
  gradients differ by up to a few % on a tensor: that is the JAX
  package's f32 rounding, up to 3.7e-2 from the float64 gradients where
  the port's are within 1.4e-5 (tests/test_torch_grad_f64.py, on the
  fixture's step). Adam divides by the root of the second moment: where
  that is tiny (the two biases a GroupNorm follows have an exact gradient
  of zero) the difference is a step of up to the learning rate, which no
  1e-4 bound covers.

At full width (the c2 and c3md presets) a JAX state with seeded moments
maps onto the port's bitwise, and a port state goes through the JAX
layout and back bitwise. The refusals (a Grain state of several
processes, of another worker count, sampler or data source, an earlier
version of the port's stream state, counts that disagree, another
optimizer or schedule, an EMA on one side only, a Grain state of more
processes than the data ranks divide) raise with messages. With
JAX, Orbax, tensorstore, TensorFlow and zstandard blocked, the port
resumes the committed fixture ``tests/torch_goldens/jax_orbax/c2_adam_run``
(written by tests/_make_torch_orbax_goldens.py) to the JAX loop's step 3.

A streamed run moves too (the port's stream takes Grain's order and
state, data/grain_order.py): a port run resumed by the JAX loop, and that
JAX run resumed by the port, each take the record indices of the other
package's uninterrupted run, with the params held as above; with Grain
blocked as well and 2 spawned workers, the port resumes the committed
streamed JAX run ``c2_stream_run`` (Grain at 2 workers) to the JAX run's
records, its step 3 and its Grain state.

A JAX run's ``jax.random`` draws carry over too (utils/jax_random.py):
the committed device-sampled JAX run ``c3md_sampled_run`` resumed by the
port's loop draws the JAX run's rows at steps 3 and 4, and its step 3 is
held as above. A streamed JAX run of 2 processes, ``c2_stream2_run``
(each its own Grain shard and state), resumed by the port on 2 data
ranks (2 processes over gloo, launched as ``torch.distributed.run``
launches them, each streaming with 2 spawned workers): each rank takes
its process's records, the step-3 loss is the JAX run's within 1e-5, and
the states the ranks write after step 4, ``grain_state_4_p0.json`` and
``_p1``, are the JAX processes' (the files the JAX loop of 2 processes
resumes from).
"""

import functools
import json
import math
import os
import shutil
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch

from dynamic_multiview_3d_torch import config as tconfig
from dynamic_multiview_3d_torch import weights
from dynamic_multiview_3d_torch.data import pipeline as tpipeline
from dynamic_multiview_3d_torch.models import DMV3D
from dynamic_multiview_3d_torch.ops import reproject as treproject
from dynamic_multiview_3d_torch.train import checkpoint as tckpt
from dynamic_multiview_3d_torch.train import jax_state
from dynamic_multiview_3d_torch.train import losses as tlosses
from dynamic_multiview_3d_torch.train import loop as tloop
from dynamic_multiview_3d_torch.train import metrics as tmetrics
from dynamic_multiview_3d_torch.train import step as tstep
from dynamic_multiview_3d_tpu import config as jconfig
from dynamic_multiview_3d_tpu.data import pipeline as jpipeline
from dynamic_multiview_3d_tpu.train import checkpoint as jckpt
from dynamic_multiview_3d_tpu.train import loop as jloop
from dynamic_multiview_3d_tpu.train import step as jstep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "torch_goldens", "jax_orbax",
                       "c2_adam_run")
STREAM_FIXTURE = os.path.join(REPO, "tests", "torch_goldens", "jax_orbax",
                              "c2_stream_run")
SAMPLED_FIXTURE = os.path.join(REPO, "tests", "torch_goldens", "jax_orbax",
                               "c3md_sampled_run")
STREAM2_FIXTURE = os.path.join(REPO, "tests", "torch_goldens", "jax_orbax",
                               "c2_stream2_run")
EXPECTED = os.path.join(REPO, "tests", "torch_goldens", "jax_orbax",
                        "expected.npz")
TINY = ["model.image_size=32", "model.num_levels=3", "model.base_features=8",
        "model.max_features=16", "model.gru_features=16",
        "model.pose_embed_dim=8", "model.dtype=float32",
        "model.use_pallas=False", "model.warp_precision=exact",
        "data.image_size=32", "data.batch_size=4", "data.num_scenes=2",
        "train.lr=1e-3", "train.num_steps=3", "train.log_every=1",
        "train.ckpt_every=1", "mesh.data=1"]
OPTIMIZERS = {
    "adam-constant": ["train.optimizer=adam"],
    "adam-cosine": ["train.optimizer=adam", "train.lr_schedule=cosine",
                    "train.warmup_steps=1"],
    "adamw-cosine": ["train.optimizer=adamw", "train.weight_decay=0.01",
                     "train.lr_schedule=cosine", "train.warmup_steps=1"],
    "sgd-constant": ["train.optimizer=sgd", "train.lr=0.05"]}
EMA = ["train.ema_decay=0.9"]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore",
           "tensorflow", "zstandard", "ml_dtypes")


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def _jax_state_dict(tree, module) -> dict:
    return weights.from_flax(jax.device_get(tree), module)


def _jax_step(jcfg, ckpt_dir, step: int):
    """A JAX manager step restored as the JAX loop's restore_latest does."""
    template = jax.tree.map(ocp.utils.to_shape_dtype_struct,
                            jstep.init_state(jcfg))
    mgr = jckpt.make_manager(str(ckpt_dir))
    try:
        return mgr.restore(step, args=ocp.args.StandardRestore(template))
    finally:
        mgr.close()


def _optax_params(jcfg, before, grads: dict, module) -> dict:
    """The params after the JAX update (``make_optimizer``'s optax chain)
    of the JAX state ``before`` with the gradients ``grads`` (a port
    ``state_dict``-keyed mapping)."""
    g = jax.tree.map(jnp.asarray, weights.to_flax(grads))
    updates, _ = jstep.make_optimizer(jcfg).update(g, before.opt_state,
                                                   before.params)
    return _jax_state_dict(optax.apply_updates(before.params, updates),
                           module)


def _jax_grads(cfg, before: dict, after: dict, module) -> dict:
    """The gradient of the JAX update from the state ``before`` to
    ``after`` (flat flax trees): from Adam's first moment, or from SGD's
    step."""
    if cfg.train.optimizer == "sgd":
        p0, p1 = (weights.from_flax(_sub(x, "params"), module)
                  for x in (before, after))
        return {n: (p0[n].double() - p1[n].double()) / cfg.train.lr
                for n in p0}
    b1 = cfg.train.beta1
    m0, m1 = (weights.from_flax(_sub(x, "opt_state/0/mu"), module)
              for x in (before, after))
    return {n: (m1[n].double() - b1 * m0[n].double()) / (1 - b1)
            for n in m0}


def _sub(flat: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in flat.items()
            if k.startswith(prefix + "/")}


def _bounds(cfg, t: int, before: dict, gap: dict, module) -> dict:
    """Elementwise bounds on how far the t-th update of the state
    ``before`` (a flat flax tree) moves a parameter apart between two
    gradients ``gap`` apart: 1e-4, plus for SGD lr x gap, for Adam the
    integral of |du/dg| <= lr ((1 - b1) / c1 + R sqrt((1 - b2) / c2)) /
    (sqrt(v_hat) + eps) over the segment between them, where v_hat >= b2
    v_before / c2 (c1, c2 the bias corrections, R the bound on |m_hat| /
    sqrt(v_hat) below), capped at twice the largest step Adam can make,
    2 lr R, R = (1 - b1) / sqrt(1 - b2) * sqrt(sum_{k<t} (b1^2 / b2)^k) *
    sqrt(c2) / c1 (Cauchy-Schwarz)."""
    lr = tstep.make_lr(cfg)
    lr = lr(t - 1) if callable(lr) else lr
    if cfg.train.optimizer == "sgd":
        return {n: 1e-4 + lr * g for n, g in gap.items()}
    b1, b2 = cfg.train.beta1, cfg.train.beta2
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t
    r = ((1 - b1) / math.sqrt(1 - b2)
         * math.sqrt(sum((b1 * b1 / b2) ** k for k in range(t)))
         * math.sqrt(c2) / c1)
    gain = lr * ((1 - b1) / c1 + r * math.sqrt((1 - b2) / c2))
    nu = weights.from_flax(_sub(before, "opt_state/0/nu"), module)
    return {n: 1e-4 + (gain * g / ((b2 * nu[n].double() / c2).sqrt() + 1e-8))
            .clamp(max=2 * lr * r) for n, g in gap.items()}


def _far(ours: dict, ref: dict, bounds, scale: float = 1.0) -> dict:
    """The tensors farther from ``ref`` than ``scale`` x their bound (a
    number or each one's elementwise bounds): name -> (max |diff|,
    elements past it)."""
    assert sorted(ours) == sorted(ref)
    out = {}
    for name, t in ours.items():
        d = (t.detach().cpu().double() - ref[name].double()).abs()
        past = d > scale * (bounds[name] if isinstance(bounds, dict)
                            else bounds)
        if past.any():
            out[name] = (float(d.max()), int(past.sum()))
    return out


def _check_step(cfg, jcfg, run, state_dict, grads, jax_after, jax_loss,
                loss, step: int = 3) -> None:
    """The port's ``step`` from the JAX step before it in ``run``: against
    JAX's update with the port's gradients, and against the JAX loop's
    ``step`` (``jax_after``: its flat flax tree)."""
    module = DMV3D(cfg.model, num_sources=cfg.data.seq_len)
    assert _rel(loss, jax_loss) <= 1e-5
    before = tckpt.read_jax_step(str(run), step - 1)
    assert not _far(state_dict, _optax_params(
        jcfg, _jax_step(jcfg, run, step - 1), grads, module), 1e-6)
    jg = _jax_grads(cfg, before, jax_after, module)
    gap = {n: (g.double() - jg[n]).abs() for n, g in grads.items()}
    assert not _far(state_dict, weights.from_flax(
        _sub(jax_after, "params"), module), _bounds(cfg, step, before, gap,
                                                    module))


@pytest.mark.parametrize("ema", [False, True], ids=["no-ema", "ema"])
@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_port_resumes_a_jax_step(tmp_path, opt, ema):
    """The JAX loop trains 3 steps; the port's loop, given the JAX run's
    step 2, takes step 3 to the same loss, params and EMA, and writes it
    in the JAX layout."""
    sets = TINY + OPTIMIZERS[opt] + (EMA if ema else [])
    jcfg = jconfig.get_config("default",
                              sets + [f"train.ckpt_dir={tmp_path / 'jax'}"])
    jstate, jm = jloop.train(jcfg)
    run = tmp_path / "port"
    run.mkdir()
    shutil.copytree(tmp_path / "jax" / "2", run / "2")
    cfg = tconfig.get_config("default", sets + [f"train.ckpt_dir={run}"])
    state, m = tloop.train(cfg, device="cpu")
    assert state.step == 3 and int(jstate.step) == 3
    params = dict(state.module.named_parameters())
    jax_after = tckpt.read_jax_step(str(tmp_path / "jax"), 3)
    _check_step(cfg, jcfg, run, params,
                {n: p.grad for n, p in params.items()}, jax_after,
                jm["loss/total"], m["loss/total"])
    assert (state.ema is None) == (not ema)
    if ema:      # EMA_3 = d EMA_2 + (1 - d) p_3, from the same EMA_2
        module = state.module
        before = tckpt.read_jax_step(str(run), 2)
        jg = _jax_grads(cfg, before, jax_after, module)
        gap = {n: (p.grad.double() - jg[n]).abs() for n, p in params.items()}
        assert not _far(state.ema, weights.from_flax(
            _sub(jax_after, "ema_params"), module),
            _bounds(cfg, 3, before, gap, module),
            scale=1 - cfg.train.ema_decay)
    assert tckpt.manager_steps(str(run)) == [2, 3]
    assert tckpt.is_jax_step(str(run), 3)


def _seeded_jax_state(jcfg, step: int):
    """A JAX TrainState of ``jcfg`` at ``step`` with seeded moments and EMA
    (initialising alone: no forward)."""
    state = jstep.init_state(jcfg)
    rng = np.random.default_rng(step)

    def seeded(x, f=lambda a: a):
        return jnp.asarray(f(rng.standard_normal(x.shape).astype(np.float32)))
    adam = state.opt_state[0]
    adam = adam._replace(count=jnp.int32(step),
                         mu=jax.tree.map(seeded, adam.mu),
                         nu=jax.tree.map(lambda x: seeded(x, np.abs),
                                         adam.nu))
    rest = tuple(s._replace(count=jnp.int32(step))
                 if "count" in getattr(s, "_fields", ())
                 else s for s in state.opt_state[1:])
    return state.replace(step=jnp.int32(step), opt_state=(adam, *rest),
                         ema_params=jax.tree.map(seeded, state.params))


@pytest.mark.parametrize("preset", ["c2", "c3md"])
def test_full_width_state_maps_bitwise(tmp_path, preset):
    """A full-width JAX state (the preset's Adam, its schedule, an EMA)
    saved by the JAX manager restores into the port with every parameter,
    exp_avg, exp_avg_sq, step and EMA tensor bitwise equal to its
    transposed leaf."""
    jcfg = jconfig.get_config(preset, ["train.ema_decay=0.999"])
    jstate = _seeded_jax_state(jcfg, 5)
    mgr = jckpt.make_manager(str(tmp_path))
    mgr.save(5, args=ocp.args.StandardSave(jstate))
    mgr.wait_until_finished()
    mgr.close()
    cfg = tconfig.from_dict(jconfig.to_dict(jcfg))
    state = tstep.init_state(cfg, seed=1, device="cpu")
    tckpt.make_manager(str(tmp_path), cfg=cfg).restore(5, state)
    module = state.module
    adam = jstate.opt_state[0]
    want = {"param": _jax_state_dict(jstate.params, module),
            "exp_avg": _jax_state_dict(adam.mu, module),
            "exp_avg_sq": _jax_state_dict(adam.nu, module),
            "ema": _jax_state_dict(jstate.ema_params, module)}
    differ = []
    for name, p in module.named_parameters():
        s = state.optimizer.state[p]
        got = {"param": p.detach(), "exp_avg": s["exp_avg"],
               "exp_avg_sq": s["exp_avg_sq"], "ema": state.ema[name]}
        differ += [f"{what} {name}" for what in got
                   if not torch.equal(got[what], want[what][name])]
        if not torch.equal(s["step"], torch.tensor(5.0)):
            differ.append(f"step {name}")
    assert not differ, differ[:5]
    assert state.step == 5
    assert sum(p.numel() for p in module.parameters()) > 10_000_000


def _same_state(a, b) -> list:
    """The tensors of two port states that are not bitwise equal."""
    out = [] if a.step == b.step else ["step"]
    pa, pb = a.module.state_dict(), b.module.state_dict()
    out += [k for k in pa if not torch.equal(pa[k], pb[k])]
    oa, ob = a.optimizer.state_dict()["state"], \
        b.optimizer.state_dict()["state"]
    assert sorted(oa) == sorted(ob)
    for i in oa:
        assert sorted(oa[i]) == sorted(ob[i])
        out += [f"optimizer {i} {k}" for k in oa[i]
                if not torch.equal(oa[i][k], ob[i][k])]
    assert (a.ema is None) == (b.ema is None)
    out += [f"ema {k}" for k in a.ema or {}
            if not torch.equal(a.ema[k], b.ema[k])]
    return out


def test_jax_resumes_a_port_step(tmp_path):
    """The port trains 2 steps in the JAX layout (adamw, cosine with
    warmup, EMA); the JAX loop's restore_latest takes the step and trains
    step 3 to the loss of the port's uninterrupted step 3."""
    sets = TINY + OPTIMIZERS["adamw-cosine"] + EMA
    full, m = tloop.train(tconfig.get_config(
        "default", sets + [f"train.ckpt_dir={tmp_path / 'full'}"]),
        device="cpu")
    cut = tconfig.get_config("default", sets + [
        f"train.ckpt_dir={tmp_path / 'cut'}", "train.fail_after_step=1"])
    with pytest.raises(tloop.FaultInjected):
        tloop.train(cut, device="cpu", ckpt_format="orbax")
    assert tckpt.manager_steps(str(tmp_path / "cut")) == [1, 2]
    assert all(tckpt.is_jax_step(str(tmp_path / "cut"), s) for s in (1, 2))
    jstate, jm = jloop.train(jconfig.get_config(
        "default", sets + [f"train.ckpt_dir={tmp_path / 'cut'}"]))
    assert int(jstate.step) == 3 and full.step == 3
    assert _rel(jm["loss/total"], m["loss/total"]) <= 1e-5


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_port_state_through_the_jax_layout_is_bitwise(tmp_path, opt):
    """Port -> JAX layout -> port: every tensor of the state (params, the
    optimizer's moments and steps, the EMA, the step) bitwise."""
    sets = TINY + OPTIMIZERS[opt] + EMA + ["train.num_steps=2"]
    cfg = tconfig.get_config("default",
                             sets + [f"train.ckpt_dir={tmp_path}"])
    state, _ = tloop.train(cfg, device="cpu", ckpt_format="orbax")
    assert tckpt.is_jax_step(str(tmp_path), 2)
    back = tstep.init_state(cfg, seed=5, device="cpu")
    tckpt.make_manager(str(tmp_path), cfg=cfg).restore(2, back)
    assert back.step == 2
    assert not _same_state(state, back)


def test_max_to_keep_spans_both_layouts(tmp_path):
    """The format follows the directory's latest step unless given; the
    newest max_to_keep steps are kept whatever their layout."""
    run = tmp_path / "run"
    shutil.copytree(FIXTURE, run)
    cfg = tconfig.from_dict(json.loads((run / "train_config.json")
                                       .read_text()))
    state = tstep.init_state(cfg, device="cpu")
    mgr = tckpt.make_manager(str(run), 2, 1, cfg=cfg)
    mgr.restore(2, state)
    assert mgr.step_format() == "orbax"
    for step in (3, 4):           # the state of step 2 under other numbers
        mgr.save(step, state)
    assert mgr.all_steps() == [3, 4]
    assert all(tckpt.is_jax_step(str(run), s) for s in (3, 4))
    tckpt.make_manager(str(run), 2, 1, fmt="pt").save(5, state)
    assert mgr.all_steps() == [4, 5] and mgr.step_format() == "pt"
    assert os.path.exists(run / "5" / "state.pt")
    mgr.save(6, state)
    assert mgr.all_steps() == [5, 6] and not tckpt.is_jax_step(str(run), 6)
    with pytest.raises(ValueError, match="needs the run's config"):
        tckpt.make_manager(str(run), fmt="orbax").save(7, state, force=True)


def _fixture_cfg(run, *extra):
    cfg = tconfig.from_dict(json.loads(
        open(os.path.join(FIXTURE, "train_config.json")).read()))
    return tconfig.override(cfg, [f"train.ckpt_dir={run}", *extra])


GRAIN_REFUSALS = {
    # a JAX run of two processes (a Grain shard each) on one data rank
    "grain": ({}, [], "2 JAX processes' Grain shards cannot be split over "
              "1 data ranks: 2 does not divide 1"),
    # states of processes 0 and 2 only
    "grain-gap": ({}, [], r"Grain states are not those of processes "
                  r"0 \.\. 1.*grain_state_2_p2.json"),
    "grain-workers": ({}, ["data.grain_workers=0"],
                      "worker_count.*2 in the state, 0 here"),
    "grain-sampler": ({"sampler": "IndexSampler(num_records=6)"}, [],
                      r"sampler.*num_records=6\).*num_records=5, shard"),
    "grain-source": ({"data_source": "DMV3DSource(source='frames')"}, [],
                     "data_source.*'frames'.*'synthetic', n=5"),
    "stream-state": (None, [], "earlier version of the port.*"
                     "stream_state_2_p0.json.*not Grain's")}


@pytest.mark.parametrize("case", ["grain", "grain-gap", "grain-workers",
                                  "grain-sampler",
                                  "grain-source", "stream-state", "counts",
                                  "optimizer", "schedule", "ema"])
def test_refusals_name_what_differs(tmp_path, case):
    run = tmp_path / "run"
    if case in GRAIN_REFUSALS:
        shutil.copytree(STREAM_FIXTURE, run)
        edit, extra, match = GRAIN_REFUSALS[case]
        path = run / "grain_state_2_p0.json"
        state = json.loads(path.read_text())
        if case in ("grain", "grain-gap"):
            (run / f"grain_state_2_p{1 if case == 'grain' else 2}.json") \
                .write_text(json.dumps(state))
        elif edit is None:          # the file an earlier version wrote
            path.unlink()
            (run / "stream_state_2_p0.json").write_text(json.dumps(
                {"batches_taken": 2, "seed": 0}))
        else:
            path.write_text(json.dumps(dict(state, **edit)))
        cfg = tconfig.from_dict(json.loads(
            (run / "train_config.json").read_text()))
        cfg = tconfig.override(cfg, [f"train.ckpt_dir={run}", *extra])
        with pytest.raises(ValueError, match=match):
            tloop.train(cfg, device="cpu")
        return
    shutil.copytree(FIXTURE, run)
    if case == "counts":
        cfg = _fixture_cfg(run)
        flat = tckpt.read_jax_step(str(run), 2, none_leaves=True)
        flat["opt_state/2/count"] = np.int32(3)
        with pytest.raises(ValueError, match="counts of updates disagree.*"
                           "'opt_state/0/count': 2.*'opt_state/2/count': 3"):
            jax_state.state_from_jax(flat, tstep.init_state(
                cfg, device="cpu"), cfg)
        return
    extra, match = {
        "optimizer": (["train.optimizer=sgd"],
                      "adamw with an lr schedule.*sgd with an lr schedule"),
        "schedule": (["train.lr_schedule=constant"],
                     "adamw with an lr schedule.*adamw with a constant lr"),
        "ema": (["train.ema_decay=0"], "disagree on whether the state has "
                "an EMA")}[case]
    cfg = _fixture_cfg(run, *extra)
    with pytest.raises(ValueError, match=match):
        tloop.train(cfg, device="cpu")


def test_fixture_resumes_with_the_frameworks_absent(tmp_path):
    """A fresh interpreter with JAX, Orbax, tensorstore, TensorFlow and
    zstandard blocked resumes the committed JAX run for its step 3 and
    loads none of them; its loss and params against the JAX loop's."""
    run = tmp_path / "run"
    shutil.copytree(FIXTURE, run)
    code = textwrap.dedent(f"""
        import json, sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        from dynamic_multiview_3d_torch import config
        from dynamic_multiview_3d_torch.train import loop
        with open({str(run / "train_config.json")!r}) as f:
            cfg = config.from_dict(json.load(f))
        cfg = config.override(cfg, ["train.ckpt_dir={run}"])
        state, m = loop.train(cfg, device="cpu")
        import torch
        torch.save({{n: (p.detach(), p.grad)
                    for n, p in state.module.named_parameters()}},
                   {str(tmp_path / "params.pt")!r})
        loaded = sorted(n for n in sys.modules if sys.modules[n] is not None
                        and n.split(".")[0] in {BLOCKED!r}
                        + ("dynamic_multiview_3d_tpu",))
        print(json.dumps({{"step": state.step, "loss": m["loss/total"],
                          "loaded": loaded}}))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["step"] == 3 and out["loaded"] == []
    expected = np.load(EXPECTED)
    cfg = _fixture_cfg(run)
    jcfg = jconfig.from_dict(tconfig.to_dict(cfg))
    jax_after = {k[len("c2_adam_run/"):]: expected[k] for k in expected.files
                 if k.startswith(("c2_adam_run/params/",
                                  "c2_adam_run/mu/"))}
    jax_after = {("opt_state/0/" + k if k.startswith("mu/") else k): v
                 for k, v in jax_after.items()}
    saved = torch.load(tmp_path / "params.pt", weights_only=True)
    _check_step(cfg, jcfg, run, {n: s[0] for n, s in saved.items()},
                {n: s[1] for n, s in saved.items()}, jax_after,
                float(expected["c2_adam_run/loss"]), out["loss"])
    assert tckpt.is_jax_step(str(run), 3)


# ------------------------------------------------------- streamed runs
STREAM = ["data.streaming=true", "data.grain_workers=0",
          "data.num_scenes=5", "data.batch_size=2", "train.num_steps=4"]


class _Losses:
    """A metrics writer (both loops' interface) that keeps each step's
    loss."""
    has_images = False

    def __init__(self):
        self.loss = {}

    def write(self, step, metrics):
        self.loss[step] = float(metrics["loss/total"])


def _records(batches, cfg) -> list:
    """The record index of every row of ``batches`` (host batches of
    either package), found among the source's examples."""
    src = tpipeline.make_source(cfg.data)
    examples = [src.example(i, raw=True) for i in range(cfg.data.num_scenes)]
    out = []
    for b in batches:
        for r in range(len(b["image_seq"])):
            hit = [i for i, e in enumerate(examples)
                   if all(np.array_equal(e[k], np.asarray(b[k][r]))
                          for k in e)]
            assert len(hit) == 1, hit
            out.append(hit[0])
    return out


def _copy_step(src, dst, step: int) -> None:
    dst.mkdir()
    for name in ("train_config.json", f"grain_state_{step}_p0.json"):
        shutil.copy(src / name, dst / name)
    shutil.copytree(src / str(step), dst / str(step))


@pytest.fixture(scope="module")
def streamed_chain(tmp_path_factory):
    """One streamed run (adam, constant lr; 5 scenes in batches of 2, so
    batches straddle epochs; Grain at 0 workers) moved twice: the port
    trains 4 steps in the JAX layout (``port``); the JAX loop resumes its
    step 2 and trains steps 3-4 (``jax``); the port resumes the JAX run's
    step 3 for step 4 (``back``). Each run's batches and losses are
    kept."""
    tmp = tmp_path_factory.mktemp("streamed")
    sets = TINY + OPTIMIZERS["adam-constant"] + STREAM
    cfg = tconfig.get_config("default", sets)
    jcfg = jconfig.get_config("default", sets)
    runs = {}
    take = tpipeline.StreamIterator.__next__
    make = jpipeline.make_grain_iterator
    with pytest.MonkeyPatch.context() as mp:
        batches = []

        def recorded(self):
            batches.append(take(self))
            return batches[-1]

        def recorded_grain(*args, **kwargs):
            it = make(*args, **kwargs)

            class Recording:
                def __next__(self):
                    batches.append(next(it))
                    return batches[-1]
                get_state, set_state = it.get_state, it.set_state
            return Recording()
        mp.setattr(tpipeline.StreamIterator, "__next__", recorded)
        mp.setattr(jpipeline, "make_grain_iterator", recorded_grain)
        for name, src, step in (("port", None, 0), ("jax", "port", 2),
                                ("back", "jax", 3)):
            run = tmp / name
            if src is not None:
                _copy_step(tmp / src, run, step)
            batches.clear()
            losses = _Losses()
            if name == "jax":
                state, _ = jloop.train(jconfig.override(
                    jcfg, [f"train.ckpt_dir={run}"]), writer=losses)
            else:
                state, _ = tloop.train(tconfig.override(
                    cfg, [f"train.ckpt_dir={run}"]), writer=losses,
                    device="cpu", ckpt_format="orbax")
            runs[name] = {"dir": run, "state": state, "loss": losses.loss,
                          "records": _records(batches, cfg)}
    return cfg, jcfg, runs


@pytest.mark.parametrize("way", ["port-to-jax", "jax-to-port"])
def test_streamed_run_moves_between_packages(streamed_chain, way):
    """port-to-jax: the JAX loop, resuming the port's step 2 and Grain
    state, takes the records of the port's uninterrupted steps 3-4, and
    its step 3 is within the bounds above of the port's. jax-to-port: the
    port, resuming the JAX run's step 3 and Grain state, takes the record
    of the JAX run's step 4, its step 4 is held to that one as the
    non-streamed resumes are, and the Grain state it writes is the JAX
    run's."""
    cfg, jcfg, runs = streamed_chain
    port, jax_run, back = runs["port"], runs["jax"], runs["back"]
    module = DMV3D(cfg.model, num_sources=cfg.data.seq_len)
    if way == "port-to-jax":
        assert jax_run["records"] == port["records"][4:]
        assert _rel(jax_run["loss"][3], port["loss"][3]) <= 1e-5
        before = tckpt.read_jax_step(str(port["dir"]), 2)
        ours, theirs = (tckpt.read_jax_step(str(r["dir"]), 3)
                        for r in (port, jax_run))
        gap = {n: (g - _jax_grads(cfg, before, theirs, module)[n]).abs()
               for n, g in _jax_grads(cfg, before, ours, module).items()}
        assert not _far(weights.from_flax(_sub(theirs, "params"), module),
                        weights.from_flax(_sub(ours, "params"), module),
                        _bounds(cfg, 3, before, gap, module))
        return
    assert back["records"] == jax_run["records"][2:] == port["records"][6:]
    params = dict(back["state"].module.named_parameters())
    _check_step(cfg, jcfg, back["dir"], params,
                {n: p.grad for n, p in params.items()},
                tckpt.read_jax_step(str(jax_run["dir"]), 4),
                jax_run["loss"][4], back["loss"][4], step=4)
    assert tckpt.is_jax_step(str(back["dir"]), 4)
    states = [json.loads((r["dir"] / "grain_state_4_p0.json").read_text())
              for r in (back, jax_run)]
    assert states[0] == states[1]


RESUME_STREAM = """
import json, sys
for name in {blocked!r}:
    sys.modules[name] = None
import torch
from dynamic_multiview_3d_torch import config
from dynamic_multiview_3d_torch.data import pipeline
from dynamic_multiview_3d_torch.train import loop
with open({cfg!r}) as f:
    cfg = config.override(config.from_dict(json.load(f)),
                          ["train.ckpt_dir={run}"])
src = pipeline.make_source(cfg.data)
examples = [src.example(i, raw=True) for i in range(cfg.data.num_scenes)]
records, steps = [], {{}}
take = pipeline.StreamIterator.__next__

def recorded(self):
    batch = take(self)
    for r in range(len(batch["image_seq"])):
        records.append([i for i, e in enumerate(examples)
                        if all((e[k] == batch[k][r]).all() for k in e)])
    return batch
pipeline.StreamIterator.__next__ = recorded
make = loop.step_lib.make_train_step

def kept(*args, **kwargs):
    step_fn = make(*args, **kwargs)

    def run(state, batch):
        state, metrics = step_fn(state, batch)
        steps[state.step] = {{
            "loss": metrics["loss/total"],
            "params": {{n: p.detach().clone()
                        for n, p in state.module.named_parameters()}},
            "grads": {{n: p.grad.clone()
                       for n, p in state.module.named_parameters()}}}}
        return state, metrics
    return run
loop.step_lib.make_train_step = kept
state, _ = loop.train(cfg, device="cpu")
torch.save(steps[3], {out!r})
loaded = sorted(n for n in sys.modules if sys.modules[n] is not None
                and n.split(".")[0] in {blocked!r})
print(json.dumps({{"step": state.step, "records": records,
                  "workers": cfg.data.grain_workers, "loaded": loaded}}))
"""


def test_stream_fixture_resumes_with_grain_absent(tmp_path):
    """The committed streamed JAX run (Grain at 2 workers, stopped at
    step 2 of 4) resumed by the port's loop in a fresh interpreter with
    JAX, Grain and the rest blocked, its stream rendered by 2 spawned
    workers: steps 3 and 4 take the JAX run's records, step 3 is held to
    the JAX run's as the c2_adam_run fixture's is, and the Grain state
    written after step 4 is the JAX run's."""
    run = tmp_path / "run"
    shutil.copytree(STREAM_FIXTURE, run)
    blocked = BLOCKED + ("grain",)
    code = RESUME_STREAM.format(blocked=blocked,
                                cfg=str(run / "train_config.json"),
                                run=str(run), out=str(tmp_path / "s3.pt"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["step"] == 4 and out["workers"] == 2 and out["loaded"] == []
    expected = np.load(EXPECTED)
    assert out["records"] == [[i] for i in expected[
        "c2_stream_run/records"][2:].reshape(-1).tolist()]
    cfg = tconfig.from_dict(json.loads((run / "train_config.json")
                                       .read_text()))
    cfg = tconfig.override(cfg, [f"train.ckpt_dir={run}"])
    jcfg = jconfig.from_dict(tconfig.to_dict(cfg))
    jax_after = {}
    for k in expected.files:
        for name, prefix in (("params/", "params/"), ("mu/", "opt_state/0/"
                                                      "mu/")):
            if k.startswith("c2_stream_run/" + name):
                jax_after[prefix + k[len("c2_stream_run/" + name):]] = \
                    expected[k]
    s3 = torch.load(tmp_path / "s3.pt", weights_only=True)
    _check_step(cfg, jcfg, run, s3["params"], s3["grads"], jax_after,
                float(expected["c2_stream_run/loss"]), s3["loss"])
    assert json.loads((run / "grain_state_4_p0.json").read_text()) == \
        json.loads(str(expected["c2_stream_run/grain_state_4"]))


# the c3md preset's overrides of the committed c3md_sampled_run
# (tests/_make_torch_orbax_goldens.py TINY + SAMPLED_RUN)
SAMPLED_SETS = [
    "model.image_size=32", "model.num_levels=3", "model.base_features=8",
    "model.max_features=16", "model.gru_features=16",
    "model.pose_embed_dim=8", "model.dtype=float32", "model.use_pallas=False",
    "data.image_size=32", "model.warp_precision=exact",
    "train.optimizer=adamw", "train.weight_decay=0.01",
    "train.lr_schedule=cosine", "train.warmup_steps=1",
    "train.ema_decay=0.9", "train.lr=1e-3", "train.ckpt_every=1",
    "train.log_every=1", "data.batch_size=2", "mesh.data=1",
    "data.seq_len=3", "data.num_scenes=4", "train.steps_per_dispatch=1",
    "train.num_steps=4"]


# Multidepth's loss against the JAX loop's: a target view that is also one
# of the sources (orbit draws pick both from the same V views) reprojects
# onto itself, so its border pixels land exactly on the source's border
# (the port's coordinate 0.0, JAX's -9.5e-7 on the fixture's step 3), and
# whether each is in the image is decided by f32 rounding of the depth the
# network predicts, which no two implementations share (ROADMAP.md fault
# 15). The loss is held at 1e-5 on the pixels where no source's validity
# differs, and the pixels where one does are shown to be only such border
# pixels of such pairs.
MULTIDEPTH_FORWARD = ("view", "mask", "geo_view", "geo_valid")


def _source_valid(coords, z_ok, b: int, k: int) -> torch.Tensor:
    """Each source's validity [B, K, T, H, W] of the reprojected pixels
    (coords [B*K*T, H, W, 2], z_ok [B*K*T, H, W]): in front of the source
    and in its image, as the multidepth composite and its kernels decide."""
    c = torch.as_tensor(coords)
    h, w = c.shape[1:3]
    c = c.reshape(b, k, -1, h, w, 2)
    inb = ((c[..., 0] >= 0) & (c[..., 0] <= w - 1)
           & (c[..., 1] >= 0) & (c[..., 1] <= h - 1))
    return inb & (torch.as_tensor(z_ok).reshape(c.shape[:-1]) > 0)


def _multidepth_loss(fwd: dict, tcfg, keep) -> float:
    """``losses.total_loss``'s multidepth terms, in f64, over the pixels
    ``keep`` [B, K, H, W] of one forward (``MULTIDEPTH_FORWARD`` and
    ``tgt_images``)."""
    assert tcfg.ssim_weight == 0
    d = {k: torch.as_tensor(fwd[k]).double()
         for k in MULTIDEPTH_FORWARD + ("tgt_images",)}
    keep = torch.as_tensor(keep)[..., None].double()
    target, valid = d["tgt_images"], d["geo_valid"][..., None]
    l1 = ((d["view"] - target).abs() * keep).sum() / (keep.sum() * 3)
    m = d["mask"].clamp(1e-6, 1 - 1e-6)
    bce = -(valid * m.log() + (1 - valid) * (-m).log1p())
    lm = (bce * keep).sum() / keep.sum()
    gv = valid * keep
    geo = (((d["geo_view"] - target).abs() * gv).sum()
           / (gv.sum() * 3).clamp(min=1))
    return float(tcfg.l1_weight * l1 + tcfg.mask_weight * lm
                 + tcfg.geo_weight * geo)


def _multidepth_step3(ours: dict, loss: float, expected, name: str,
                      tcfg) -> tuple:
    """The port's step-3 forward ``ours`` against the JAX step's kept in
    ``expected``: the sources whose validity differs are border pixels of
    a target drawn as one of its sources, with both coordinates within
    1e-5 of the border; -> (the port's loss, JAX's) over the other
    pixels."""
    jax_fwd = {k: expected[f"{name}/step3/{k}"] for k in
               MULTIDEPTH_FORWARD + ("tgt_images", "coords", "z_ok")}
    b, k, h, w = jax_fwd["geo_valid"].shape
    every = torch.ones(b, k, h, w, dtype=torch.bool)
    # the kept tensors are the ones each loss was computed from
    assert _rel(_multidepth_loss(jax_fwd, tcfg, every),
                expected[f"{name}/loss"]) <= 1e-6
    assert _rel(_multidepth_loss(ours, tcfg, every), loss) <= 1e-6
    # the same target images (the uint8 normalization rounds within 1 ulp)
    assert (torch.as_tensor(jax_fwd["tgt_images"])
            - ours["tgt_images"]).abs().max() <= 1e-6
    flip = (_source_valid(ours["coords"], ours["z_ok"], b, k)
            != _source_valid(jax_fwd["coords"], jax_fwd["z_ok"], b, k))
    fb, fk, ft, fy, fx = flip.nonzero(as_tuple=True)
    assert ((fy == 0) | (fy == h - 1) | (fx == 0) | (fx == w - 1)).all()
    tgt = torch.as_tensor(expected[f"{name}/rows/tgt_pose_idx"][2])
    src = torch.as_tensor(expected[f"{name}/rows/src_pose_idx"][2])
    assert torch.equal(tgt[fb, fk], src[fb, ft])
    for c in (ours["coords"], torch.as_tensor(jax_fwd["coords"])):
        c = c.reshape(b, k, -1, h, w, 2)[flip].double()
        edge = torch.stack([c[:, 0], c[:, 0] - (w - 1), c[:, 1],
                            c[:, 1] - (h - 1)], -1).abs().amin(-1)
        assert (edge <= 1e-5).all()
    keep = ~flip.any(2)
    return (_multidepth_loss(ours, tcfg, keep),
            _multidepth_loss(jax_fwd, tcfg, keep))


def _fixture_after(expected, name: str) -> dict:
    """The flat flax tree of params and Adam's first moment after the
    fixture run's step 3, as ``expected.npz`` keeps them."""
    out = {}
    for k in expected.files:
        for part, prefix in (("params/", "params/"),
                             ("mu/", "opt_state/0/mu/")):
            if k.startswith(f"{name}/{part}"):
                out[prefix + k[len(f"{name}/{part}"):]] = expected[k]
    return out


def test_device_sampled_fixture_resumes_on_the_jax_draws(tmp_path):
    """The committed device-sampled JAX run (c3md at tiny widths,
    resident, stopped at step 2 of 4) resumed through ``cli.train``:
    steps 3 and 4 draw the rows the JAX run's steps gathered, and step 3
    is held to the JAX loop's as the c2_adam_run fixture's is, its loss
    on the pixels where no source's validity differs
    (``_multidepth_step3``)."""
    from dynamic_multiview_3d_torch.cli import train as train_cli
    from dynamic_multiview_3d_torch.data import resident as tresident
    run = tmp_path / "run"
    shutil.copytree(SAMPLED_FIXTURE, run)
    sets = SAMPLED_SETS + [f"train.ckpt_dir={run}"]
    cfg = tconfig.get_config("c3md", sets)
    assert cfg == tconfig.override(tconfig.from_dict(json.loads(
        (run / "train_config.json").read_text())), [f"train.ckpt_dir={run}"])
    jcfg = jconfig.from_dict(tconfig.to_dict(cfg))
    draws, kept, forwards, traced = [], {}, [], {}
    draw = tresident.ResidentFrames.device_draw
    make = tstep.make_train_step
    reproject, total = treproject.reproject_coords, tlosses.total_loss

    def traced_coords(*args, **kwargs):
        traced["geo"] = reproject(*args, **kwargs)
        return traced["geo"]

    def kept_loss(out, batch, *args, **kwargs):
        coords, z_ok = traced.pop("geo")
        forwards.append({**{k: out[k].detach().clone()
                            for k in MULTIDEPTH_FORWARD},
                         "tgt_images": batch["tgt_images"].clone(),
                         "coords": coords.detach().clone(),
                         "z_ok": z_ok.clone()})
        return total(out, batch, *args, **kwargs)

    def drawn(*args, **kwargs):
        out = draw(*args, **kwargs)
        draws.append({k: v.tolist() for k, v in out.items()})
        return out

    def keeping(*args, **kwargs):
        step_fn = make(*args, **kwargs)

        def run_step(state, batch):
            state, metrics = step_fn(state, batch)
            params = dict(state.module.named_parameters())
            kept[state.step] = (metrics["loss/total"],
                                {n: p.detach().clone()
                                 for n, p in params.items()},
                                {n: p.grad.clone() for n, p in params.items()})
            return state, metrics
        return run_step
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tresident.ResidentFrames, "device_draw",
                   staticmethod(drawn))
        mp.setattr(tloop.step_lib, "make_train_step", keeping)
        mp.setattr(treproject, "reproject_coords", traced_coords)
        mp.setattr(tlosses, "total_loss", kept_loss)
        # no TensorBoard: torch.utils.tensorboard imports TensorFlow here
        mp.setattr(tmetrics, "MetricsWriter", functools.partial(
            tmetrics.MetricsWriter, use_tensorboard=False))
        state, _ = train_cli.main(
            ["--preset", "c3md", *(a for s in sets for a in ("--set", s)),
             "--device", "cpu", "--logdir", str(tmp_path / "log")])
    assert state.step == 4 and len(draws) == 2
    expected = np.load(EXPECTED)
    for i, step in enumerate((2, 3)):        # state.step before steps 3, 4
        for k, v in draws[i].items():
            assert v == expected[f"c3md_sampled_run/rows/{k}"][step] \
                .tolist(), (step, k)
    loss, params, grads = kept[3]
    assert len(forwards) == 2
    ours, theirs = _multidepth_step3(forwards[0], loss, expected,
                                     "c3md_sampled_run", cfg.train)
    _check_step(cfg, jcfg, run, params, grads,
                _fixture_after(expected, "c3md_sampled_run"), theirs, ours)
    assert tckpt.is_jax_step(str(run), 4)


RANK_STREAM = """
import json, sys
for name in {blocked!r}:
    sys.modules[name] = None
from dynamic_multiview_3d_torch import config
from dynamic_multiview_3d_torch.data import pipeline
from dynamic_multiview_3d_torch.train import loop
with open({cfg!r}) as f:
    cfg = config.override(config.from_dict(json.load(f)),
                          ["train.ckpt_dir={run}"])
src = pipeline.make_source(cfg.data)
examples = [src.example(i, raw=True) for i in range(cfg.data.num_scenes)]
records = []
take = pipeline.StreamIterator.__next__

def recorded(self):
    batch = take(self)
    for r in range(len(batch["image_seq"])):
        records.append([i for i, e in enumerate(examples)
                        if all((e[k] == batch[k][r]).all() for k in e)])
    return batch
pipeline.StreamIterator.__next__ = recorded
losses = {{}}

class Losses:
    has_images = False

    def write(self, step, metrics):
        losses[step] = metrics["loss/total"]
state, _ = loop.train(cfg, device="cpu", writer=Losses())
print(json.dumps({{"step": state.step, "records": records,
                  "losses": losses}}))
"""


def test_two_process_stream_fixture_resumes_on_two_ranks(tmp_path):
    """The committed streamed JAX run of 2 processes (a Grain shard and a
    state each, 2 workers, stopped at step 2 of 4) resumed by the port's
    loop on 2 data ranks (processes joined over gloo from the launcher's
    environment, as torch.distributed.run starts them): each rank takes
    its process's records at steps 3 and 4, the step-3 loss is the JAX
    run's within 1e-5 relative, and the states written after step 4 are
    the JAX processes'. Where the processes do not divide the data ranks
    the run is refused (test_refusals_name_what_differs, "grain")."""
    from dynamic_multiview_3d_torch.parallel import dryrun
    run = tmp_path / "run"
    shutil.copytree(STREAM2_FIXTURE, run)
    code = RANK_STREAM.format(blocked=BLOCKED + ("grain",),
                              cfg=str(run / "train_config.json"),
                              run=str(run))
    port = dryrun.free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], cwd=REPO, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=dict(os.environ, PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port), RANK=str(r), WORLD_SIZE="2",
                 LOCAL_RANK=str(r), LOCAL_WORLD_SIZE="2"))
        for r in range(2)]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            proc.kill()
    expected = np.load(EXPECTED)
    for r, out in enumerate(outs):
        assert out["step"] == 4
        assert out["records"] == [[i] for i in expected[
            "c2_stream2_run/records"][r][2:].tolist()], r
        state = json.loads((run / f"grain_state_4_p{r}.json").read_text())
        assert state == json.loads(str(expected[
            f"c2_stream2_run/grain_state_4_p{r}"])), r
    assert _rel(outs[0]["losses"]["3"],
                float(expected["c2_stream2_run/loss"])) <= 1e-5
    assert tckpt.is_jax_step(str(run), 4)
