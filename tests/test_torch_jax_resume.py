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
layout and back bitwise. The refusals (a streamed run's grain position,
counts that disagree, another optimizer or schedule, an EMA on one side
only) raise with messages. With JAX, Orbax, tensorstore, TensorFlow and
zstandard blocked, the port resumes the committed fixture
``tests/torch_goldens/jax_orbax/c2_adam_run`` (written by
tests/_make_torch_orbax_goldens.py) to the JAX loop's step 3.
"""

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
from dynamic_multiview_3d_torch.models import DMV3D
from dynamic_multiview_3d_torch.train import checkpoint as tckpt
from dynamic_multiview_3d_torch.train import jax_state
from dynamic_multiview_3d_torch.train import loop as tloop
from dynamic_multiview_3d_torch.train import step as tstep
from dynamic_multiview_3d_tpu import config as jconfig
from dynamic_multiview_3d_tpu.train import checkpoint as jckpt
from dynamic_multiview_3d_tpu.train import loop as jloop
from dynamic_multiview_3d_tpu.train import step as jstep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "torch_goldens", "jax_orbax",
                       "c2_adam_run")
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
                loss) -> None:
    """The port's step 3 from the JAX step 2 in ``run``: against JAX's
    update with the port's gradients, and against the JAX loop's step 3
    (``jax_after``: its flat flax tree)."""
    module = DMV3D(cfg.model, num_sources=cfg.data.seq_len)
    assert _rel(loss, jax_loss) <= 1e-5
    before = tckpt.read_jax_step(str(run), 2)
    assert not _far(state_dict, _optax_params(
        jcfg, _jax_step(jcfg, run, 2), grads, module), 1e-6)
    jg = _jax_grads(cfg, before, jax_after, module)
    gap = {n: (g.double() - jg[n]).abs() for n, g in grads.items()}
    assert not _far(state_dict, weights.from_flax(
        _sub(jax_after, "params"), module), _bounds(cfg, 3, before, gap,
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


@pytest.mark.parametrize("case", ["grain", "counts", "optimizer",
                                  "schedule", "ema"])
def test_refusals_name_what_differs(tmp_path, case):
    run = tmp_path / "run"
    shutil.copytree(FIXTURE, run)
    if case == "grain":
        (run / "grain_state_2_p0.json").write_text("{}")
        cfg = _fixture_cfg(run, "data.streaming=true",
                           "data.grain_workers=0")
        with pytest.raises(ValueError, match="grain_state_2_p0.json"):
            tloop.train(cfg, device="cpu")
        return
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
