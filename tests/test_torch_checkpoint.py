"""The port's checkpoints (train/checkpoint.py, Model.from_checkpoint /
save_checkpoint) against the JAX package's.

- A model directory written by the JAX package (Orbax) loads into the port
  and predicts within test_torch_model.py's TOL = 1e-4 of JAX's
  ``Model.from_checkpoint(...).predict`` on the tiny f32 config
  (``warp_precision=exact``; flow in units of its range), in this process
  (also with tensorstore blocked) and in a fresh one that blocks
  tensorstore and zstandard and must import no jax, flax, orbax or JAX
  package module: the port reads Orbax with its own reader.
- The port's own directory round trip is bitwise (weights and predict),
  and its ``config.json`` loads in the JAX package's ``config.from_dict``.
- The manager keeps the same steps as an Orbax ``CheckpointManager`` with
  the same options over the same sequence of saves.
"""

import json
import os
import subprocess
import sys

import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from dynamic_multiview_3d_torch import config as tconfig
from dynamic_multiview_3d_torch.api import Model as TModel
from dynamic_multiview_3d_torch.data.synthetic import random_poses, smooth_images
from dynamic_multiview_3d_torch.train import checkpoint as tckpt
from dynamic_multiview_3d_torch.train import step as tstep
from dynamic_multiview_3d_tpu import config as jconfig
from dynamic_multiview_3d_tpu.api import Model as JModel
from test_torch_model import TOL, _assert_outputs_close, _multi, _pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(t, seed=0):
    rng = np.random.default_rng(seed)
    return (smooth_images(rng, 2, t, 32), random_poses(rng, 2, t),
            random_poses(rng, 2, 3))


@pytest.mark.parametrize("extra,t", [
    ((), 1),
    ((), 2),
    (_multi("multidepth", "baked"), 3),
], ids=["flow", "flow-t2", "multidepth-baked"])
def test_jax_dir_predicts_like_jax(tmp_path, extra, t):
    jm, _, _ = _pair(extra)
    path = str(tmp_path / "jax_model")
    jm.save_checkpoint(path, step=4)
    assert os.path.isdir(os.path.join(path, "params_4"))
    ref_model = JModel.from_checkpoint(path)
    ours_model = TModel.from_checkpoint(path, device="cpu")
    assert ours_model.cfg == tconfig.from_dict(jconfig.to_dict(jm.cfg))
    seq, src, tgt = _inputs(t)
    ref = ref_model.predict(seq, tgt, source_poses=src, return_aux=True)
    ours = ours_model.predict(seq, tgt, source_poses=src, return_aux=True)
    _assert_outputs_close(ref, ours, ours_model.cfg)


def test_jax_dir_loads_without_jax(tmp_path):
    """A fresh process in which tensorstore and zstandard cannot be
    imported reads the JAX-written directory and predicts; no jax, flax,
    orbax, JAX-package, tensorstore or zstandard module is imported on the
    way."""
    jm, _, _ = _pair()
    path = str(tmp_path / "jax_model")
    jm.save_checkpoint(path, step=2)
    seq, src, tgt = _inputs(1, seed=5)
    np.savez(tmp_path / "inputs.npz", seq=seq, src=src, tgt=tgt)
    code = f"""
import sys
sys.modules["tensorstore"] = sys.modules["zstandard"] = None
import numpy as np
from dynamic_multiview_3d_torch.api import Model
x = np.load({str(tmp_path / "inputs.npz")!r})
m = Model.from_checkpoint({path!r}, device="cpu")
np.save({str(tmp_path / "views.npy")!r},
        m.predict(x["seq"], x["tgt"], source_poses=x["src"]).numpy())
bad = sorted(n for n in sys.modules if sys.modules[n] is not None and
             n.split(".")[0] in ("jax", "jaxlib", "flax", "orbax",
                                 "dynamic_multiview_3d_tpu", "tensorstore",
                                 "zstandard"))
assert not bad, bad
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    ref = np.asarray(jm.predict(seq, tgt, source_poses=src))
    np.testing.assert_allclose(np.load(tmp_path / "views.npy"), ref,
                               rtol=TOL, atol=TOL)


def test_jax_dir_without_tensorstore_names_it(tmp_path, monkeypatch):
    """With tensorstore blocked the JAX-written directory still loads (the
    port's own Orbax reader needs none) and predicts like JAX."""
    jm, _, _ = _pair()
    path = str(tmp_path / "jax_model")
    jm.save_checkpoint(path, step=0)
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    ours = TModel.from_checkpoint(path, device="cpu")
    seq, src, tgt = _inputs(1, seed=6)
    _assert_outputs_close(
        jm.predict(seq, tgt, source_poses=src, return_aux=True),
        ours.predict(seq, tgt, source_poses=src, return_aux=True), ours.cfg)


@pytest.mark.parametrize("extra", [(), _multi("multiflow", "shared")],
                         ids=["flow", "multiflow-shared"])
def test_port_dir_round_trip_is_bitwise(tmp_path, extra):
    _, tm, _ = _pair(extra)
    path = str(tmp_path / "model")
    tm.save_checkpoint(path, step=7)
    assert sorted(os.listdir(path)) == ["config.json", "params_7.pt"]
    assert sorted(os.listdir(tmp_path)) == ["model"]     # no temporary left
    back = TModel.from_checkpoint(path, device="cpu")
    assert back.cfg == tm.cfg
    sd, sd_back = tm.module.state_dict(), back.module.state_dict()
    assert list(sd) == list(sd_back)
    for k in sd:
        assert torch.equal(sd[k], sd_back[k]), k
    t = 3 if extra else 1
    seq, src, tgt = _inputs(t, seed=1)
    a = tm.predict(seq, tgt, source_poses=src, return_aux=True)
    b = back.predict(seq, tgt, source_poses=src, return_aux=True)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # the JAX package reads the port's config.json
    with open(os.path.join(path, "config.json")) as f:
        meta = json.load(f)
    assert meta["step"] == 7
    assert jconfig.to_dict(jconfig.from_dict(meta["config"])) \
        == tconfig.to_dict(tm.cfg)


def test_save_model_replaces_a_dir_and_takes_a_state_dict(tmp_path):
    _, tm, _ = _pair()
    path = str(tmp_path / "model")
    tm.save_checkpoint(path, step=1)
    sd = {k: v + 1 for k, v in tm.module.state_dict().items()}
    tckpt.save_model(path, sd, tm.cfg, step=2)
    assert sorted(os.listdir(path)) == ["config.json", "params_2.pt"]
    assert sorted(os.listdir(tmp_path)) == ["model"]
    weights, cfg, step = tckpt.load_model(path)
    assert step == 2 and cfg == tm.cfg
    for k in sd:
        assert torch.equal(weights[k], sd[k]), k


def test_baked_heads_take_t_from_the_weights(tmp_path):
    """A baked T = 3 model saved under a config that says seq_len = 1 comes
    back with T = 3 heads, as ``from_flax_params`` does for flax trees."""
    _, tm, _ = _pair(_multi("multiflow", "baked"))
    cfg = tconfig.override(tm.cfg, ["data.seq_len=1"])
    TModel(cfg, tm.module).save_checkpoint(str(tmp_path / "m"))
    back = TModel.from_checkpoint(str(tmp_path / "m"), device="cpu")
    assert back.module.num_sources == 3


def test_missing_weights_raise(tmp_path):
    _, tm, _ = _pair()
    tm.save_checkpoint(str(tmp_path / "m"), step=3)
    os.remove(tmp_path / "m" / "params_3.pt")
    with pytest.raises(FileNotFoundError, match="params_3"):
        tckpt.load_model(str(tmp_path / "m"))


# --------------------------------------------------------------- the manager
def _tiny_state():
    module = torch.nn.Linear(2, 2)
    return tstep.TrainState(module, torch.optim.Adam(module.parameters()))


# (max_to_keep, save_interval_steps, [(step, force), ...])
MANAGER_CASES = {
    "first-save-whatever-the-interval": (3, 1000, [(s, False)
                                                   for s in range(1, 9)]),
    "interval-4": (3, 4, [(s, False) for s in range(1, 14)]),
    "forced-between": (2, 2, [(1, False), (2, False), (3, True), (4, False),
                              (5, False), (7, True), (8, False), (9, False),
                              (10, False)]),
    "from-step-0-keep-all": (None, 3, [(s, False) for s in range(0, 10)]),
    "keep-1": (1, 1, [(s, False) for s in range(1, 6)]),
    "resume-replays": (3, 2, [(1, False), (2, False), (2, False), (3, False),
                              (4, False), (1, False)]),
}


@pytest.mark.parametrize("case", sorted(MANAGER_CASES))
def test_manager_keeps_orbax_steps(tmp_path, case):
    keep, interval, saves = MANAGER_CASES[case]
    ref = ocp.CheckpointManager(
        str(tmp_path / "orbax"), options=ocp.CheckpointManagerOptions(
            max_to_keep=keep, save_interval_steps=interval, create=True))
    ours = tckpt.make_manager(str(tmp_path / "port"), keep, interval)
    state = _tiny_state()
    tree = {"w": np.zeros(2, np.float32)}
    try:
        for step, force in saves:
            saved_ref = ref.save(step, args=ocp.args.StandardSave(tree),
                                 force=force)
            ref.wait_until_finished()
            saved = ours.save(step, state, force=force)
            assert saved == saved_ref, (step, force)
            assert ours.all_steps() == list(ref.all_steps()), step
            assert ours.latest_step() == ref.latest_step()
    finally:
        ref.close()


def test_manager_refuses_an_existing_step_as_orbax_does(tmp_path):
    ref = ocp.CheckpointManager(str(tmp_path / "orbax"))
    ours = tckpt.make_manager(str(tmp_path / "port"))
    try:
        ref.save(1, args=ocp.args.StandardSave({"w": np.zeros(1)}))
        ref.wait_until_finished()
        with pytest.raises(ValueError, match="already exists"):
            ref.save(1, args=ocp.args.StandardSave({"w": np.zeros(1)}),
                     force=True)
    finally:
        ref.close()
    ours.save(1, _tiny_state())
    with pytest.raises(FileExistsError, match="already exists"):
        ours.save(1, _tiny_state(), force=True)


def test_manager_restores_bitwise_and_drops_partial_saves(tmp_path):
    state = _tiny_state()
    x = torch.randn(4, 2, generator=torch.Generator().manual_seed(0))
    for _ in range(2):
        state.optimizer.zero_grad()
        state.module(x).square().sum().backward()
        state.optimizer.step()
    state.step = 2
    mgr = tckpt.make_manager(str(tmp_path), 3, 1)
    mgr.save(2, state)
    os.makedirs(tmp_path / "3.tmp-1")                    # a save cut short
    mgr = tckpt.make_manager(str(tmp_path), 3, 1)
    assert sorted(os.listdir(tmp_path)) == ["2"]
    back = mgr.restore(mgr.latest_step(), _tiny_state())
    assert back.step == 2
    for p, q in zip(state.module.parameters(), back.module.parameters()):
        assert torch.equal(p, q)
    for p, q in zip(state.module.parameters(), back.module.parameters()):
        a, b = state.optimizer.state[p], back.optimizer.state[q]
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a[k], b[k]), k
