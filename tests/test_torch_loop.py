"""The port's training loop (train/loop.py) and cli.snapshot on the CPU,
mirroring tests/test_train.py's loop, resume, EMA and snapshot cases.

Exact resume is bitwise: a run killed by ``train.fail_after_step`` and
resumed ends with the same params, Adam moments and EMA as an
uninterrupted one. The batch function draws the same example indices per
step as the JAX package's ``_make_batch_fn`` (a recording source, which
compares the indices themselves).
"""

import json

import numpy as np
import pytest
import torch

from dynamic_multiview_3d_torch import config as tconfig
from dynamic_multiview_3d_torch.api import Model as TModel
from dynamic_multiview_3d_torch.cli import snapshot as snapshot_cli
from dynamic_multiview_3d_torch.train import checkpoint as tckpt
from dynamic_multiview_3d_torch.train import loop as tloop
from dynamic_multiview_3d_torch.train import metrics as tmetrics
from dynamic_multiview_3d_tpu import config as jconfig
from dynamic_multiview_3d_tpu.train import loop as jloop

TINY = ["model.image_size=32", "model.num_levels=3", "model.base_features=8",
        "model.max_features=16", "model.gru_features=16",
        "model.pose_embed_dim=8", "model.dtype=float32",
        "model.use_pallas=False",
        "data.image_size=32", "data.batch_size=4", "data.num_scenes=2",
        "train.lr=1e-3", "train.num_steps=3", "train.log_every=1",
        "train.ckpt_every=1", "mesh.data=1"]


def tiny_cfg(ckpt_dir, *extra):
    return tconfig.get_config("default", TINY + [f"train.ckpt_dir={ckpt_dir}",
                                                 *extra])


def _assert_same_state(a, b):
    assert a.step == b.step
    pa, pb = dict(a.module.named_parameters()), dict(b.module.named_parameters())
    for name in pa:
        assert torch.equal(pa[name], pb[name]), name
        sa, sb = a.optimizer.state[pa[name]], b.optimizer.state[pb[name]]
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[k], sb[k]), (name, k)
    assert (a.ema is None) == (b.ema is None)
    for name in a.ema or {}:
        assert torch.equal(a.ema[name], b.ema[name]), name


def test_train_loop_runs_and_checkpoints(tmp_path):
    cfg = tiny_cfg(tmp_path / "ckpt")
    assert cfg.data.device_resident == "auto"          # resolves to off
    writer = tmetrics.MetricsWriter(str(tmp_path / "logs"),
                                    use_tensorboard=False)
    try:
        state, metrics = tloop.train(cfg, writer=writer, device="cpu")
    finally:
        writer.close()
    assert state.step == 3
    assert "loss/total" in metrics and metrics["steps_per_sec"] > 0
    assert metrics["host_rss_mb"] > 0
    mgr = tckpt.make_manager(str(tmp_path / "ckpt"))
    assert mgr.latest_step() == 3 and mgr.all_steps() == [1, 2, 3]
    with open(tmp_path / "ckpt" / "train_config.json") as f:
        assert tconfig.from_dict(json.load(f)) == cfg
    with open(tmp_path / "ckpt" / "model" / "config.json") as f:
        assert json.load(f)["step"] == 3
    lines = (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [1, 2, 3]
    assert all(np.isfinite(json.loads(x)["loss/total"]) for x in lines)


@pytest.mark.parametrize("extra", [
    (),
    ("train.steps_per_dispatch=2", "train.ckpt_every=2", "train.log_every=2"),
    ("train.ema_decay=0.9", "train.lr_schedule=cosine",
     "train.warmup_steps=1", "data.num_targets=3",
     "data.targets_per_step=2"),
], ids=["plain", "steps-per-dispatch-2", "ema-cosine-subsampled"])
def test_fault_injection_and_exact_resume(tmp_path, extra):
    """Kill training after step 1; resuming replays to the identical state
    (params, Adam moments, EMA, bit for bit) of an uninterrupted run."""
    state_a, _ = tloop.train(
        tiny_cfg(tmp_path / "a", "train.num_steps=4", *extra), device="cpu")

    cfg_b = tiny_cfg(tmp_path / "b", "train.num_steps=4", *extra)
    with pytest.raises(tloop.FaultInjected):
        tloop.train(tconfig.override(cfg_b, ["train.fail_after_step=1"]),
                    device="cpu")
    assert tckpt.make_manager(str(tmp_path / "b")).latest_step() == 2
    state_b, _ = tloop.train(cfg_b, device="cpu")
    assert state_b.step == 4
    _assert_same_state(state_a, state_b)


def test_steps_per_dispatch_takes_the_same_steps(tmp_path):
    """Two steps a dispatch take the batches and updates of two dispatches
    of one step."""
    one, _ = tloop.train(tiny_cfg(tmp_path / "one", "train.num_steps=4"),
                         device="cpu")
    two, _ = tloop.train(tiny_cfg(tmp_path / "two", "train.num_steps=4",
                                  "train.steps_per_dispatch=2",
                                  "train.ckpt_every=2", "train.log_every=2"),
                         device="cpu")
    _assert_same_state(one, two)


def test_resume_at_a_misaligned_step_raises(tmp_path):
    tloop.train(tiny_cfg(tmp_path, "train.num_steps=1"), device="cpu")
    with pytest.raises(ValueError, match="not aligned"):
        tloop.train(tiny_cfg(tmp_path, "train.num_steps=4",
                             "train.steps_per_dispatch=2",
                             "train.ckpt_every=2", "train.log_every=2"),
                    device="cpu")


@pytest.mark.parametrize("extra,match", [
    (("train.steps_per_dispatch=2",), "num_steps"),
    (("train.steps_per_dispatch=2", "train.num_steps=4"), "ckpt_every"),
    (("train.steps_per_dispatch=2", "train.num_steps=4",
      "train.ckpt_every=2", "train.log_every=2",
      "train.fail_after_step=2"), "fail_after_step"),
])
def test_dispatch_alignment_is_checked(tmp_path, extra, match):
    with pytest.raises(ValueError, match=match):
        tloop.train(tiny_cfg(tmp_path, *extra), device="cpu")


@pytest.mark.parametrize("extra,error,match", [
    # the JAX package's refusals (train/loop.py: streaming with a
    # resident mode; device sampling with nothing resident)
    (("data.streaming=true", "data.device_resident=on"), ValueError,
     "streaming"),
    (("data.streaming=true", "data.device_sampling=true"), ValueError,
     "streaming"),
    (("data.device_sampling=true",), ValueError, "device_sampling"),
    # a 'model' axis, like a data axis, needs one process per rank: it is
    # never run replicated; scene-sharded banks need device sampling (the
    # JAX package's refusal)
    (("mesh.model=2",), RuntimeError, "torch.distributed.run"),
    (("mesh.data=2", "mesh.model=2"), RuntimeError, "torch.distributed.run"),
    (("mesh.multihost=true", "mesh.model=2"), RuntimeError,
     "torch.distributed.run"),
    (("mesh.data=2",), RuntimeError, "torch.distributed.run"),
    (("data.resident_sharding=scenes",), ValueError, "device_sampling"),
])
def test_unported_branches_name_their_item(tmp_path, extra, error, match):
    with pytest.raises(error, match=match):
        tloop.train(tiny_cfg(tmp_path, *extra), device="cpu")


def test_default_device_is_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device would train")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tloop.train(tiny_cfg(tmp_path))


def test_ema_params_track_and_export(tmp_path):
    """train.ema_decay: the state carries an EMA of the params that moves
    slower than the raw params; the exported model dir carries the EMA."""
    cfg = tiny_cfg(tmp_path, "train.ema_decay=0.9", "train.num_steps=6",
                   "train.ckpt_every=6", "train.log_every=6")
    p0 = {n: p.detach().clone() for n, p in
          TModel.init_random(cfg, seed=cfg.train.seed, device="cpu")
          .module.named_parameters()}
    state, _ = tloop.train(cfg, device="cpu")
    p = {n: q.detach() for n, q in state.module.named_parameters()}

    def dist(a):
        return float(sum((a[n] - p0[n]).abs().sum() for n in p0))

    assert 0 < dist(state.ema) < dist(p)      # the EMA lags, but moves
    exported, _, step = tckpt.load_model(str(tmp_path / "model"))
    assert step == 6
    for n in p0:
        assert torch.equal(exported[n], state.ema[n]), n


def test_snapshot_cli_exports_intermediate_step(tmp_path, capsys):
    """A run cut short of num_steps is still exportable: cli.snapshot
    turns a manager step and train_config.json into a model dir."""
    cfg = tiny_cfg(tmp_path / "ckpt", "train.num_steps=4",
                   "train.fail_after_step=1")        # dies after step 2's ckpt
    with pytest.raises(tloop.FaultInjected):
        tloop.train(cfg, device="cpu")
    assert not (tmp_path / "ckpt" / "model").exists()   # no end-of-run export

    out = tmp_path / "snap"
    snapshot_cli.main(["--ckpt-dir", str(tmp_path / "ckpt"),
                       "--out", str(out)])
    assert json.loads(capsys.readouterr().out) == {
        "out": str(out), "step": 2, "ema": False}
    with open(out / "config.json") as f:
        assert json.load(f)["step"] == 2
    saved = tckpt.read_step(str(tmp_path / "ckpt"), 2)
    model = TModel.from_checkpoint(str(out), device="cpu")
    for k, v in model.module.state_dict().items():
        assert torch.equal(v, saved["module"][k]), k
    views = model.predict(
        np.zeros((1, 32, 32, 3), np.float32), np.zeros((1, 3), np.float32))
    assert views.shape == (1, 32, 32, 3)

    snapshot_cli.main(["--ckpt-dir", str(tmp_path / "ckpt"),
                       "--out", str(tmp_path / "snap1"), "--step", "1"])
    assert json.loads(capsys.readouterr().out)["step"] == 1


def test_profile_window_writes_a_trace(tmp_path):
    tloop.train(tiny_cfg(tmp_path / "ckpt"), profile_dir=str(tmp_path / "tr"),
                profile_steps=(1, 2), device="cpu")
    assert [p.name for p in (tmp_path / "tr").iterdir()] == \
        ["trace_steps_1-2.json"]


class _Recorder:
    """A data source that records the indices of every batch it serves."""

    def __init__(self):
        self.calls = []

    def batch(self, indices, raw=False):
        idx = list(indices)
        self.calls.append((idx, raw))
        return {"image_seq": np.asarray(idx, np.float32)[:, None]}


@pytest.mark.parametrize("spd", [1, 2])
def test_batch_fn_draws_the_jax_indices(spd):
    over = ["data.batch_size=3", f"train.steps_per_dispatch={spd}"]
    jcfg = jconfig.override(jconfig.Config(), over)
    tcfg = tconfig.override(tconfig.Config(), over)
    ref, ours = _Recorder(), _Recorder()
    jfn = jloop._make_batch_fn(jcfg, ref, steps_per_dispatch=spd)
    tfn = tloop._make_batch_fn(tcfg, ours, steps_per_dispatch=spd)
    for step in (0, spd, 5 * spd):
        a, b = jfn(step), tfn(step)
        np.testing.assert_array_equal(a["image_seq"], b["image_seq"])
    assert ours.calls == ref.calls
    assert ours.calls[-1][0] == list(range(15 * spd + 3 * (spd - 1),
                                           15 * spd + 3 * spd))
