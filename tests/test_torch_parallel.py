"""Data parallelism in the port (parallel/mesh.py, the train step's
``mesh``, the loop, scene-sharded banks, serving over a mesh, the dry run)
on the CPU. Every multi-process test spawns 2 ranks joined over gloo on a
free port (``parallel.dryrun.spawn``: the group's init timeout and the
join timeout are 60 s), running the functions of
tests/_torch_parallel_ranks.py.

Tolerances. The 2-rank step on B/2 rows each against the one-process
step on the global batch B, with targets subsampled: loss 1e-6 relative,
every gradient 1e-5 in relative L2 (the two whose true gradient is zero,
``ZERO_GRAD`` of tests/test_torch_train.py: 1e-6 of the global norm); the
ranks' params bitwise equal after 3 steps. The 2-rank step against the
JAX package's ``shard_map`` step over 2 virtual CPU devices on the same
weights and batch (``targets_per_step=0``: the two frameworks' random
streams differ): loss 1e-5, gradients 1e-4, as tests/test_torch_train.py
holds one step to ``jax.grad``. The JAX step is SGD with lr 1, so its
gradients are the params' change. Its batch is drawn from seed 4, that
test's: on some batches (seeds 0, 3 and 6 of ``_batch(rng, b=4, k=3)``)
a ReLU input sits within f32 noise of 0, and there JAX's own
single-device and shard_map gradients differ by ~1e-2 in a few tensors.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_multiview_3d_torch import config as tconfig
from dynamic_multiview_3d_torch import serving, weights
from dynamic_multiview_3d_torch.api import Model as TModel
from dynamic_multiview_3d_torch.data import pipeline as tpipeline
from dynamic_multiview_3d_torch.data import resident as tresident
from dynamic_multiview_3d_torch.data.synthetic import (random_poses,
                                                       smooth_images)
from dynamic_multiview_3d_torch.parallel import dryrun as tdryrun
from dynamic_multiview_3d_torch.parallel import mesh as tmesh
from dynamic_multiview_3d_torch.train import loop as tloop
from dynamic_multiview_3d_torch.train import step as tstep
from dynamic_multiview_3d_torch.utils import jax_random as jr
from dynamic_multiview_3d_tpu import config as jconfig
from dynamic_multiview_3d_tpu.parallel import mesh as jmesh
from dynamic_multiview_3d_tpu.train import step as jstep
import _torch_parallel_ranks as ranks
from test_torch_train import (ZERO_GRAD, _assert_grads_close, _batch,
                              _configs, _flat, _rel)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TIMEOUT = 60.0


def _spawn(fn, *args):
    return tdryrun.spawn(fn, 2, args, timeout_s=TIMEOUT)


def _flax_grads(named: dict) -> dict:
    return _flat(weights.to_flax({n: torch.as_tensor(g)
                                  for n, g in named.items()}))


def _state_dict(cfg):
    state = tstep.init_state(cfg, seed=7, device="cpu")
    return {k: v.numpy().copy() for k, v in state.module.state_dict().items()}


# ------------------------------------------------------------ offset draws
def test_preprocess_offsets_concatenate_to_the_global_draw():
    """Two shards' target subsets, each drawn from its global offset,
    concatenated, are the one-shard draw of the global batch, exactly."""
    batch = _batch(np.random.default_rng(0), b=6, k=5)
    kw = dict(device="cpu", key=jr.step_keys(3, 9, False)[0],
              targets_per_step=2)
    whole = tpipeline.preprocess(batch, **kw)
    mesh = [tmesh.Mesh(r, 2, CPU) for r in range(2)]
    parts = [tpipeline.preprocess(
        tmesh.shard_batch(m, batch), index_offset=3 * m.rank, **kw)
        for m in mesh]
    for k in ("tgt_poses", "tgt_images"):
        assert torch.equal(torch.cat([p[k] for p in parts]), whole[k]), k
    # offset 0 is the default: every draw before data parallelism
    assert torch.equal(tpipeline.preprocess(batch, index_offset=0,
                                            **kw)["tgt_poses"],
                       whole["tgt_poses"])
    local = tpipeline.preprocess(tmesh.shard_batch(mesh[1], batch), **kw)
    assert not torch.equal(local["tgt_poses"], parts[1]["tgt_poses"])


def test_device_draw_offsets_concatenate_to_the_global_draw():
    from test_torch_resident import META, PINNED
    draw = tresident.ResidentFrames.device_draw
    key = jr.step_keys(7, 11, True)[1]
    whole = draw(META, key, 8, "cpu")
    parts = [draw(META, key, 4, "cpu", index_offset=4 * r)
             for r in range(2)]
    for k in whole:
        assert torch.equal(torch.cat([p[k] for p in parts]), whole[k]), k
    # offset 0 keeps the table pinned by tests/test_torch_resident.py
    idx = draw(META, key, 3, "cpu", index_offset=0)
    for k, want in PINNED.items():
        assert idx[k].tolist() == want, k


def test_shard_batch_and_local_rows():
    batch = {"a": np.arange(12).reshape(6, 2), "b": torch.arange(6)}
    got = tmesh.shard_batch(tmesh.Mesh(2, 3, CPU), batch)
    assert got["a"].tolist() == [[8, 9], [10, 11]]
    assert got["b"].tolist() == [4, 5]
    spd = tmesh.shard_batch(tmesh.Mesh(1, 2, CPU),
                            {"a": np.arange(8).reshape(2, 4)}, axis=1)
    assert spd["a"].tolist() == [[2, 3], [6, 7]]
    with pytest.raises(ValueError, match="divisible"):
        tmesh.local_rows(tmesh.Mesh(0, 4, CPU), 6)
    one = tmesh.make_mesh(tconfig.MeshConfig(), device="cpu")
    assert (one.rank, one.world_size, one.backend) == (0, 1, None)
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        tmesh.make_mesh(tconfig.MeshConfig(data=3), device="cpu")


# ------------------------------------------------------------ the step
def _one_process(cfg, sd, batches, steps, resident=None):
    state = tstep.init_state(cfg, device="cpu")
    state.module.load_state_dict({k: torch.as_tensor(v)
                                  for k, v in sd.items()})
    step = tstep.make_train_step(cfg, device="cpu", resident=resident)
    first = None
    for i in range(steps):
        state, m = step(state, None if batches is None else batches[i])
        if first is None:
            first = (m, {n: p.grad.numpy().copy()
                         for n, p in state.module.named_parameters()})
    return first


@pytest.mark.parametrize("data", ["host", "device_sampling"])
def test_two_rank_step_equals_one_process_step(data, tmp_path):
    """2 ranks on B/2 rows each against one process on the global B, with
    4 targets an example subsampled to 2 (host batches), or drawn on the
    device from a replicated bank: loss, gradients, and the ranks' params
    bitwise equal after 3 steps."""
    extra = ["data.batch_size=4", "data.num_targets=4",
             "data.targets_per_step=2", "train.lr=1e-3"]
    batches, resident = None, None
    if data == "host":
        rng = np.random.default_rng(5)
        batches = [_batch(rng, b=4, k=4) for _ in range(3)]
    else:
        from dynamic_multiview_3d_torch.data import frames
        root = frames.export_synthetic(str(tmp_path / "ds"), num_scenes=2,
                                       image_size=32, num_views=4,
                                       seq_len=1, fmt="packed")
        extra += ["data.source=frames", f"data.root={root}",
                  "data.device_sampling=true", "data.seq_len=1"]
    _, cfg = _configs(extra)
    sd = _state_dict(cfg)
    if data != "host":
        resident = tloop._maybe_resident(
            cfg, tpipeline.make_source(cfg.data), tmesh.Mesh(device=CPU))
    metrics, grads = _one_process(cfg, sd, batches, 1, resident)
    out = _spawn(ranks.step_rank, tconfig.to_dict(cfg), sd, batches, 3)
    for r in out:
        for k in metrics:
            assert _rel(r["metrics"][k], metrics[k]) <= 1e-6, k
        ours, ref = _flax_grads(r["grads"]), _flax_grads(grads)
        norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                           for g in ref.values()))
        for k, g in ref.items():
            err = float(np.linalg.norm((ours[k] - g).ravel()))
            lim = 1e-6 * norm if k in ZERO_GRAD else \
                1e-5 * float(np.linalg.norm(g.ravel()))
            assert err <= lim, (k, err, lim)
    for n, p in out[0]["params"].items():
        assert np.array_equal(p, out[1]["params"][n]), n
    assert any(not np.array_equal(p, sd[n])
               for n, p in out[0]["params"].items())


def test_two_rank_step_matches_jax_shard_map():
    """The port's 2-rank step against the JAX package's shard_map step
    over 2 virtual CPU devices: same weights, same global batch."""
    jcfg, cfg = _configs(["data.batch_size=4", "train.optimizer=sgd",
                          "train.lr=1.0", "mesh.data=2"])
    sd = _state_dict(cfg)
    batch = _batch(np.random.default_rng(4), b=4, k=3)
    params = weights.to_flax({k: torch.as_tensor(v) for k, v in sd.items()})
    mesh = jmesh.make_mesh(jconfig.MeshConfig(data=2, model=1),
                           devices=jax.devices()[:2])
    state = jstep.init_state(jcfg)
    state = jax.device_put(
        state.replace(params=jax.tree.map(jnp.asarray, params)),
        jmesh.replicate(mesh))
    p0 = {k: np.asarray(v) for k, v in _flat(state.params).items()}
    step = jstep.make_train_step(jcfg, mesh=mesh, mode="shard_map")
    state, jm = step(state, jmesh.shard_batch(mesh, batch))
    ref = {k: p0[k] - np.asarray(v)                 # SGD, lr 1: the grads
           for k, v in _flat(state.params).items()}
    out = _spawn(ranks.step_rank, tconfig.to_dict(cfg), sd, [batch], 1)
    for r in out:
        assert _rel(r["metrics"]["loss/total"], jm["loss/total"]) <= 1e-5
        _assert_grads_close(_flax_grads(r["grads"]), ref)


# ------------------------------------------------------ scene-sharded banks
def test_scene_sharded_banks_hold_their_own_scenes():
    """Through the loop's ``_maybe_resident`` on 2 ranks, the c3md data
    settings at a tiny size (SyntheticFrames materialized, device
    sampling): each rank materializes and holds its contiguous half of
    the scenes, equal to the whole bank's rows, and draws within it; a
    scene count the ranks do not divide raises."""
    _, cfg = _configs(["data.source=frames", "data.root=",
                       "data.num_scenes=4", "data.seq_len=2",
                       "data.num_targets=2", "data.batch_size=4",
                       "data.materialize_packed=true",
                       "data.device_sampling=true",
                       "data.resident_sharding=scenes"])
    with pytest.warns(UserWarning, match="SyntheticFrames"):
        src = tpipeline.make_source(cfg.data)
    src.materialize_packed()
    whole = tresident.ResidentFrames(src, cfg.data, device="cpu")
    out = _spawn(ranks.bank_rank, tconfig.to_dict(cfg))
    rows = whole.num_views * whole.t_avail
    for r, got in enumerate(out):
        assert (got["num_scenes"], got["scene_offset"]) == (2, 2 * r)
        assert got["materialized"] == src.scenes[2 * r:2 * r + 2]
        assert got["nbytes"] == whole.nbytes // 2
        np.testing.assert_array_equal(
            got["frames"], whole.frames[2 * r * rows:(2 * r + 2) * rows])
        np.testing.assert_array_equal(
            got["poses"], whole.poses[2 * r * whole.num_views:
                                      (2 * r + 2) * whole.num_views])
        assert got["rows"]["seq_idx"].max() < 2 * rows
        assert got["rows"]["src_pose_idx"].max() < 2 * whole.num_views
    odd = tconfig.override(cfg, ["data.num_scenes=3"])
    with pytest.raises(ValueError, match="divisible"):
        tresident.shard_scenes(tpipeline.make_source(odd.data), 2, 0)


# ------------------------------------------------------------ the loop
@pytest.mark.parametrize("data", ["host", "stream"])
def test_two_rank_loop_resumes_exactly_and_only_rank_0_writes(tmp_path,
                                                              data):
    """A 2-rank ``loop.train`` of 4 steps against 2 ranks killed after
    step 2 and resumed, on host batches or streamed (each rank its rows of
    the stream's batch): the final params bitwise equal on both ranks and
    both runs; rank 0 alone writes the config, the manager's steps, the
    model dir, the metrics and the stream's state."""
    base = ["data.batch_size=4", "data.num_scenes=2", "train.num_steps=4",
            "train.ckpt_every=2", "train.log_every=1", "mesh.data=2"]
    if data == "stream":
        base += ["data.streaming=true", "data.grain_workers=0"]
    from test_torch_loop import TINY
    straight = tconfig.get_config("default", [
        *TINY, *base, f"train.ckpt_dir={tmp_path / 'a'}"])
    runs = _spawn(ranks.loop_rank, tconfig.to_dict(straight),
                  str(tmp_path / "logs_a"))
    killed = tconfig.override(straight, [f"train.ckpt_dir={tmp_path / 'b'}",
                                         "train.fail_after_step=1"])
    assert _spawn(ranks.loop_rank, tconfig.to_dict(killed),
                  str(tmp_path / "logs_b")) == ["killed", "killed"]
    streams = {"host": [], "stream": [
        f"grain_state_{k}_p0.json" for k in (1, 2, 4)]}
    assert sorted(os.listdir(tmp_path / "b")) == sorted(
        ["1", "2", "train_config.json"] + streams[data][:2])
    resumed = _spawn(ranks.loop_rank, tconfig.to_dict(
        tconfig.override(killed, ["train.fail_after_step=-1"])),
        str(tmp_path / "logs_b"))
    for n, p in runs[0].items():
        for other in (runs[1], resumed[0], resumed[1]):
            assert np.array_equal(p, other[n]), n
    assert sorted(os.listdir(tmp_path / "a")) == sorted(
        ["1", "2", "4", "model", "train_config.json"] + streams[data])
    for logs in ("logs_a", "logs_b"):
        with open(tmp_path / logs / "r1" / "metrics.jsonl") as f:
            assert f.read() == ""
        with open(tmp_path / logs / "r0" / "metrics.jsonl") as f:
            assert len(f.read().splitlines()) >= 2


# ------------------------------------------------------------ serving
def test_mesh_serving_on_two_ranks_equals_the_unsharded_request(tmp_path):
    """``predict(mesh=)`` on 2 ranks, 2 rows of a B = 4 request each: the
    ranks' gathered views are bitwise equal to each other and to the
    one-process served program run on rows [0:2] and [2:4] and
    concatenated, and within 1e-5 absolute of the one-process 4-row
    request. Not bitwise there: PyTorch's CPU convolutions (oneDNN) round
    differently at another batch size (3.44e-6 measured)."""
    cfg = tconfig.override(tconfig.Config(), [
        "model.image_size=32", "model.num_levels=3",
        "model.base_features=8", "model.max_features=16",
        "model.gru_features=16", "model.pose_embed_dim=8",
        "model.dtype=float32", "model.warp_precision=exact",
        "data.image_size=32", "data.seq_len=1", "data.num_targets=2"])
    model = TModel.init_random(cfg, seed=0, device="cpu")
    path = str(tmp_path / "flow.dmv3d")
    serving.export_predict(model, path, batch=4, num_targets=2)
    rng = np.random.default_rng(8)
    seq, src, tgt = (smooth_images(rng, 4, 1, 32), random_poses(rng, 4, 1),
                     random_poses(rng, 4, 2))
    served = serving.ServedModel.load(path, device="cpu")
    want = served.predict(seq, tgt, source_poses=src).numpy()
    args = [torch.as_tensor(a) for a in (seq, src, tgt)]
    with torch.inference_mode():
        blocks = torch.cat([served.call_for()(
            served.params, *(a[lo:lo + 2] for a in args))
            for lo in (0, 2)]).numpy()
    out = _spawn(ranks.serve_rank, path, seq, src, tgt)
    np.testing.assert_array_equal(out[0], out[1])
    for got in out:
        assert got.shape == (4, 2, 32, 32, 3)
        np.testing.assert_array_equal(got, blocks)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ------------------------------------------------------------ the rest
def test_dryrun_multichip_two_ranks():
    losses = tdryrun.dryrun_multichip(2, timeout_s=TIMEOUT)
    assert set(losses[0]) == {"1", "3", "4", "4b"}


BENCH_TINY = ["model.image_size=32", "data.image_size=32",
              "model.num_levels=3", "model.base_features=8",
              "model.max_features=16", "model.gru_features=16",
              "model.pose_embed_dim=8", "data.batch_size=2",
              "data.num_targets=2"]


def test_bench_torch_prints_one_json_line():
    """bench_torch.py --device cpu at a tiny size prints one JSON line
    with bench.py's four keys; without a card and without --device cpu it
    raises."""
    argv = [sys.executable, os.path.join(REPO, "bench_torch.py"),
            "--iters", "2", "--warmup", "1"]
    for o in BENCH_TINY:
        argv += ["--set", o]
    run = subprocess.run(argv + ["--device", "cpu"], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert run.returncode == 0, run.stderr[-2000:]
    lines = run.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == "novel_views_per_sec_per_chip_128px"
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["value"] > 0 and line["unit"] == "views/s"
    if not torch.cuda.is_available():
        run = subprocess.run(argv, capture_output=True, text=True,
                             timeout=120, cwd=REPO)
        assert run.returncode != 0 and "no CUDA device" in run.stderr
        assert run.stdout == ""
