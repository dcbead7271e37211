"""The 'model' mesh axis in the port (parallel/mesh.py ``make_mesh``,
``model_axis_rules``; parallel/tensor.py; the train step, the loop,
serving and the dry run on a (data, model) mesh) on the CPU, against the
JAX package's rule and ``mode="auto"`` step and against one process. The
multi-process tests spawn gloo ranks (``parallel.dryrun.spawn``, 60 s
join timeout) running the functions of tests/_torch_parallel_ranks.py.

Tolerances (f32):
- a split Conv / Dense against the whole layer: output, dx, the gathered
  dW and db within 1e-6 of each one's largest magnitude (the same sums in
  other orders: oneDNN blocks 4 output channels otherwise than 8, and the
  bias is added after the conv; 2.7e-7 measured);
- the (2, 2) and (1, 2) steps against one process on the global batch,
  as tests/test_torch_parallel.py holds the data axis: loss 1e-6
  relative, every gathered gradient 1e-5 in relative L2 (``ZERO_GRAD``:
  1e-6 of the global norm); after 3 steps every replicated param and EMA
  entry bitwise equal on every rank and each block bitwise equal between
  its data ranks;
- the (2, 2) step against the JAX package's ``mode="auto"`` step with
  ``model_axis_rules(min_size=16)`` on a (2, 2) mesh of virtual CPU
  devices (SGD, lr 1, so its gradients are the params' change; the
  seed-4 batch of that file's shard_map test): loss 1e-5, gradients 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_multiview_3d_torch import config as tconfig
from dynamic_multiview_3d_torch import serving, weights
from dynamic_multiview_3d_torch.api import Model as TModel
from dynamic_multiview_3d_torch.data.synthetic import (random_poses,
                                                       smooth_images)
from dynamic_multiview_3d_torch.parallel import dryrun as tdryrun
from dynamic_multiview_3d_torch.parallel import mesh as tmesh
from dynamic_multiview_3d_torch.train import checkpoint as tckpt
from dynamic_multiview_3d_torch.train import loop as tloop
from dynamic_multiview_3d_torch.train import step as tstep
from dynamic_multiview_3d_tpu import config as jconfig
from dynamic_multiview_3d_tpu.models import DMV3D as JDMV3D
from dynamic_multiview_3d_tpu.parallel import mesh as jmesh
from dynamic_multiview_3d_tpu.train import step as jstep
import _torch_parallel_ranks as ranks
from test_torch_parallel import _flax_grads, _one_process, _state_dict
from test_torch_train import (ZERO_GRAD, _assert_grads_close, _batch,
                              _configs, _flat, _rel)

CPU = torch.device("cpu")
TIMEOUT = 60.0


def _spawn(fn, world, model, *args):
    return tdryrun.spawn(fn, world, args, timeout_s=TIMEOUT, model=model)


# ------------------------------------------------------------ the rule
TINY = ["model.image_size=32", "model.num_levels=3", "model.base_features=8",
        "model.max_features=16", "model.gru_features=16",
        "model.pose_embed_dim=8", "data.image_size=32"]


@pytest.mark.parametrize("preset,extra,min_size,model,count", [
    ("c2", [], 128, 2, 23),        # 13,115,392 of 13,284,966 params
    ("default", TINY, 16, 2, 17),
    ("default", TINY, 2, 3, 1),    # only the 6-channel heads divide by 3
])
def test_model_axis_rules_pick_the_jax_rules_leaves(preset, extra, min_size,
                                                    model, count):
    """The port's rule names exactly the torch parameters of the flax
    leaves the JAX rule places on 'model' (on ``jax.eval_shape`` params)."""
    jcfg = jconfig.get_config(preset, extra)
    m = jcfg.model
    params = jax.eval_shape(lambda k: JDMV3D(m).init(
        k, jnp.zeros((1, jcfg.data.seq_len, m.image_size, m.image_size, 3)),
        jnp.zeros((1, jcfg.data.seq_len, 3)),
        jnp.zeros((1, jcfg.data.num_targets, 3)))["params"],
        jax.random.key(0))
    mesh = jmesh.make_mesh(jconfig.MeshConfig(data=1, model=model),
                           devices=jax.devices()[:model])
    rules = jmesh.model_axis_rules(params, mesh, min_size=min_size)
    want = {".".join(k.key for k in path).replace(".kernel", ".weight")
            for path, sh in jax.tree_util.tree_flatten_with_path(rules)[0]
            if "model" in sh.spec}
    cfg = tconfig.get_config(preset, extra)
    module = tstep.init_state(cfg, device="cpu").module
    got = tmesh.model_axis_rules(
        module, tmesh.Mesh(0, model, CPU, model_size=model), min_size)
    assert got == want and len(got) == count
    assert tmesh.model_axis_rules(module, tmesh.Mesh(), min_size) == set()


# ------------------------------------------------------------ the mesh
def test_make_mesh_lays_ranks_out_as_jax_and_refuses_the_rest():
    """4 ranks on a (2, 2) mesh: global rank = data_rank * 2 + model_rank
    (``jax.make_mesh``'s row-major order), each rank's groups, its rows of
    a global batch of 8 (model peers share theirs); a mesh that does not
    fill the world raises, and a model axis with no launcher is refused,
    never run replicated."""
    out = _spawn(ranks.mesh_rank, 4, 2)
    for r, got in enumerate(out):
        d, m = divmod(r, 2)
        assert (got["rank"], got["data_rank"], got["model_rank"]) == (r, d, m)
        assert (got["data_size"], got["model_size"]) == (2, 2)
        assert got["data_group"] == [m, m + 2]
        assert got["model_group"] == [2 * d, 2 * d + 1]
        assert tuple(got["rows"]) == (4 * d, 4 * d + 4)
        assert len(got["refused"]) == 3
        assert all("needs" in e for e in got["refused"])
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        tmesh.make_mesh(tconfig.MeshConfig(data=1, model=2), device="cpu")


# ------------------------------------------------------------ the layers
LAYERS = ("conv", "conv_stride2", "conv_nobias", "dense")


def _layer_case(kind, rng):
    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    if kind == "dense":     # a 3-D input, as the per-source head's
        return f32(8, 5), 1, f32(8), f32(3, 4, 5), f32(3, 4, 8)
    stride = 2 if kind == "conv_stride2" else 1
    b = None if kind == "conv_nobias" else f32(8)
    return (f32(8, 6, 3, 3), stride, b, f32(2, 6, 10, 10),
            f32(2, 8, 10 // stride, 10 // stride))


@pytest.fixture(scope="module")
def split_layers():
    """Each case of ``LAYERS`` and its split layers' results on 2 ranks
    (one spawn for all)."""
    cases = {k: _layer_case(k, np.random.default_rng(3)) for k in LAYERS}
    out = _spawn(ranks.layers_rank, 2, 2, list(cases.values()))
    return {k: (cases[k], [o[i] for o in out])
            for i, k in enumerate(LAYERS)}


@pytest.mark.parametrize("kind", LAYERS)
def test_split_layer_on_two_ranks_equals_the_whole_layer(kind,
                                                         split_layers):
    from dynamic_multiview_3d_torch.models import layers
    (w, stride, b, x, dy), results = split_layers[kind]
    if kind == "dense":
        ref = layers.Dense(5, 8)
    else:
        ref = layers.Conv(6, 8, 3, stride, use_bias=b is not None)
    ref.weight.data.copy_(torch.as_tensor(w))
    if b is not None:
        ref.bias.data.copy_(torch.as_tensor(b))
    xt = torch.as_tensor(x).requires_grad_(True)
    out = ref(xt)
    out.backward(torch.as_tensor(dy))
    want = {"out": out.detach().numpy(), "dx": xt.grad.numpy(),
            **{n: p.grad.numpy() for n, p in ref.named_parameters()}}
    for got in results:
        assert got["blocks"] == ["layer.weight"]
        got = {"out": got["out"], "dx": got["dx"],
               **{n[len("layer."):]: g for n, g in got["grads"].items()}}
        assert set(got) == set(want)
        for k, v in want.items():
            err = float(np.abs(got[k] - v).max())
            assert err <= 1e-6 * float(np.abs(v).max()), (k, err)


# ------------------------------------------------------------ the step
@pytest.mark.parametrize("data,model", [(2, 2), (1, 2)])
def test_mesh_step_equals_one_process_step(data, model):
    """Adam with an EMA, 4 targets an example subsampled to 2, B = 4: the
    mesh's first step against one process's on the global batch, and the
    replicas after 3 steps."""
    _, cfg = _configs(["data.batch_size=4", "data.num_targets=4",
                       "data.targets_per_step=2", "train.lr=1e-3",
                       "train.ema_decay=0.9"])
    sd = _state_dict(cfg)
    rng = np.random.default_rng(5)
    batches = [_batch(rng, b=4, k=4) for _ in range(3)]
    metrics, grads = _one_process(cfg, sd, batches, 1)
    out = _spawn(ranks.tp_step_rank, data * model, model,
                 tconfig.to_dict(cfg), sd, batches, 3, 16)
    ref = _flax_grads(grads)
    norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                       for g in ref.values()))
    for r in out:
        assert len(r["blocks"]) == 17
        for k in metrics:
            assert _rel(r["metrics"][k], metrics[k]) <= 1e-6, k
        ours = _flax_grads(r["grads"])
        for k, g in ref.items():
            err = float(np.linalg.norm((ours[k] - g).ravel()))
            lim = 1e-6 * norm if k in ZERO_GRAD else \
                1e-5 * float(np.linalg.norm(g.ravel()))
            assert err <= lim, (k, err, lim)
    blocks = set(out[0]["blocks"])
    for r, got in enumerate(out):
        for tree in ("params", "ema"):
            for n, p in got[tree].items():
                # blocks: the rank of the other data rank, same model rank
                peer = out[(r + model) % len(out)] if n in blocks else out[0]
                assert np.array_equal(p, peer[tree][n]), (r, tree, n)
    if model > 1:
        w = next(iter(blocks))
        assert out[0]["params"][w].shape[0] * 2 == sd[w].shape[0]
        assert not np.array_equal(out[0]["params"][w], out[1]["params"][w])


def test_mesh_step_matches_jax_auto_mode():
    """The port's (2, 2) step against the JAX package's ``mode="auto"``
    step with the wide params placed by ``model_axis_rules(min_size=16)``
    on a (2, 2) mesh of virtual CPU devices: same weights, same batch."""
    jcfg, cfg = _configs(["data.batch_size=4", "train.optimizer=sgd",
                          "train.lr=1.0", "mesh.data=2", "mesh.model=2"])
    sd = _state_dict(cfg)
    batch = _batch(np.random.default_rng(4), b=4, k=3)
    params = weights.to_flax({k: torch.as_tensor(v) for k, v in sd.items()})
    mesh = jmesh.make_mesh(jconfig.MeshConfig(data=2, model=2),
                           devices=jax.devices()[:4])
    state = jstep.init_state(jcfg)
    params = jax.tree.map(jnp.asarray, params)
    rules = jmesh.model_axis_rules(params, mesh, min_size=16)
    state = state.replace(
        params=jax.device_put(params, rules),
        opt_state=jax.device_put(state.opt_state, jmesh.replicate(mesh)))
    p0 = {k: np.asarray(v) for k, v in _flat(state.params).items()}
    step = jstep.make_train_step(jcfg, mesh=mesh, mode="auto")
    state, jm = step(state, jmesh.shard_batch(mesh, batch))
    ref = {k: p0[k] - np.asarray(v)                 # SGD, lr 1: the grads
           for k, v in _flat(state.params).items()}
    out = _spawn(ranks.tp_step_rank, 4, 2, tconfig.to_dict(cfg), sd, [batch],
                 1, 16)
    for r in out:
        assert _rel(r["metrics"]["loss/total"], jm["loss/total"]) <= 1e-5
        _assert_grads_close(_flax_grads(r["grads"]), ref)


# ------------------------------------------------------------ the loop
# widths up to 128, so that the loop's rule (min_size 128) splits some
LOOP = ["model.image_size=32", "model.num_levels=3",
        "model.base_features=16", "model.max_features=128",
        "model.gru_features=16", "model.pose_embed_dim=8",
        "model.dtype=float32", "data.image_size=32", "data.batch_size=2",
        "data.num_scenes=2", "train.lr=1e-3", "train.num_steps=4",
        "train.ckpt_every=2", "train.log_every=1"]
LOOP_BLOCKS = ["decoder.up1_conv.weight", "decoder.up2_conv.weight",
               "recurrent.encoder.down3.conv.weight",
               "recurrent.encoder.res3.conv.weight"]


def _same(a: dict, b: dict) -> list:
    return [n for n in a if not np.array_equal(a[n], b[n])]


def test_mesh_loop_resumes_exactly_and_writes_one_process_steps(tmp_path):
    """``loop.train`` on a (1, 2) mesh: 4 steps straight against 2 ranks
    killed after step 2 and resumed, bitwise (gathered params and Adam
    moments); rank 0 alone writes; a manager step of the mesh restores
    into a one-process template equal to the ranks' gathered state; a
    one-process run's step restores on the mesh bitwise."""
    def cfg(name, *extra):
        return tconfig.to_dict(tconfig.get_config("default", [
            *LOOP, "mesh.data=1", "mesh.model=2",
            f"train.ckpt_dir={tmp_path / name}", *extra]))

    straight = _spawn(ranks.tp_loop_rank, 2, 2, cfg("a"),
                      str(tmp_path / "logs_a"))
    assert straight[0]["blocks"] == LOOP_BLOCKS and straight[0]["step"] == 4
    killed = cfg("b", "train.fail_after_step=1")
    assert _spawn(ranks.tp_loop_rank, 2, 2, killed,
                  str(tmp_path / "logs_b")) == ["killed", "killed"]
    resumed = _spawn(ranks.tp_loop_rank, 2, 2, cfg("b"),
                     str(tmp_path / "logs_b"))
    for got in (straight[1], resumed[0], resumed[1]):
        assert not _same(straight[0]["params"], got["params"])
        for n, m in straight[0]["moments"].items():
            assert not _same(m, got["moments"][n]), n
    assert sorted(os.listdir(tmp_path / "a")) == ["1", "2", "4", "model",
                                                  "train_config.json"]
    with open(tmp_path / "logs_a" / "r1" / "metrics.jsonl") as f:
        assert f.read() == ""

    # the mesh's manager step in one process
    one_cfg = tconfig.get_config("default", [*LOOP, "mesh.data=1"])
    one = tstep.init_state(one_cfg, device="cpu")
    tckpt.make_manager(str(tmp_path / "a")).restore(4, one)
    got = {n: p.detach().numpy() for n, p in one.module.named_parameters()}
    assert not _same(straight[0]["params"], got)
    assert dict(one.module.named_parameters())[LOOP_BLOCKS[1]].shape[0] == 256

    # a one-process step on the mesh
    single = tconfig.get_config("default", [
        *LOOP, "mesh.data=1", "train.num_steps=2",
        f"train.ckpt_dir={tmp_path / 'c'}"])
    state, _ = tloop.train(single, device="cpu")
    back = _spawn(ranks.tp_loop_rank, 2, 2, cfg("c", "train.num_steps=2"),
                  str(tmp_path / "logs_c"))
    want = {n: p.detach().numpy() for n, p in state.module.named_parameters()}
    for got in back:
        assert got["step"] == 2 and not _same(want, got["params"])


# ------------------------------------------------------------ the rest
def test_dryrun_multichip_four_ranks_runs_mode_2():
    losses = tdryrun.dryrun_multichip(4, timeout_s=TIMEOUT)
    assert set(losses[0]) == {"1", "2", "3", "4", "4b"}
    assert _rel(losses[0]["2"], losses[0]["1"]) <= 1e-5


def test_serving_over_a_model_axis_equals_the_one_process_program(tmp_path):
    """``predict(mesh=)`` on a (1, 2) mesh: both model peers run all 4
    rows, bitwise equal to the one-process request."""
    cfg = tconfig.override(tconfig.Config(), [
        *TINY, "model.dtype=float32", "model.warp_precision=exact",
        "data.seq_len=1", "data.num_targets=2"])
    model = TModel.init_random(cfg, seed=0, device="cpu")
    path = str(tmp_path / "flow.dmv3d")
    serving.export_predict(model, path, batch=4, num_targets=2)
    rng = np.random.default_rng(8)
    seq, src, tgt = (smooth_images(rng, 4, 1, 32), random_poses(rng, 4, 1),
                     random_poses(rng, 4, 2))
    want = serving.ServedModel.load(path, device="cpu").predict(
        seq, tgt, source_poses=src).numpy()
    for got in _spawn(ranks.serve_rank, 2, 2, path, seq, src, tgt):
        np.testing.assert_array_equal(got, want)
