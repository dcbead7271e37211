"""The port's training slice (data/pipeline.py, train/losses.py,
train/metrics.py, train/step.py, models/dmv3d.py under autograd) against the
JAX package on the CPU.

Tolerances:
- losses, PSNR, SSIM: 1e-6 relative (f32, the same operations; SSIM's
  convolution sums in another order);
- learning-rate schedules: 1e-6 relative (optax computes in f32, the port
  in Python floats);
- one optimizer update on a fixed gradient tree: 1e-6 relative with an
  absolute floor of 1e-9 (f32 rounding of the same formula: Adam's and
  AdamW's updates are lr * m / (sqrt(v) + eps) in both, in other orders);
- one train step of the tiny f32 model (TF32 off, smooth images,
  ``warp_precision=exact``: the JAX CPU model warps in f32 whatever it is
  set to): loss 1e-5 relative; every parameter's gradient within 1e-4 in
  relative L2, except the two biases whose true gradient is exactly zero
  (each feeds a GroupNorm with one channel per group, which subtracts it
  again), held within 1e-6 of the global gradient norm: both sides hold only
  roundoff there. Measured on this test's inputs: loss 1.6e-6; the other 71
  gradients <= 8.2e-6 (median 2.4e-6); the two biases 4.6e-8 of the norm.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from dynamic_multiview_3d_torch import config as tconfig
from dynamic_multiview_3d_torch import weights
from dynamic_multiview_3d_torch.data import pipeline as tpipeline
from dynamic_multiview_3d_torch.parallel import mesh as tmesh
from dynamic_multiview_3d_torch.data.synthetic import (SyntheticScenes,
                                                       random_poses,
                                                       smooth_images,
                                                       to_model)
from dynamic_multiview_3d_torch.train import losses as tlosses
from dynamic_multiview_3d_torch.train import metrics as tmetrics
from dynamic_multiview_3d_torch.train import step as tstep
from dynamic_multiview_3d_torch.utils import jax_random as jr
from dynamic_multiview_3d_tpu import config as jconfig
from dynamic_multiview_3d_tpu.models import DMV3D as JDMV3D
from dynamic_multiview_3d_tpu.train import losses as jlosses
from dynamic_multiview_3d_tpu.train import metrics as jmetrics
from dynamic_multiview_3d_tpu.train import step as jstep
from test_golden import _cfg

# the biases whose true gradient is zero on the tiny config (see above)
ZERO_GRAD = ("recurrent/encoder/stem/conv/bias", "decoder/fuse0_x/bias")


def _configs(extra=()):
    jcfg = jconfig.override(_cfg(), ["model.warp_precision=exact",
                                     "data.batch_size=2", *extra])
    return jcfg, tconfig.from_dict(jconfig.to_dict(jcfg))


def _batch(rng, b=2, t=1, k=3, hw=32):
    return {"image_seq": smooth_images(rng, b, t, hw),
            "src_poses": random_poses(rng, b, t),
            "tgt_poses": random_poses(rng, b, k),
            "tgt_images": smooth_images(rng, b, k, hw)}


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


# ------------------------------------------------------------- losses/metrics
def _outputs(rng, with_valid=True, b=2, k=2, h=16, w=16):
    out = {"view": rng.uniform(-1, 1, (b, k, h, w, 3)),
           "flow": rng.uniform(-20, 20, (b, k, h, w, 2)),
           "mask": rng.uniform(0, 1, (b, k, h, w, 1)),
           "rgb": rng.uniform(-1, 1, (b, k, h, w, 3))}
    out["mask"][0, 0, :2] = 0.0                   # hits the 1e-6 clip
    out["mask"][1, 0, :2] = 1.0
    if with_valid:
        out["flow_valid"] = (rng.uniform(0, 1, (b, k, h, w)) > 0.3)
    out = {k: v.astype(np.float32) for k, v in out.items()}
    return out, {"tgt_images": rng.uniform(-1, 1, (b, k, h, w, 3))
                 .astype(np.float32)}


@pytest.mark.parametrize("with_valid,extra", [
    (True, []), (False, []),
    (True, ["train.ssim_weight=0.5", "train.smooth_weight=0.1"])])
def test_total_loss_matches_jax(with_valid, extra):
    out, batch = _outputs(np.random.default_rng(0), with_valid)
    jcfg, tcfg = _configs(extra)
    jl, jm = jlosses.total_loss({k: jnp.asarray(v) for k, v in out.items()},
                                {"tgt_images": jnp.asarray(
                                    batch["tgt_images"])}, jcfg.train)
    tl, tm = tlosses.total_loss(
        {k: torch.from_numpy(v) for k, v in out.items()},
        {"tgt_images": torch.from_numpy(batch["tgt_images"])}, tcfg.train)
    assert set(tm) == set(jm)
    for k in jm:
        assert _rel(tm[k], jm[k]) <= 1e-6, (k, float(tm[k]), float(jm[k]))
    assert _rel(tl, jl) <= 1e-6


def test_flow_validity_and_depth_loss():
    """flow_validity, and total_loss of the "depth" synthesis outputs (the
    mask's geo_valid target and the masked geo L1) against JAX."""
    flow = np.random.default_rng(1).uniform(-20, 20, (2, 2, 8, 8, 2)) \
        .astype(np.float32)
    np.testing.assert_array_equal(
        tlosses.flow_validity(torch.from_numpy(flow)).numpy(),
        np.asarray(jlosses.flow_validity(jnp.asarray(flow))))
    _check_total_loss(*_geo_outputs(np.random.default_rng(0), "depth"),
                      [], "depth")


def _geo_outputs(rng, synthesis, t=3):
    """Outputs as each synthesis mode returns them: "depth" (flow + the
    geometric side path), "multidepth" (no flow) and "multiflow" (a flow
    per source, [B,K,T,H,W,2])."""
    out, batch = _outputs(rng, with_valid=synthesis != "multidepth")
    b, k, h, w, _ = out["view"].shape
    if synthesis in ("depth", "multidepth"):
        out["depth"] = rng.uniform(0.5, 3, (b, k, h, w)).astype(np.float32)
        out["geo_view"] = rng.uniform(-1, 1, (b, k, h, w, 3)) \
            .astype(np.float32)
        out["geo_valid"] = (rng.uniform(0, 1, (b, k, h, w)) > 0.4) \
            .astype(np.float32)
    if synthesis == "multidepth":
        del out["flow"]
    if synthesis == "multiflow":
        out["flow"] = rng.uniform(-20, 20, (b, k, t, h, w, 2)) \
            .astype(np.float32)
        out["conf_weights"] = rng.uniform(0, 1, (b, k, h, w, t)) \
            .astype(np.float32)
    return out, batch


def _check_total_loss(out, batch, extra, synthesis):
    jcfg, tcfg = _configs(extra)
    jl, jm = jlosses.total_loss({k: jnp.asarray(v) for k, v in out.items()},
                                {"tgt_images": jnp.asarray(
                                    batch["tgt_images"])}, jcfg.train,
                                synthesis=synthesis)
    tl, tm = tlosses.total_loss(
        {k: torch.from_numpy(v) for k, v in out.items()},
        {"tgt_images": torch.from_numpy(batch["tgt_images"])}, tcfg.train,
        synthesis=synthesis)
    assert set(tm) == set(jm)
    for k in jm:
        assert _rel(tm[k], jm[k]) <= 1e-6, (k, float(tm[k]), float(jm[k]))
    assert _rel(tl, jl) <= 1e-6
    return tm


@pytest.mark.parametrize("synthesis", ["depth", "multidepth", "multiflow"])
@pytest.mark.parametrize("extra", [
    [], ["train.ssim_weight=0.5", "train.smooth_weight=0.1",
         "train.geo_weight=0.25"]])
def test_total_loss_matches_jax_geo_and_multi(synthesis, extra):
    out, batch = _geo_outputs(np.random.default_rng(3), synthesis)
    metrics = _check_total_loss(out, batch, extra, synthesis)
    assert ("loss/geo_l1" in metrics) == (synthesis != "multiflow")
    assert ("loss/smooth" in metrics) == (
        bool(extra) and synthesis != "multidepth")


def test_psnr_ssim_match_jax():
    rng = np.random.default_rng(2)
    a = rng.uniform(-1, 1, (2, 3, 24, 24, 3)).astype(np.float32)
    b = np.clip(a + 0.2 * rng.standard_normal(a.shape), -1, 1) \
        .astype(np.float32)
    for fn_t, fn_j in ((tmetrics.psnr, jmetrics.psnr),
                       (tmetrics.ssim, jmetrics.ssim)):
        ours = float(fn_t(torch.from_numpy(a), torch.from_numpy(b)))
        ref = float(fn_j(jnp.asarray(a), jnp.asarray(b)))
        assert _rel(ours, ref) <= 1e-6, (fn_t.__name__, ours, ref)
    assert float(tmetrics.psnr(torch.from_numpy(a), torch.from_numpy(a))) \
        > 100


def test_metrics_writer_jsonl(tmp_path):
    import json
    writer = tmetrics.MetricsWriter(str(tmp_path), use_tensorboard=False)
    try:
        writer.write(3, {"loss/total": torch.tensor(0.5), "lr": 1e-3})
        assert not writer.has_images
    finally:
        writer.close()
    rec = json.loads((tmp_path / "metrics.jsonl").read_text())
    assert rec["step"] == 3 and rec["loss/total"] == 0.5 and rec["lr"] == 1e-3


# ------------------------------------------------------------- schedule/optim
@pytest.mark.parametrize("extra", [
    [],
    ["train.lr_schedule=cosine", "train.warmup_steps=10",
     "train.lr_final=1e-5", "train.num_steps=110", "train.lr=1e-3"],
    ["train.lr_schedule=cosine", "train.lr_final=2e-5",
     "train.num_steps=50"],
])
def test_make_lr_matches_optax(extra):
    jcfg, tcfg = _configs(extra)
    ref, ours = jstep.make_lr(jcfg), tstep.make_lr(tcfg)
    if not callable(ref):
        assert ours == ref == 2e-4
        return
    t = tcfg.train
    warm = t.warmup_steps
    for s in sorted({0, max(warm - 1, 0), warm, (warm + t.num_steps) // 2,
                     t.num_steps, t.num_steps + 7}):
        r, o = float(ref(s)), ours(s)
        assert abs(o - r) <= 1e-6 * max(abs(r), 1e-9), (s, o, r)
    with pytest.raises(ValueError):
        tstep.make_lr(tconfig.override(tcfg, ["train.lr_schedule=nope"]))


@pytest.mark.parametrize("extra", [
    [], ["train.optimizer=adamw", "train.weight_decay=0.05"],
    ["train.weight_decay=0.01"], ["train.optimizer=sgd"],
    ["train.lr_schedule=cosine", "train.warmup_steps=2",
     "train.num_steps=10"],
])
def test_optimizer_updates_match_optax(extra):
    """Three updates of each optimizer on fixed gradients, the schedule's
    lr set per update as the train step sets it."""
    jcfg, tcfg = _configs(extra)
    rng = np.random.default_rng(3)
    shapes = {"w": (4, 3), "b": (3,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    gs = [{k: (rng.standard_normal(s) * 10.0 ** rng.integers(-4, 1))
           .astype(np.float32) for k, s in shapes.items()} for _ in range(3)]
    tx = jstep.make_optimizer(jcfg)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt = tstep.make_optimizer(tcfg, list(tp.values()))
    lr = tstep.make_lr(tcfg)
    for i, g in enumerate(gs):
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        if callable(lr):
            for group in opt.param_groups:
                group["lr"] = lr(i)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
    assert not np.allclose(tp["w"].detach().numpy(), p0["w"])


# ------------------------------------------------------------- pipeline
def test_preprocess_uint8_equals_float():
    src = SyntheticScenes(num_scenes=2, image_size=16, num_targets=3)
    raw, flt = src.batch(range(2), raw=True), src.batch(range(2))
    pu = tpipeline.preprocess(raw, device="cpu")
    pf = tpipeline.preprocess(flt, device="cpu")
    assert raw["image_seq"].dtype == np.uint8
    for k in pf:
        assert pu[k].dtype == torch.float32
        torch.testing.assert_close(pu[k], pf[k], rtol=0, atol=0)


def test_targets_per_step_draws_distinct_reproducible_subsets():
    src = SyntheticScenes(num_scenes=2, image_size=8, num_targets=6)
    batch = src.batch(range(4), raw=True)

    def pick(seed, step):
        out = tpipeline.preprocess(
            batch, device="cpu", key=jr.step_keys(seed, step, False)[0],
            targets_per_step=2)
        assert out["tgt_poses"].shape == (4, 2, 3)
        assert out["tgt_images"].shape == (4, 2, 8, 8, 3)
        # each kept target is one of the example's own, with its image
        for i in range(4):
            for j in range(2):
                hit = np.flatnonzero((batch["tgt_poses"][i] ==
                                      out["tgt_poses"][i, j].numpy())
                                     .all(-1))
                assert hit.size == 1
                np.testing.assert_array_equal(
                    out["tgt_images"][i, j].numpy(),
                    to_model(batch["tgt_images"][i, hit[0]]))
        return out["tgt_poses"].numpy()

    a = pick(0, 5)
    np.testing.assert_array_equal(a, pick(0, 5))           # reproducible
    assert not np.array_equal(a, pick(0, 6))               # per step
    assert not np.array_equal(a, pick(1, 5))               # per seed
    # per example: the four examples (two scenes, two copies each) do not
    # all keep the same pair of target slots
    slots = [tuple(np.flatnonzero((batch["tgt_poses"][i][:, None] == a[i])
                                  .all(-1).any(-1))) for i in range(4)]
    assert len(set(slots)) > 1
    for i in range(4):                                     # distinct views
        assert not np.array_equal(a[i, 0], a[i, 1])
    same = tpipeline.preprocess(batch, device="cpu", key=None,
                                targets_per_step=2)
    assert same["tgt_poses"].shape == (4, 6, 3)


def test_make_source_synthetic_only(tmp_path):
    """make_source serves all four sources (the name predates the three
    ported in the data-sources slice): each on a tiny export of the port's
    own, with the JAX package's source classes' contract."""
    from dynamic_multiview_3d_torch.data import frames, shapenet, tfrecords
    _, tcfg = _configs()
    src = tpipeline.make_source(tcfg.data)
    assert isinstance(src, SyntheticScenes)
    assert src.image_size == 32
    roots = {"frames": frames.export_synthetic(
                 str(tmp_path / "f"), num_scenes=2, image_size=32,
                 num_views=3, seq_len=1),
             "tfrecords": tfrecords.export_tfrecords(
                 str(tmp_path / "t"), num_scenes=2, image_size=32,
                 num_views=3, shards=2),
             "shapenet_dir": shapenet.export_fixture(
                 str(tmp_path / "s"), num_scenes=2, image_size=32,
                 num_views=3)}
    kinds = {"frames": frames.FrameFolderScenes,
             "tfrecords": tfrecords.TFRecordScenes,
             "shapenet_dir": shapenet.ShapeNetDirScenes}
    for name, root in roots.items():
        src = tpipeline.make_source(dataclasses.replace(
            tcfg.data, source=name, root=root))
        assert type(src) is kinds[name] and len(src.scenes) == 2
        batch = src.batch(range(2), raw=True)
        assert batch["image_seq"].shape == (2, 1, 32, 32, 3)
        assert batch["image_seq"].dtype == np.uint8
    with pytest.warns(UserWarning, match="SyntheticFrames"):
        src = tpipeline.make_source(dataclasses.replace(
            tcfg.data, source="frames", root=""))
    assert isinstance(src, frames.SyntheticFrames)
    with pytest.raises(ValueError, match="unknown data source"):
        tpipeline.make_source(dataclasses.replace(tcfg.data, source="lmdb"))


# ------------------------------------------------------------- train step
def _flat(tree, prefix=""):
    return weights.flatten(tree, prefix)


def _jax_loss_and_grads(jcfg, params, batch):
    module = JDMV3D(jcfg.model)

    def loss_fn(p):
        out = module.apply({"params": p}, batch["image_seq"],
                           batch["src_poses"], batch["tgt_poses"])
        return jlosses.total_loss(out, batch, jcfg.train,
                                  synthesis=jcfg.model.synthesis)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    return float(loss), {k: float(v) for k, v in metrics.items()}, \
        {k: np.asarray(v) for k, v in _flat(grads).items()}


def _assert_grads_close(ours: dict, ref: dict, zero=ZERO_GRAD):
    """The tolerance rule of the module docstring, by flax path; ``zero``
    names the parameters whose true gradient is zero."""
    assert set(ours) == set(ref)
    norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                       for g in ref.values()))
    bad = {}
    for k, r in ref.items():
        err = float(np.linalg.norm((ours[k] - r).ravel()))
        lim = 1e-6 * norm if k in zero else \
            1e-4 * float(np.linalg.norm(r.ravel()))
        if not err <= lim:
            bad[k] = (err, lim)
    assert not bad, bad


def _port_step_grads(state):
    return _flat(weights.to_flax({n: p.grad for n, p in
                                  state.module.named_parameters()}))


def test_train_step_matches_jax_grad():
    """One port train step (Adam) on a float batch: its loss, metrics and
    the gradients it applied, against jax.grad of the JAX loss on the same
    weights and batch."""
    jcfg, tcfg = _configs()
    state = tstep.init_state(tcfg, seed=7, device="cpu")
    params = weights.to_flax(state.module.state_dict())
    batch = _batch(np.random.default_rng(4))
    loss, metrics, ref = _jax_loss_and_grads(
        jcfg, params, {k: jnp.asarray(v) for k, v in batch.items()})
    step = tstep.make_train_step(tcfg, device="cpu")
    state, m = step(state, batch)
    assert state.step == 1
    assert set(m) == set(metrics)
    assert _rel(m["loss/total"], loss) <= 1e-5
    for k in metrics:
        assert _rel(m[k], metrics[k]) <= 1e-5, k
    _assert_grads_close(_port_step_grads(state), ref)
    for k in ZERO_GRAD:                 # what the special rule is for
        assert np.linalg.norm(ref[k]) < 1e-3 * np.linalg.norm(
            ref["decoder/heads/kernel"])


@pytest.mark.parametrize("synthesis,mode", [
    ("multiflow", "shared"), ("multiflow", "baked"),
    ("multidepth", "shared"), ("multidepth", "baked")])
def test_multi_source_train_step_matches_jax_grad(synthesis, mode):
    """One Adam step of the tiny multi-source model (T = 3 sources, K = 2
    targets) against jax.grad, at the bars of the flow case: the loss, its
    terms (geo L1 for multidepth), and every gradient, the depth head's and
    the per-source heads' included. Multiflow's loss reads neither the
    blended warp nor the weights, multidepth's reads the blend (geo L1), so
    the backward runs with and without the multi cotangent."""
    jcfg, tcfg = _configs([f"model.synthesis={synthesis}",
                           f"model.multi_head_mode={mode}",
                           "data.seq_len=3"])
    state = tstep.init_state(tcfg, seed=7, device="cpu")
    params = weights.to_flax(state.module.state_dict())
    batch = _batch(np.random.default_rng(9), t=3, k=2)
    loss, metrics, ref = _jax_loss_and_grads(
        jcfg, params, {k: jnp.asarray(v) for k, v in batch.items()})
    state, m = tstep.make_train_step(tcfg, device="cpu")(state, batch)
    assert set(m) == set(metrics)
    assert ("loss/geo_l1" in m) == (synthesis == "multidepth")
    assert _rel(m["loss/total"], loss) <= 1e-5
    for k in metrics:
        assert _rel(m[k], metrics[k]) <= 1e-5, k
    # multidepth's shared head emits only the confidence logit: its bias
    # shifts every source's logit alike, and the softmax ignores that
    zero = ZERO_GRAD + (("decoder/srchead_out/bias",)
                        if (synthesis, mode) == ("multidepth", "shared")
                        else ())
    _assert_grads_close(_port_step_grads(state), ref, zero)
    for k in zero:
        assert np.linalg.norm(ref[k]) < 1e-3 * np.linalg.norm(
            ref["decoder/fuse0_x/kernel"])
    heads = ("decoder/depth_head/kernel" if synthesis == "multidepth"
             else "decoder/heads_multi/kernel" if mode == "baked"
             else "decoder/srchead_out/kernel")
    assert np.linalg.norm(ref[heads]) > 0


DEPTH = {"c2d": ["model.synthesis=depth", "model.predict_depth=true"],
         "c2g": ["model.predict_depth=true"]}


def _split_flow_columns(grads: dict) -> dict:
    """``decoder/heads`` kernel and bias split into their flow output
    channels (0, 1) and the mask and rgb ones (2-5)."""
    out = dict(grads)
    for leaf in ("kernel", "bias"):
        full = out.pop(f"decoder/heads/{leaf}")
        out[f"decoder/heads/{leaf}[flow]"] = full[..., :2]
        out[f"decoder/heads/{leaf}[mask,rgb]"] = full[..., 2:]
    return out


@pytest.mark.parametrize("variant", ["c2d", "c2g"])
def test_depth_train_step_matches_jax_grad(variant):
    """One Adam step of the tiny depth-synthesis model (c2d: the view from
    the depth reprojection + composite) and of flow synthesis with the
    geometric side view (c2g), against jax.grad at the bars of the flow
    case: the loss, its terms (geo L1 in both), and every gradient, the
    depth head's included. In c2d no loss reads the flow (the warp is an
    aux output, the mask's target is geo_valid, smooth_weight is 0), so the
    flow channels of decoder/heads have zero gradient in both frameworks:
    held, like the GroupNorm-fed biases, within 1e-6 of the global norm."""
    jcfg, tcfg = _configs(DEPTH[variant])
    state = tstep.init_state(tcfg, seed=7, device="cpu")
    params = weights.to_flax(state.module.state_dict())
    batch = _batch(np.random.default_rng(10))
    loss, metrics, ref = _jax_loss_and_grads(
        jcfg, params, {k: jnp.asarray(v) for k, v in batch.items()})
    state, m = tstep.make_train_step(tcfg, device="cpu")(state, batch)
    assert set(m) == set(metrics)
    assert "loss/geo_l1" in m
    assert _rel(m["loss/total"], loss) <= 1e-5
    for k in metrics:
        assert _rel(m[k], metrics[k]) <= 1e-5, k
    ours = _port_step_grads(state)
    zero = ZERO_GRAD
    if variant == "c2d":
        ours, ref = _split_flow_columns(ours), _split_flow_columns(ref)
        zero = zero + ("decoder/heads/kernel[flow]",
                       "decoder/heads/bias[flow]")
        for k in zero[-2:]:
            assert not np.any(ref[k]) and not np.any(ours[k]), k
    _assert_grads_close(ours, ref, zero)
    assert np.linalg.norm(ref["decoder/depth_head/kernel"]) > 0


def test_remat_scan_gives_the_same_gradients():
    _, tcfg = _configs(["data.seq_len=2"])
    batch = _batch(np.random.default_rng(5), t=2)
    grads = []
    for remat in (False, True):
        cfg = tconfig.override(tcfg, [f"model.remat_scan={remat}"])
        state = tstep.init_state(cfg, seed=3, device="cpu")
        _, m = tstep.make_train_step(cfg, device="cpu")(state, batch)
        grads.append((m["loss/total"], _port_step_grads(state)))
    assert grads[0][0] == grads[1][0]
    for k, g in grads[0][1].items():
        np.testing.assert_array_equal(grads[1][1][k], g, err_msg=k)


def _params(state):
    return {n: p.detach() for n, p in state.module.named_parameters()}


def test_ema_tracks_params():
    _, tcfg = _configs(["train.ema_decay=0.9", "train.lr=1e-3"])
    state = tstep.init_state(tcfg, seed=0, device="cpu")
    p0 = {n: p.clone() for n, p in _params(state).items()}
    for n, p in _params(state).items():
        torch.testing.assert_close(state.ema[n], p, rtol=0, atol=0)
        assert state.ema[n].data_ptr() != p.data_ptr()
    step = tstep.make_train_step(tcfg, device="cpu")
    batch = _batch(np.random.default_rng(6))
    want = {n: p.clone() for n, p in p0.items()}
    for _ in range(3):
        state, _ = step(state, batch)
        for n, p in _params(state).items():
            want[n] = 0.9 * want[n] + 0.1 * p
    for n in want:
        torch.testing.assert_close(state.ema[n], want[n], rtol=1e-6,
                                   atol=1e-7)

    def dist(a):
        return sum(float((a[n] - p0[n]).abs().sum()) for n in p0)
    assert 0 < dist(state.ema) < dist(_params(state))


def test_steps_per_dispatch_loops_and_averages():
    _, tcfg = _configs(["train.lr=1e-3"])
    rng = np.random.default_rng(8)
    batches = [_batch(rng), _batch(rng)]
    one = tstep.init_state(tcfg, seed=2, device="cpu")
    step = tstep.make_train_step(tcfg, device="cpu")
    ms = [step(one, b)[1] for b in batches]
    cfg2 = tconfig.override(tcfg, ["train.steps_per_dispatch=2"])
    two = tstep.init_state(cfg2, seed=2, device="cpu")
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    two, m = tstep.make_train_step(cfg2, device="cpu")(two, stacked)
    assert two.step == 2
    for k in m:
        assert abs(m[k] - (ms[0][k] + ms[1][k]) / 2) <= 1e-6 * abs(m[k]), k
    for n, p in _params(one).items():
        torch.testing.assert_close(_params(two)[n], p, rtol=0, atol=0)


def test_overfit_one_batch():
    """The loss must drop markedly when training repeatedly on one batch
    (tests/test_train.py's check, on the port)."""
    _, tcfg = _configs(["train.lr=1e-3", "data.batch_size=4"])
    src = SyntheticScenes(num_scenes=1, image_size=32, seq_len=1,
                          num_targets=1)
    batch = src.batch(range(4), raw=True)
    state = tstep.init_state(tcfg, device="cpu")
    step = tstep.make_train_step(tcfg, device="cpu")
    first = None
    for _ in range(45):
        state, m = step(state, batch)
        first = m["loss/total"] if first is None else first
    assert np.isfinite(m["loss/total"])
    assert m["loss/total"] < 0.5 * first, (first, m["loss/total"])


def test_eval_step():
    _, tcfg = _configs()
    state = tstep.init_state(tcfg, device="cpu")
    src = SyntheticScenes(num_scenes=1, image_size=32)
    ev = tstep.make_eval_step(tcfg, device="cpu")(state.module,
                                                  src.batch(range(2)))
    assert set(ev) == {"eval/psnr", "eval/ssim"}
    assert np.isfinite(ev["eval/psnr"]) and -1.0 <= ev["eval/ssim"] <= 1.0


def test_unported_training_paths_raise():
    """A 'model' mesh axis with no process per rank is refused (never run
    replicated), a mesh that is not a ``parallel.mesh.Mesh`` is refused; a
    resident bank is accepted, and device sampling without one raises the
    JAX package's ValueError."""
    _, tcfg = _configs()
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        tmesh.make_mesh(tconfig.MeshConfig(data=1, model=2), device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        tstep.make_train_step(tcfg, device="cpu", mesh=object())
    assert callable(tstep.make_train_step(tcfg, device="cpu",
                                          resident=object()))
    with pytest.raises(ValueError, match="device_sampling"):
        tstep.make_train_step(tconfig.override(
            tcfg, ["data.device_sampling=true"]), device="cpu")
    with pytest.raises(ValueError):
        tstep.make_optimizer(tconfig.override(tcfg, ["train.optimizer=lamb"]),
                             [torch.nn.Parameter(torch.zeros(1))])


def test_train_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    _, tcfg = _configs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstep.init_state(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstep.make_train_step(tcfg)


def test_to_flax_inverts_from_flax():
    _, tcfg = _configs()
    module = tstep.init_state(tcfg, seed=1, device="cpu").module
    sd = module.state_dict()
    back = weights.from_flax(weights.to_flax(sd), module)
    assert set(back) == set(sd)
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)
    tree = weights.to_flax(sd)
    assert tree["decoder"]["heads"]["kernel"].shape == (3, 3, 8, 6)  # HWIO
    assert tree["bottleneck"]["pose_fc1"]["kernel"].shape == (8, 8)  # in,out


@pytest.mark.parametrize("variant", ["c2d", "c2g"])
def test_depth_head_round_trips_flax(variant):
    """The depth head of flow and depth synthesis (``predict_depth``)
    crosses ``to_flax`` / ``from_flax`` under the flax name and layout, and
    the flax tree has exactly the leaves of the JAX model's init."""
    jcfg, tcfg = _configs(DEPTH[variant])
    module = tstep.init_state(tcfg, seed=1, device="cpu").module
    sd = module.state_dict()
    tree = weights.to_flax(sd)
    assert tree["decoder"]["depth_head"]["kernel"].shape == (3, 3, 8, 1)
    assert tree["decoder"]["depth_head"]["bias"].shape == (1,)
    back = weights.from_flax(tree, module)
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)
    shapes = jax.eval_shape(
        lambda: JDMV3D(jcfg.model).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 1, 32, 32, 3)),
            jnp.zeros((1, 1, 3)), jnp.zeros((1, 1, 3))))["params"]
    assert {"/".join(key.key for key in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)} \
        == {k: v.shape for k, v in _flat(tree).items()}
