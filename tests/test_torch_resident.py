"""The port's device-resident bank (data/resident.py) and the step and loop
paths that use it, on the CPU, mirroring tests/test_resident.py.

``index_batch`` must give the JAX package's int32 arrays, and ``gather``
the host batch of the same indices, bitwise; a train step fed resident
indices must equal the step fed those host pixels, bitwise. The device
draw (``device_draw``) is held to its properties (indices in range,
distinct targets when V >= K, distinct orbit sources when V >= T, a pure
function of seed, step and example index) and pinned to a table of the
JAX package's draw, which the card is held to by chip_smoke.py
(tests/test_torch_jax_random.py holds it to JAX's draw at every case).
"""

import dataclasses

import numpy as np
import pytest
import torch

from dynamic_multiview_3d_torch import config as tconfig
from dynamic_multiview_3d_torch.data import frames as tframes
from dynamic_multiview_3d_torch.data import resident as tresident
from dynamic_multiview_3d_torch.data import tfrecords as ttfr
from dynamic_multiview_3d_torch.parallel import mesh as tmesh
from dynamic_multiview_3d_torch.train import loop as tloop
from dynamic_multiview_3d_torch.train import step as tstep
from dynamic_multiview_3d_torch.utils import jax_random as jr
from dynamic_multiview_3d_tpu import config as jconfig
from dynamic_multiview_3d_tpu.data import frames as jframes
from dynamic_multiview_3d_tpu.data import resident as jresident

TINY = ["model.image_size=32", "model.num_levels=3", "model.base_features=8",
        "model.max_features=16", "model.gru_features=16",
        "model.pose_embed_dim=8", "model.dtype=float32",
        "data.image_size=32", "data.seq_len=2", "data.num_targets=2",
        "data.batch_size=4", "train.optimizer=sgd", "train.lr=1e-3"]
# one process on the CPU: the mesh the loop hands _maybe_resident
CPU = tmesh.Mesh(device=torch.device("cpu"))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tiny models: the suite runs
    several worker processes on a few cores, and torch's default of a
    thread per core each makes them wait on one another's threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def packed_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("resident_ds"))
    jframes.export_synthetic(root, num_scenes=4, image_size=32, num_views=4,
                             seq_len=3, fmt="packed")
    return root


def _dcfg(root, **kw):
    kw.setdefault("batch_size", 4)
    return tconfig.DataConfig(source="frames", root=root, image_size=32,
                              seq_len=2, num_targets=2, **kw)


def _tiny(root, *extra):
    return tconfig.get_config("default", TINY + [
        "data.source=frames", f"data.root={root}", *extra])


def _k_samp(seed: int, step: int) -> tuple:
    """The sampling key of the JAX step ``step`` of a run seeded ``seed``."""
    return jr.step_keys(seed, step, True)[1]


def _same_params(a, b):
    pa, pb = dict(a.module.named_parameters()), dict(b.module.named_parameters())
    for name in pa:
        assert torch.equal(pa[name], pb[name]), name


def test_gather_matches_host_batch(packed_root):
    """index_batch gives the JAX package's int32 arrays; gather gives the
    host batch of those examples bitwise (which is the JAX host batch)."""
    cfg = _dcfg(packed_root)
    src = tframes.FrameFolderScenes(cfg)
    res = tresident.ResidentFrames(src, cfg, device="cpu")
    jcfg = jconfig.DataConfig(**dataclasses.asdict(cfg))
    jsrc = jframes.FrameFolderScenes(jcfg)
    jres = jresident.ResidentFrames(jsrc, jcfg)
    idx = list(range(8, 16))
    ours, ref = res.index_batch(idx), jres.index_batch(idx)
    assert ours.keys() == ref.keys()
    for k in ours:
        assert ours[k].dtype == np.int32
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(res.frames.numpy(), np.asarray(jres.frames))
    np.testing.assert_array_equal(res.poses.numpy(), np.asarray(jres.poses))
    dev = res.gather(res.frames, res.poses, ours)
    host = src.batch(idx, raw=True)
    for k in host:
        np.testing.assert_array_equal(dev[k].numpy(), host[k], err_msg=k)
    jhost = jsrc.batch(idx, raw=True)
    for k in jhost:
        np.testing.assert_array_equal(dev[k].numpy(), jhost[k], err_msg=k)


def test_fits_budget(packed_root):
    cfg = _dcfg(packed_root)
    src = tframes.FrameFolderScenes(cfg)
    assert tresident.fits_budget(src, cfg)
    assert not tresident.fits_budget(src, dataclasses.replace(
        cfg, resident_budget_mb=0))
    res = tresident.ResidentFrames(src, cfg, device="cpu")
    assert res.nbytes == tresident.bank_nbytes(4, 4, 3, 32) == \
        res.frames.numel() == 4 * 4 * 3 * 32 * 32 * 3
    # the c3md preset's full bank: 512 scenes x 8 views x 8 frames of 128²
    assert tresident.bank_nbytes(512, 8, 8, 128) == 1_610_612_736


def test_resident_training_matches_host_batches(packed_root):
    """Three steps fed resident indices == three steps fed the host uint8
    batches of the same examples, bitwise."""
    cfg = _tiny(packed_root)
    src = tframes.FrameFolderScenes(cfg.data)
    res = tloop._maybe_resident(cfg, src, CPU)
    assert res is not None, "auto should engage on this packed dataset"
    state_r = tstep.init_state(cfg, device="cpu")
    state_h = tstep.init_state(cfg, device="cpu")
    step_res = tstep.make_train_step(cfg, device="cpu", resident=res)
    step_host = tstep.make_train_step(cfg, device="cpu")
    fn_res = tloop._make_batch_fn(cfg, src, resident=res)
    fn_host = tloop._make_batch_fn(cfg, src)
    for step in range(3):
        _, m_r = step_res(state_r, fn_res(step))
        _, m_h = step_host(state_h, fn_host(step))
        assert m_r == m_h
    _same_params(state_r, state_h)


def test_steps_per_dispatch_matches_single(packed_root):
    """One dispatch of 4 optimizer steps on stacked index batches == 4
    single-step dispatches on the same stream, bitwise."""
    cfg1 = _tiny(packed_root)
    cfg4 = _tiny(packed_root, "train.steps_per_dispatch=4")
    src = tframes.FrameFolderScenes(cfg1.data)
    res = tloop._maybe_resident(cfg1, src, CPU)
    s1, s4 = (tstep.init_state(c, device="cpu") for c in (cfg1, cfg4))
    step1 = tstep.make_train_step(cfg1, device="cpu", resident=res)
    step4 = tstep.make_train_step(cfg4, device="cpu", resident=res)
    fn1 = tloop._make_batch_fn(cfg1, src, resident=res)
    fn4 = tloop._make_batch_fn(cfg4, src, resident=res, steps_per_dispatch=4)
    assert fn4(0)["seq_idx"].shape == (4, 4, 2)
    for step in range(4):
        step1(s1, fn1(step))
    _, m4 = step4(s4, fn4(0))
    assert s4.step == s1.step == 4
    _same_params(s1, s4)
    assert np.isfinite(m4["loss/total"])


def test_device_sampling_trains_with_zero_host_input(packed_root):
    """data.device_sampling: the step takes no batch; the draws happen on
    the device from (seed, step). It trains (the loss falls over 12
    steps), and its draws index inside the bank."""
    cfg = _tiny(packed_root, "data.batch_size=8", "data.device_sampling=true",
                "train.optimizer=adam", "train.lr=2e-3")
    src = tframes.FrameFolderScenes(cfg.data)
    res = tloop._maybe_resident(cfg, src, CPU)
    state = tstep.init_state(cfg, device="cpu")
    step_fn = tstep.make_train_step(cfg, device="cpu", resident=res)
    losses = [step_fn(state)[1]["loss/total"] for _ in range(12)]
    assert np.isfinite(losses).all() and np.mean(losses[-3:]) < losses[0]
    meta = res.sample_meta()
    idx = res.device_draw(meta, _k_samp(0, 3), 64, "cpu")
    rows = meta["num_scenes"] * meta["num_views"] * meta["t_avail"]
    assert rows == res.frames.shape[0]
    for k in ("seq_idx", "tgt_idx"):
        assert 0 <= int(idx[k].min()) and int(idx[k].max()) < rows
    batch = res.device_sample(meta, _k_samp(0, 3), 64)
    assert batch["image_seq"].dtype == torch.uint8
    assert tuple(batch["image_seq"].shape) == (64, 2, 32, 32, 3)


@pytest.mark.parametrize("how", ["bank", "loop"])
def test_scene_sharded_residency_names_item_11(packed_root, how):
    """resident_sharding='scenes' (which waited for item 11): shard 1 of 2
    holds the second half of the scenes and nothing else, rows and poses
    equal to the whole bank's; a scene count the shards do not divide
    raises, as the JAX package's bank does. Through the loop, on one
    process, the one shard is the whole bank, and it needs device
    sampling."""
    cfg = _tiny(packed_root, "data.device_sampling=true",
                "data.resident_sharding=scenes")
    src = tframes.FrameFolderScenes(cfg.data)
    whole = tresident.ResidentFrames(src, cfg.data, device="cpu")
    if how == "bank":
        res = tresident.ResidentFrames(src, cfg.data, device="cpu",
                                       num_shards=2, shard=1)
        rows = res.num_views * res.t_avail
        assert (res.num_scenes, res.scene_offset) == (2, 2)
        assert res.nbytes == whole.nbytes // 2
        assert torch.equal(res.frames, whole.frames[2 * rows:])
        assert torch.equal(res.poses, whole.poses[2 * res.num_views:])
        assert res.sample_meta()["num_scenes"] == 2
        with pytest.raises(ValueError, match="divisible"):
            tresident.ResidentFrames(src, cfg.data, device="cpu",
                                     num_shards=3, shard=0)
        with pytest.raises(ValueError, match="needs its shard"):
            tresident.ResidentFrames(src, cfg.data, device="cpu",
                                     num_shards=2)
        with pytest.raises(ValueError, match="host index path"):
            res.index_batch(range(2))
    else:
        res = tloop._maybe_resident(cfg, src, CPU)
        assert res.num_shards == 1 and torch.equal(res.frames, whole.frames)
        with pytest.raises(ValueError, match="device_sampling"):
            tloop._maybe_resident(_tiny(packed_root,
                                        "data.resident_sharding=scenes"),
                                  src, CPU)


def test_streaming_rejects_resident_modes(packed_root, tmp_path):
    """Streaming pulls from an iterator; residency needs the whole bank up
    front: asking for both fails loudly."""
    for extra in ("data.device_sampling=true", "data.device_resident=on"):
        cfg = _tiny(packed_root, "data.streaming=true", extra,
                    f"train.ckpt_dir={tmp_path}")
        with pytest.raises(ValueError, match="streaming"):
            tloop.train(cfg, device="cpu")


def test_resident_disabled_for_png_and_off(packed_root, tmp_path):
    png_root = tframes.export_synthetic(str(tmp_path / "png"), num_scenes=2,
                                        image_size=32, num_views=3,
                                        seq_len=2, fmt="png")
    cfg = _tiny(png_root)
    src = tframes.FrameFolderScenes(cfg.data)
    with pytest.warns(UserWarning, match="resolved to OFF"):
        assert tloop._maybe_resident(cfg, src, CPU) is None  # not packed
    off = _tiny(packed_root, "data.device_resident=off")
    assert tloop._maybe_resident(
        off, tframes.FrameFolderScenes(off.data), CPU) is None
    with pytest.raises(ValueError, match="device_resident=on"):
        tloop._maybe_resident(_tiny(png_root, "data.device_resident=on"),
                              src, CPU)
    synthetic = tconfig.get_config("default", TINY)   # auto, quietly off
    assert tloop._maybe_resident(synthetic, object(), CPU) is None


@pytest.mark.parametrize("mode", ["orbit", "fixed"])
def test_device_sample_orbit_draws_distinct_views(packed_root, mode):
    """src_views='orbit' in device sampling: each frame of a drawn sequence
    from its own camera (distinct when V >= T), poses per frame; 'fixed'
    repeats one camera."""
    cfg = dataclasses.replace(_dcfg(packed_root), seq_len=3, src_views=mode)
    res = tresident.ResidentFrames(tframes.FrameFolderScenes(cfg), cfg,
                                   device="cpu")
    meta = res.sample_meta()
    assert meta["orbit"] == (mode == "orbit")
    b = res.device_sample(meta, _k_samp(5, 0), 16)
    spread = np.abs(np.diff(b["src_poses"].numpy(), axis=1)).max(axis=(1, 2))
    if mode == "orbit":
        assert (spread > 1e-6).all()
    else:
        assert (spread < 1e-6).all()


# (seed 7, step 11, 3 examples; V = 6 views, T = 4 frames of 5, K = 3)
META = {"num_scenes": 5, "num_views": 6, "t_avail": 5, "t_len": 4,
        "num_targets": 3, "orbit": True}
# the JAX package's draw (its device_sample from its step's sampling key)
PINNED = {
    "seq_idx": [[21, 12, 18, 4], [91, 102, 98, 114], [100, 96, 107, 93]],
    "tgt_idx": [[4, 24, 19], [114, 94, 119], [98, 118, 93]],
}


def test_device_draw_is_pinned_and_pure():
    """The device draw: in range, distinct targets (V >= K) and orbit
    sources (V >= T), a pure function of (seed, step, example index), and
    equal to the stored table of the JAX package's draw (so equal on every
    device that gives the table: chip_smoke.py holds the card to it)."""
    draw = tresident.ResidentFrames.device_draw
    idx = draw(META, _k_samp(7, 11), 3, "cpu")
    for k, want in PINNED.items():
        assert idx[k].tolist() == want, k
    big = draw(META, _k_samp(7, 11), 64, "cpu")
    for k in idx:                                  # pure in the index
        assert torch.equal(big[k][:3], idx[k])
    other = draw(META, _k_samp(7, 12), 64, "cpu")
    assert not torch.equal(other["seq_idx"], big["seq_idx"])
    v, t_avail = META["num_views"], META["t_avail"]
    scene = big["src_pose_idx"] // v
    src, tgt = big["src_pose_idx"] % v, big["tgt_pose_idx"] % v
    assert (scene < META["num_scenes"]).all()
    assert (big["tgt_pose_idx"] // v == scene[:, :1]).all()
    for row_s, row_t in zip(src.tolist(), tgt.tolist()):
        assert len(set(row_s)) == 4 and len(set(row_t)) == 3
    t0 = big["seq_idx"][:, 0] % t_avail
    assert (t0 <= t_avail - META["t_len"]).all()
    assert torch.equal(big["seq_idx"],
                       big["src_pose_idx"] * t_avail + t0[:, None]
                       + torch.arange(4))
    assert torch.equal(big["tgt_idx"], big["tgt_pose_idx"] * t_avail
                       + t0[:, None] + 3)
    # fewer views than draws: with replacement, still in range
    few = dict(META, num_views=2)
    small = draw(few, _k_samp(7, 11), 32, "cpu")
    assert int(small["src_pose_idx"].max()) < 5 * 2
    assert len(set((small["tgt_pose_idx"] % 2).flatten().tolist())) == 2


def test_materialized_tfrecords_ride_the_resident_path(tmp_path):
    """data.materialize_packed: a tfrecords source decodes once into
    in-memory banks, becomes resident-eligible, and a device-sampling step
    consumes no host batch."""
    root = ttfr.export_tfrecords(str(tmp_path / "t"), num_scenes=2,
                                 image_size=32, num_views=4, seq_len=2,
                                 dynamic=True, seed=0, shards=2)
    cfg = tconfig.get_config("default", TINY + [
        "data.source=tfrecords", f"data.root={root}",
        "data.materialize_packed=true", "data.device_sampling=true"])
    src = ttfr.TFRecordScenes(cfg.data)
    res = tloop._maybe_resident(cfg, src, CPU)
    assert isinstance(res, tresident.ResidentFrames)
    bank = src._packed(src.scenes[0])
    np.testing.assert_array_equal(bank[1, 1],
                                  src._read_frame(src.scenes[0], 1, 1))
    state = tstep.init_state(cfg, device="cpu")
    _, m = tstep.make_train_step(cfg, device="cpu", resident=res)(state)
    assert np.isfinite(m["loss/total"])


def _loop_cfg(root, ckpt, *extra):
    return tconfig.get_config("default", TINY + [
        "data.source=frames", f"data.root={root}", "data.num_scenes=2",
        "data.device_sampling=true", "train.steps_per_dispatch=2",
        "train.num_steps=4", "train.ckpt_every=2", "train.log_every=2",
        "train.optimizer=adam", f"train.ckpt_dir={ckpt}", *extra])


def test_device_sampling_loop_resumes_exactly(tmp_path):
    """The c3md data settings at a tiny size: the frames source with an
    empty root (SyntheticFrames), materialized, resident by auto, device
    sampled, two steps a dispatch. A run killed after its first dispatch
    and resumed ends bitwise equal to an uninterrupted one."""
    with pytest.warns(UserWarning, match="SyntheticFrames"):
        straight, _ = tloop.train(_loop_cfg(
            "", tmp_path / "a", "data.materialize_packed=true"),
            device="cpu")
    with pytest.raises(tloop.FaultInjected):
        tloop.train(_loop_cfg("", tmp_path / "b",
                              "data.materialize_packed=true",
                              "train.fail_after_step=1"), device="cpu")
    resumed, _ = tloop.train(_loop_cfg("", tmp_path / "b",
                                       "data.materialize_packed=true"),
                             device="cpu")
    assert straight.step == resumed.step == 4
    _same_params(straight, resumed)
    for p_a, p_b in zip(straight.module.parameters(),
                        resumed.module.parameters()):
        sa, sb = straight.optimizer.state[p_a], resumed.optimizer.state[p_b]
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])
