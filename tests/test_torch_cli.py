"""The port's CLIs (cli/train.py, cli/eval.py, cli/predict.py) and the
checkpoint API on the CPU, mirroring tests/test_api.py's round trip,
functional predict, multi-source and eval cases.

cli.eval prints the JAX CLI's JSON keys with the same provenance values
on the same checkpoint directory (one the JAX package wrote, which the port
reads); PSNR and SSIM are held within 1e-3 dB and 1e-4 of JAX's: the
models agree to 1e-4 and the two synthetic renderers bit for bit
(tests/test_torch_data.py), so the targets are the same. PNGs are read
back with imageio. cli.export_model turns a port model dir and a JAX one
into artifacts that serve what the live models predict (a JAX serving
artifact: tests/test_torch_jax_artifact.py). cli.train takes the JAX
CLI's ``--parallel-mode``.
"""

import json
import os

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from dynamic_multiview_3d_torch import api as tapi
from dynamic_multiview_3d_torch import config as tconfig
from dynamic_multiview_3d_torch import weights
from dynamic_multiview_3d_torch.api import Model as TModel
from dynamic_multiview_3d_torch import serving
from dynamic_multiview_3d_torch.cli import eval as teval_cli
from dynamic_multiview_3d_torch.cli import export_model as texport_cli
from dynamic_multiview_3d_torch.cli import predict as tpredict_cli
from dynamic_multiview_3d_torch.cli import train as ttrain_cli
from dynamic_multiview_3d_torch.data import pipeline
from dynamic_multiview_3d_torch.data.synthetic import (random_poses,
                                                       smooth_images,
                                                       to_uint8)
from dynamic_multiview_3d_tpu import config as jconfig
from dynamic_multiview_3d_tpu.api import Model as JModel
from dynamic_multiview_3d_tpu.cli import eval as jeval_cli

SMALL = ["model.image_size=32", "model.num_levels=3", "model.base_features=8",
         "model.max_features=16", "model.gru_features=16",
         "model.pose_embed_dim=8", "model.dtype=float32",
         "model.use_pallas=False", "data.image_size=32"]


@pytest.fixture(scope="module")
def model():
    return TModel.init_random(tconfig.get_config("default", SMALL), seed=0,
                              device="cpu")


def test_checkpoint_roundtrip(model, rng, tmp_path):
    path = str(tmp_path / "ckpt")
    model.save_checkpoint(path, step=5)
    restored = TModel.from_checkpoint(path, device="cpu")
    assert restored.cfg == model.cfg
    seq = rng.uniform(-1, 1, (1, 1, 32, 32, 3)).astype(np.float32)
    tgt = rng.uniform(0, 1, (1, 2, 3)).astype(np.float32) + [0, 0, 1]
    assert torch.equal(model.predict(seq, tgt), restored.predict(seq, tgt))


def test_functional_predict(model, rng, tmp_path):
    path = str(tmp_path / "ckpt2")
    model.save_checkpoint(path)
    seq = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    tgt = rng.uniform(0, 1, (2, 3)).astype(np.float32) + [0, 0, 1]
    views = tapi.predict(path, seq, tgt, device="cpu")
    assert views.shape == (2, 32, 32, 3)
    assert torch.equal(views, model.predict(seq, tgt))


def test_predict_multisource_requires_source_poses(rng, tmp_path):
    """A multi-source checkpoint refuses the canonical-pose default."""
    cfg = tconfig.get_config("default", SMALL + ["model.synthesis=multidepth"])
    path = str(tmp_path / "md")
    TModel.init_random(cfg, seed=0, device="cpu").save_checkpoint(path)
    seq = rng.uniform(-1, 1, (2, 3, 32, 32, 3)).astype(np.float32)
    tgt = rng.uniform(0, 1, (2, 1, 3)).astype(np.float32) + [0, 0, 1]
    with pytest.raises(ValueError, match="source_poses"):
        tapi.predict(path, seq, tgt, device="cpu")
    src = rng.uniform(0, 1, (2, 3, 3)).astype(np.float32) + [0, 0, 1]
    views = tapi.predict(path, seq, tgt, device="cpu", source_poses=src)
    assert views.shape == (2, 1, 32, 32, 3)


def _eval_ckpt(tmp_path, **data):
    """test_api.py's eval model (max_features 32, pose_embed_dim 16, T = 2,
    K = 2; ``data`` overrides its data config), saved by the JAX package
    with the port's seeded weights."""
    cfg = tconfig.Config(
        model=tconfig.ModelConfig(
            image_size=32, num_levels=3, base_features=8, max_features=32,
            gru_features=16, pose_embed_dim=16, dtype="float32",
            use_pallas=False, warp_precision="exact"),
        data=tconfig.DataConfig(**{**dict(image_size=32, seq_len=2,
                                          num_targets=2, num_scenes=4),
                                   **data}),
    )
    params = weights.to_flax(
        TModel.init_random(cfg, seed=0, device="cpu").module.state_dict())
    ckpt = str(tmp_path / "model")
    JModel(jconfig.from_dict(tconfig.to_dict(cfg)), params) \
        .save_checkpoint(ckpt, step=7)
    return ckpt


def test_eval_cli_matches_jax_and_writes_grid(tmp_path, capsys):
    ckpt = _eval_ckpt(tmp_path)
    argv = ["--ckpt", ckpt, "--num-batches", "1", "--batch-size", "2"]
    jeval_cli.main(argv)
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    grid = str(tmp_path / "grid.png")
    teval_cli.main(argv + ["--grid", grid, "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == set(ref) | {"grid"}
    for k in set(ref) - {"psnr", "ssim"}:
        assert out[k] == ref[k], k
    assert out["ckpt_step"] == 7 and out["grid"] == grid
    assert abs(out["psnr"] - ref["psnr"]) < 1e-3, (out["psnr"], ref["psnr"])
    assert abs(out["ssim"] - ref["ssim"]) < 1e-4, (out["ssim"], ref["ssim"])
    img = imageio.imread(grid)
    assert img.shape == (4 * 32, 3 * 32, 3) and img.dtype == np.uint8


def test_eval_cli_reads_a_frames_export(tmp_path, capsys):
    """--data-root on a frames checkpoint reaches the port's frames source:
    on a scene-disjoint export the JAX package wrote, the same metrics and
    provenance as the JAX eval CLI."""
    from dynamic_multiview_3d_tpu.data import frames as jframes
    root = jframes.export_synthetic(str(tmp_path / "d"), num_scenes=2,
                                    image_size=32, num_views=4, seq_len=2,
                                    fmt="packed", scene_offset=10)
    ckpt = _eval_ckpt(tmp_path, source="frames")
    argv = ["--ckpt", ckpt, "--num-batches", "1", "--batch-size", "2",
            "--data-root", root, "--protocol", "scene-holdout"]
    jeval_cli.main(argv)
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    teval_cli.main(argv + ["--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k in set(ref) - {"psnr", "ssim"}:
        assert out[k] == ref[k], k
    assert (out["data_source"], out["data_root"], out["protocol"]) == \
        ("frames", root, "scene-holdout")
    assert abs(out["psnr"] - ref["psnr"]) < 1e-3, (out["psnr"], ref["psnr"])
    assert abs(out["ssim"] - ref["ssim"]) < 1e-4, (out["ssim"], ref["ssim"])


def test_eval_cli_protocol_flags(tmp_path, capsys, model):
    ckpt = str(tmp_path / "m")
    model.save_checkpoint(ckpt, step=1)
    with pytest.raises(SystemExit):               # not a frames checkpoint
        teval_cli.main(["--ckpt", ckpt, "--data-root", "/nowhere",
                        "--device", "cpu"])
    capsys.readouterr()
    teval_cli.main(["--ckpt", ckpt, "--num-batches", "1", "--batch-size",
                    "1", "--holdout-scenes", "3", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["protocol"] == "scene-holdout"
    assert (out["scene_offset"], out["num_scenes"]) == \
        (model.cfg.data.num_scenes, 3)
    assert np.isfinite(out["psnr"]) and -1 <= out["ssim"] <= 1


def test_predict_cli_writes_pngs(tmp_path, capsys, model):
    ckpt = str(tmp_path / "m")
    model.save_checkpoint(ckpt)
    out = tmp_path / "views"
    tpredict_cli.main(["--ckpt", ckpt, "--scene", "1", "--azimuths",
                       "0,45,90", "--out", str(out), "--device", "cpu"])
    assert "wrote 4 images" in capsys.readouterr().out
    assert sorted(os.listdir(out)) == ["source.png", "view_00.png",
                                       "view_01.png", "view_02.png"]
    ex = pipeline.make_source(model.cfg.data).example(1)
    np.testing.assert_array_equal(imageio.imread(out / "source.png"),
                                  to_uint8(ex["image_seq"][-1]))
    az = np.deg2rad([0.0, 45.0, 90.0])
    tgt = np.stack([az, np.full(3, 0.3), np.full(3, ex["src_poses"][0, 2])],
                   -1).astype(np.float32)
    views = model.predict(ex["image_seq"], tgt, source_poses=ex["src_poses"])
    for i in range(3):
        np.testing.assert_array_equal(
            imageio.imread(out / f"view_{i:02d}.png"),
            to_uint8(views[i].numpy()))


def test_train_cli_tiny_run(tmp_path, capsys):
    """cli.train on the CPU: 2 steps with TensorBoard (scalars and the
    image grid at the checkpoint step), the NaN tripwire, a trace window
    and the JAX CLI's ``--parallel-mode auto``; the model dir predicts."""
    sets = SMALL + ["data.batch_size=2", "data.num_scenes=2",
                    "train.num_steps=2", "train.log_every=1",
                    "train.ckpt_every=2",
                    f"train.ckpt_dir={tmp_path / 'ckpt'}"]
    argv = [a for s in sets for a in ("--set", s)]
    state, metrics = ttrain_cli.main(
        argv + ["--logdir", str(tmp_path / "logs"), "--debug-nans",
                "--profile-dir", str(tmp_path / "trace"),
                "--profile-steps", "0", "1", "--device", "cpu",
                "--parallel-mode", "auto"])
    assert state.step == 2 and np.isfinite(metrics["loss/total"])
    assert "'loss/total'" in capsys.readouterr().out
    logs = sorted(os.listdir(tmp_path / "logs"))
    assert "metrics.jsonl" in logs
    assert any(f.startswith("events.out.tfevents") for f in logs), logs
    assert os.listdir(tmp_path / "trace") == ["trace_steps_0-1.json"]
    model = TModel.from_checkpoint(str(tmp_path / "ckpt" / "model"),
                                   device="cpu")
    rng = np.random.default_rng(0)
    views = model.predict(rng.uniform(-1, 1, (1, 32, 32, 3)),
                          random_poses(rng, 1, 2)[0])
    assert views.shape == (2, 32, 32, 3) and bool(torch.isfinite(views).all())


def test_train_cli_auto_mode_refuses_a_scene_sharded_bank(tmp_path):
    """``--parallel-mode`` takes the JAX CLI's choices ("auto" trains:
    test_train_cli_tiny_run); "auto" refuses a scene-sharded resident
    bank with the JAX loop's own message, before any data is made."""
    from dynamic_multiview_3d_tpu.train import loop as jloop
    scenes = ["data.source=frames", "data.device_resident=auto",
              "data.device_sampling=true", "data.resident_sharding=scenes"]
    with pytest.raises(ValueError) as jax_err:
        jloop._maybe_resident(jconfig.get_config("default", SMALL + scenes),
                              None, None, parallel_mode="auto")
    sets = SMALL + scenes + [f"train.ckpt_dir={tmp_path / 'ckpt'}"]
    with pytest.raises(ValueError) as err:
        ttrain_cli.main([a for s in sets for a in ("--set", s)] + [
            "--logdir", str(tmp_path / "logs"), "--device", "cpu",
            "--parallel-mode", "auto"])
    assert str(err.value) == str(jax_err.value)
    with pytest.raises(SystemExit):
        ttrain_cli.build_parser().parse_args(["--parallel-mode", "gspmd"])


def _export(ckpt, out, capsys, *extra):
    """cli.export_model on the CPU; -> (its check line, its last line)."""
    texport_cli.main(["--ckpt", ckpt, "--out", out, "--batch", "2",
                      "--num-targets", "2", "--device", "cpu",
                      "--platforms", "cpu", "cuda", *extra])
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-2]), json.loads(lines[-1])


def test_export_model_cli_serves_a_port_model_dir(tmp_path, capsys):
    """A model dir the port wrote becomes an artifact whose views are the
    live model's, bit for bit, at each exported T (shared multidepth
    heads at T = 2 and 3)."""
    cfg = tconfig.get_config("default", SMALL + [
        "model.synthesis=multidepth", "data.src_views=orbit",
        "data.seq_len=3"])
    model = TModel.init_random(cfg, seed=0, device="cpu")
    ckpt, out = str(tmp_path / "model"), str(tmp_path / "m.dmv3d")
    model.save_checkpoint(ckpt, step=3)
    check, line = _export(ckpt, out, capsys, "--seq-len", "2", "3")
    assert check["check"] == {"device": "cpu",
                              "max_abs_err_by_T": {"2": 0.0, "3": 0.0}}
    assert line["out"] == out and line["synthesis"] == "multidepth"
    assert line["custom_ops"] == ["dmv3d::multiflow_composite_fwd"]
    served = serving.ServedModel.load(out, device="cpu")
    rng = np.random.default_rng(0)
    for t in (2, 3):
        seq = rng.uniform(-1, 1, (2, t, 32, 32, 3)).astype(np.float32)
        src, tgt = random_poses(rng, 2, t), random_poses(rng, 2, 2)
        assert torch.equal(served.predict(seq, tgt, source_poses=src),
                           model.predict(seq, tgt, source_poses=src))


def test_export_model_cli_reads_a_jax_model_dir(tmp_path, capsys):
    """A model dir the JAX package wrote (read by the port's own Orbax
    reader) becomes a port artifact that serves what the JAX model predicts,
    within the model tolerance 1e-4."""
    ckpt = _eval_ckpt(tmp_path)
    out = str(tmp_path / "j.dmv3d")
    check, line = _export(ckpt, out, capsys)
    assert check["check"]["max_abs_err_by_T"] == {"2": 0.0}
    assert line["param_names"] == sorted(
        TModel.from_checkpoint(ckpt, device="cpu").module.state_dict())
    served = serving.ServedModel.load(out, device="cpu")
    rng = np.random.default_rng(1)
    seq = smooth_images(rng, 2, 2, 32)
    src, tgt = random_poses(rng, 2, 2), random_poses(rng, 2, 2)
    want = np.asarray(JModel.from_checkpoint(ckpt).predict(
        seq, tgt, source_poses=src))
    np.testing.assert_allclose(
        served.predict(seq, tgt, source_poses=src).numpy(), want,
        rtol=1e-4, atol=1e-4)


def test_export_model_cli_defaults_to_the_card(model, tmp_path):
    """No fallback: without a GPU the CLI raises unless asked for the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    ckpt = str(tmp_path / "model")
    model.save_checkpoint(ckpt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        texport_cli.main(["--ckpt", ckpt, "--out", str(tmp_path / "a")])
    with pytest.raises(SystemExit):
        texport_cli.main(["--ckpt", ckpt, "--out", str(tmp_path / "a"),
                          "--platforms", "tpu"])
