"""The port's serving artifact (serving.py) on the CPU, mirroring
tests/test_serving.py case by case, on the tiny f32 config of that file
(``mesh`` on one process here; on two, tests/test_torch_parallel.py).

A port artifact holds ``torch.export`` programs whose kernels are the
registered ``dmv3d::`` operators; on the CPU those run the plain versions.
It is held to the live port model at 1e-5 (and is bitwise equal to it:
the program runs the same operators on the same inputs; only the frame's
staging copy, which moves no value, is added) and to the JAX package's
served artifact on the same weights at 1e-4 (the model tolerance of
tests/test_torch_model.py; smooth inputs, exact warps); the JAX
artifact loaded by the port is held to both. The depth export,
which failed while the kernels read ``data_ptr`` outside an operator,
round-trips too. ``torch.library.opcheck`` holds the five forward
operators' schemas, fake (shape) functions and their tracing under
AOTAutograd. The multidepth artifact is also served in a fresh process
that imports neither the port's model code nor JAX.
"""

import io
import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

from dynamic_multiview_3d_torch import config as tconfig
from dynamic_multiview_3d_torch import serving, weights
from dynamic_multiview_3d_torch.api import Model as TModel
from dynamic_multiview_3d_torch.data.synthetic import (random_poses,
                                                       smooth_images)
from dynamic_multiview_3d_torch.kernels import _build
from dynamic_multiview_3d_torch.kernels import grid_sample as tgs
from dynamic_multiview_3d_torch.kernels import multiflow as tmf
from dynamic_multiview_3d_torch.kernels import reproject as trp
from dynamic_multiview_3d_torch.parallel import mesh as tmesh

HW, B, K = 32, 2, 2
TINY = ["model.image_size=32", "model.num_levels=3", "model.base_features=8",
        "model.max_features=32", "model.gru_features=16",
        "model.pose_embed_dim=16", "model.dtype=float32",
        "model.use_pallas=False", "model.warp_precision=exact",
        "data.image_size=32", "data.seq_len=2", "data.num_targets=2"]
MULTIDEPTH = ["model.synthesis=multidepth", "data.src_views=orbit"]
VARIANTS = {"flow": ([], None),
            "depth": (["model.synthesis=depth", "model.predict_depth=true"],
                      None),
            "flow_geo": (["model.predict_depth=true"], None),
            "multidepth": (MULTIDEPTH + ["data.seq_len=4"], (2, 4))}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tiny models (see
    tests/test_torch_stream.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(extra):
    return tconfig.override(tconfig.Config(), TINY + list(extra))


def _jax(cfg, params=None):
    """The JAX package's serving module and a JAX Model of ``cfg`` on
    ``params`` (a flax tree; None: JAX's own seeded init). JAX is imported
    here, so that the ``cuda`` tests run where it is absent."""
    from dynamic_multiview_3d_tpu import config as jconfig
    from dynamic_multiview_3d_tpu import serving as jserving
    from dynamic_multiview_3d_tpu.api import Model as JModel
    jcfg = jconfig.from_dict(tconfig.to_dict(cfg))
    model = JModel.init_random(jcfg, seed=0) if params is None \
        else JModel(jcfg, params)
    return jserving, model


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory, _one_thread):
    """{variant: (port Model, artifact path, manifest)}, each model on
    seeded random weights (seed 0)."""
    root = tmp_path_factory.mktemp("serve")
    out = {}
    for name, (extra, seq_len) in VARIANTS.items():
        model = TModel.init_random(_cfg(extra), seed=0, device="cpu")
        path = str(root / f"{name}.dmv3d")
        manifest = serving.export_predict(model, path, batch=B,
                                          seq_len=seq_len, num_targets=K)
        out[name] = (model, path, manifest)
    return out


def _inputs(rng, t, k=K):
    return (smooth_images(rng, B, t, HW), random_poses(rng, B, t),
            random_poses(rng, B, k))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_export_roundtrip_matches_live_model(artifacts, variant):
    """Every exported T serves what the live port model predicts: within
    1e-5, and in fact bit for bit."""
    model, path, manifest = artifacts[variant]
    served = serving.ServedModel.load(path, device="cpu")
    rng = np.random.default_rng(1)
    for t in served.seq_lens:
        seq, src, tgt = _inputs(rng, t)
        got = served.predict(seq, tgt, source_poses=src)
        want = model.predict(seq, tgt, source_poses=src)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        assert list(got.shape) == manifest["view"]
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        assert torch.equal(got, want), (variant, t)


@pytest.mark.parametrize("variant", ["flow", "depth", "multidepth"])
def test_served_views_match_the_jax_artifact(artifacts, tmp_path, variant):
    """The port's artifact and the JAX package's, exported from the same
    weights (the port's seeded init as a flax tree), serve the same views
    within 1e-4 at every exported T. The JAX artifact loaded by the port
    (its programs traced from the artifact's config and weights) serves
    them too: within 1e-4 of JAX's served views and bitwise the port
    artifact's."""
    model, path, _ = artifacts[variant]
    seq_len = VARIANTS[variant][1]
    jserving, jmodel = _jax(model.cfg,
                            weights.to_flax(model.module.state_dict()))
    jpath = str(tmp_path / "jax.dmv3d")
    jserving.export_predict(jmodel, jpath, batch=B, seq_len=seq_len,
                            num_targets=K)
    ref = jserving.ServedModel.load(jpath)
    ours = serving.ServedModel.load(path, device="cpu")
    converted = serving.ServedModel.load(jpath, device="cpu")
    assert ours.seq_lens == ref.seq_lens == converted.seq_lens
    rng = np.random.default_rng(2)
    for t in ours.seq_lens:
        seq, src, tgt = _inputs(rng, t)
        want = np.asarray(ref.predict(seq, tgt, source_poses=src))
        got = ours.predict(seq, tgt, source_poses=src)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4,
                                   err_msg=f"{variant} T={t}")
        views = converted.predict(seq, tgt, source_poses=src)
        np.testing.assert_allclose(views.numpy(), want, rtol=1e-4,
                                   atol=1e-4, err_msg=f"{variant} T={t}")
        assert torch.equal(views, got), (variant, t)


def test_manifest_lists_the_operators_and_keeps_the_jax_keys(artifacts):
    """Every key of the JAX manifest but ``custom_calls``, which becomes
    ``custom_ops``: the sorted ``dmv3d::`` operators the programs call
    (the staging copy and the synthesis's forward kernels)."""
    want = {"flow": ["dmv3d::stage", "dmv3d::warp_composite_fwd"],
            "depth": ["dmv3d::reproject_composite_fwd", "dmv3d::sample_fwd",
                      "dmv3d::stage"],
            "flow_geo": ["dmv3d::reproject_sample_fwd", "dmv3d::stage",
                         "dmv3d::warp_composite_fwd"],
            "multidepth": ["dmv3d::multiflow_composite_fwd"]}
    for variant, (_, _, manifest) in artifacts.items():
        assert manifest["custom_ops"] == want[variant], variant
        assert manifest["format"] == "torch.export"
        assert manifest["platforms"] == ["cpu", "cuda"]
        for key in ("version", "image_seq", "src_poses", "tgt_poses", "view",
                    "signatures", "param_names", "default_pose", "synthesis",
                    "src_views", "trained_seq_len"):
            assert key in manifest, key
        assert "custom_calls" not in manifest


def test_artifact_is_self_contained(artifacts):
    """The zip carries the program, the weights as a plain npz (float32,
    the port's state-dict names), the config and the manifest."""
    model, path, manifest = artifacts["flow"]
    with zipfile.ZipFile(path) as z:
        assert {"predict.pt2", "params.npz", "config.json",
                "manifest.json"} <= set(z.namelist())
        with np.load(io.BytesIO(z.read("params.npz"))) as npz:
            assert sorted(npz.files) == manifest["param_names"] \
                == sorted(model.module.state_dict())
            assert all(npz[k].dtype == np.float32 for k in npz.files)
        cfg = json.loads(z.read("config.json"))
        assert cfg["model"]["image_size"] == HW


def test_weights_stay_outside_the_program(artifacts):
    """The program holds no parameter, buffer or example input (which
    would be the weights again): the weights are its first input."""
    _, path, manifest = artifacts["flow"]
    with zipfile.ZipFile(path) as z:
        blob = z.read("predict.pt2")
    with zipfile.ZipFile(io.BytesIO(blob)) as inner:
        assert not sum(i.file_size for i in inner.infolist()
                       if "sample_inputs" in i.filename)
    program = torch.export.load(io.BytesIO(blob))
    assert not program.state_dict and not program.constants
    assert program.example_inputs is None
    inputs = [s for s in program.graph_signature.input_specs]
    assert len(inputs) == len(manifest["param_names"]) + 3


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_programs_move_whole_to_another_device(artifacts, variant):
    """The loader's move of the programs (``move_to_device_pass``) leaves
    no tensor or device argument on the CPU: loaded on the meta device,
    every program runs on meta inputs, where a CPU tensor left behind
    would raise, and gives the manifest's shape."""
    _, path, manifest = artifacts[variant]
    served = serving.ServedModel.load(path, device="meta")
    for t in served.seq_lens:
        sig = manifest["signatures"][str(t)]
        args = [torch.zeros(shape, device="meta") for shape in (
            sig["image_seq"], sig["src_poses"], manifest["tgt_poses"])]
        with torch.inference_mode():
            view = served.call_for(t)(served.params, *args)
        assert view.device.type == "meta"
        assert list(view.shape) == manifest["view"]


def test_fixed_shape_contract_is_loud(artifacts):
    _, path, _ = artifacts["flow"]
    served = serving.ServedModel.load(path, device="cpu")
    rng = np.random.default_rng(3)
    seq_bad = rng.uniform(-1, 1, (1, 2, HW, HW, 3)).astype(np.float32)
    tgt = rng.uniform(0, 1, (1, K, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="fixed-shape"):
        served.predict(seq_bad, tgt)


def _rewrite(path, out, **edit):
    """A copy of the artifact ``path`` at ``out`` with the manifest keys in
    ``edit`` replaced (a value of None deletes the key)."""
    with zipfile.ZipFile(path) as z:
        entries = {n: z.read(n) for n in z.namelist()}
    manifest = json.loads(entries["manifest.json"])
    for k, v in edit.items():
        if v is None:
            del manifest[k]
        else:
            manifest[k] = v
    entries["manifest.json"] = json.dumps(manifest)
    with zipfile.ZipFile(out, "w") as z:
        for n, blob in entries.items():
            if n.startswith("predict_T") and "signatures" not in manifest:
                continue
            z.writestr(n, blob)
    return str(out)


def test_future_version_rejected(artifacts, tmp_path):
    _, path, _ = artifacts["flow"]
    future = _rewrite(path, tmp_path / "future.dmv3d",
                      version=serving.MANIFEST_VERSION + 1)
    with pytest.raises(ValueError, match="newer"):
        serving.ServedModel.load(future, device="cpu")


def test_an_unregistered_operator_is_named(artifacts, tmp_path):
    """The loader checks the manifest's operators before it loads a
    program, and names the one this process lacks."""
    _, path, manifest = artifacts["flow"]
    bad = _rewrite(path, tmp_path / "bad.dmv3d", custom_ops=manifest[
        "custom_ops"] + ["dmv3d::not_registered"])
    with pytest.raises(RuntimeError, match="dmv3d::not_registered"):
        serving.ServedModel.load(bad, device="cpu")


def test_default_pose_rides_in_the_manifest(artifacts):
    """predict(source_poses=None) takes the pose from the manifest (no
    model code imported)."""
    _, path, manifest = artifacts["flow"]
    assert manifest["default_pose"] == [0.0, 0.3, 2.0]
    served = serving.ServedModel.load(path, device="cpu")
    m = served.manifest
    rng = np.random.default_rng(4)
    seq = rng.uniform(-1, 1, m["image_seq"]).astype(np.float32)
    tgt = rng.uniform(0.2, 1.0, m["tgt_poses"]).astype(np.float32)
    got = served.predict(seq, tgt)
    src = np.broadcast_to(np.asarray(m["default_pose"], np.float32),
                          tuple(m["src_poses"]))
    want = served.predict(seq, tgt, source_poses=src)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_multi_seq_len_artifact_dispatches_on_source_count(artifacts,
                                                           tmp_path):
    """seq_len=(2, 4) exports one program per T into one artifact; the
    loader dispatches on image_seq.shape[1] (each T matching the live
    model is test_export_roundtrip_matches_live_model's); an unexported T
    is loud, and a manifest without "signatures" serves its primary T."""
    model, path, manifest = artifacts["multidepth"]
    assert sorted(manifest["signatures"]) == ["2", "4"]
    served = serving.ServedModel.load(path, device="cpu")
    assert served.seq_lens == (2, 4)
    rng = np.random.default_rng(5)
    seq3, src3, tgt = _inputs(rng, 3)
    with pytest.raises(ValueError, match="T in \\[2, 4\\]"):
        served.predict(seq3, tgt, source_poses=src3)
    legacy = serving.ServedModel.load(
        _rewrite(path, tmp_path / "legacy.dmv3d", signatures=None),
        device="cpu")
    assert legacy.seq_lens == (2,)
    seq, src, tgt = _inputs(rng, 2)
    torch.testing.assert_close(legacy.predict(seq, tgt, source_poses=src),
                               model.predict(seq, tgt, source_poses=src),
                               rtol=1e-5, atol=1e-5)


def test_multisource_artifact_requires_source_poses(artifacts):
    """A multidepth artifact records its synthesis and trained source
    count and refuses the default pose."""
    _, path, manifest = artifacts["multidepth"]
    assert manifest["synthesis"] == "multidepth"
    assert manifest["trained_seq_len"] == 4
    assert manifest["src_views"] == "orbit"
    served = serving.ServedModel.load(path, device="cpu")
    seq, _, tgt = _inputs(np.random.default_rng(6), 2)
    with pytest.raises(ValueError, match="source_poses"):
        served.predict(seq, tgt)


def test_baked_heads_export_only_their_source_count(tmp_path):
    """Baked multi-source heads are made for one T: exporting another
    fails at trace time, as in the JAX package."""
    model = TModel.init_random(_cfg(MULTIDEPTH + [
        "model.multi_head_mode=baked"]), seed=0, device="cpu")
    with pytest.raises(ValueError, match="made for 2 sources"):
        serving.export_predict(model, str(tmp_path / "b.dmv3d"), batch=B,
                               seq_len=(2, 3), num_targets=K)


def test_a_jax_artifact_is_refused(tmp_path):
    """A JAX package artifact (StableHLO programs), which the loader once
    refused, is served: single-source at B = K = 1, within 1e-4 of the
    JAX package's served views, the StableHLO never read. What is refused
    now is a JAX manifest newer than the JAX package's version, named
    against it."""
    jserving, jmodel = _jax(_cfg([]))
    jpath = str(tmp_path / "jax.dmv3d")
    jserving.export_predict(jmodel, jpath, batch=1, num_targets=1)
    served = serving.ServedModel.load(jpath, device="cpu")
    assert served.seq_lens == (2,)
    seq, src, tgt = _inputs(np.random.default_rng(9), 2, k=1)
    want = np.asarray(jserving.ServedModel.load(jpath).predict(
        seq[:1], tgt[:1], source_poses=src[:1]))
    np.testing.assert_allclose(served.predict(
        seq[:1], tgt[:1], source_poses=src[:1]).numpy(), want, rtol=1e-4,
        atol=1e-4)
    newer = _rewrite(jpath, tmp_path / "newer.dmv3d",
                     version=jserving.MANIFEST_VERSION + 1)
    with pytest.raises(ValueError, match="newer than the JAX package's "
                                         "MANIFEST_VERSION 1"):
        serving.ServedModel.load(newer, device="cpu")


def test_mesh_serving_waits_for_data_parallelism(artifacts, tmp_path):
    """predict(mesh=), which waited for data parallelism: on a
    one-process mesh it is the unsharded request, bitwise; a mesh that is
    not a ``parallel.mesh.Mesh``, a batch the ranks do not divide and a
    version 1 artifact (its programs take the exported batch only) are
    refused. Two ranks: tests/test_torch_parallel.py."""
    _, path, manifest = artifacts["flow"]
    assert manifest["version"] == serving.MANIFEST_VERSION == 2
    served = serving.ServedModel.load(path, device="cpu")
    seq, src, tgt = _inputs(np.random.default_rng(7), 2)
    want = served.predict(seq, tgt, source_poses=src)
    cpu = torch.device("cpu")
    got = served.predict(seq, tgt, source_poses=src,
                         mesh=tmesh.Mesh(device=cpu))
    assert torch.equal(got, want)
    with pytest.raises(TypeError, match="Mesh"):
        served.predict(seq, tgt, source_poses=src, mesh=object())
    with pytest.raises(ValueError, match="divisible"):
        served.predict(seq, tgt, source_poses=src,
                       mesh=tmesh.Mesh(world_size=3, device=cpu))
    old = serving.ServedModel.load(
        _rewrite(path, tmp_path / "v1.dmv3d", version=1), device="cpu")
    with pytest.raises(ValueError, match="re-export"):
        old.predict(seq, tgt, source_poses=src, mesh=tmesh.Mesh(device=cpu))


def test_load_defaults_to_the_card(artifacts):
    """No fallback: without a GPU, a load that does not ask for the CPU
    raises."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    _, path, _ = artifacts["flow"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.ServedModel.load(path)


def _op_cases():
    """(operator, args) for each forward operator on small seeded inputs:
    2 frames shared by K = 2 targets each (the multi-source operator: 2
    examples of 3 sources); the single-source image also staged, the
    layout the model hands over on the card."""
    g = torch.Generator().manual_seed(0)

    def u(*shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=g) * (hi - lo) + lo
    n_src, n, c, h, w = 2, 4, 3, 6, 8
    p = h * w
    img = u(n_src, c, h, w)
    ix, iy = u(n, p, lo=-2, hi=w + 1), u(n, p, lo=-2, hi=h + 1)
    mask, rgb = u(n, p), u(n, c, p)
    depth = u(n, p, lo=0.5, hi=3.0)
    cam = torch.eye(3).expand(n, 3, 3) * torch.tensor([8.0, 8.0, 1.0])
    cam = cam.clone()
    cam[:, 0, 2], cam[:, 1, 2] = 3.5, 2.5
    rel = torch.eye(4).expand(n, 4, 4).clone()
    rel[:, :3, 3] = u(n, 3, lo=-0.2, hi=0.2)
    params = trp.host_params(cam, rel)
    t = 3
    imgs = u(2, t, c, h, w)
    mix, miy = u(2, t, p, lo=-2, hi=w + 1), u(2, t, p, lo=-2, hi=h + 1)
    cases = []
    for img_in in (img, _build.stage(img)):
        for prec in ("exact", "fast"):
            cases += [
                (tgs.warp_composite_fwd,
                 (img_in, ix, iy, mask, rgb, "border", prec)),
                (tgs.sample_fwd, (img_in, ix[:n_src], iy[:n_src], "zeros",
                                  prec)),
                (trp.reproject_sample_fwd, (img_in, depth, params, prec)),
                (trp.reproject_composite_fwd,
                 (img_in, depth, params, mask, rgb, prec))]
    for padding in ("border", "zeros"):
        cases.append((tmf.multiflow_composite_fwd,
                      (imgs, mix, miy, u(2, t, p, lo=-1, hi=1), u(2, p),
                       u(2, c, p), padding, "fast")))
    return cases


@pytest.mark.parametrize("case", range(18))
def test_opcheck_forward_operators(case):
    """``torch.library.opcheck`` on each forward operator (schema, fake
    function against the CPU implementation, autograd registration,
    AOTAutograd with dynamic shapes)."""
    op, args = _op_cases()[case]
    torch.library.opcheck(op, args)


FRESH = """
import sys
import numpy as np
sys.path.insert(0, {root!r})
from dynamic_multiview_3d_torch import serving
served = serving.ServedModel.load({path!r}, device="cpu")
m = served.manifest
rng = np.random.default_rng(0)
for t in served.seq_lens:
    seq = rng.uniform(-1, 1, (2, t, 32, 32, 3)).astype(np.float32)
    src = (rng.uniform(0, 1, (2, t, 3)) + [0, 0, 1]).astype(np.float32)
    tgt = (rng.uniform(0, 1, m["tgt_poses"]) + [0, 0, 1]).astype(np.float32)
    out = served.predict(seq, tgt, source_poses=src)
    assert bool(np.isfinite(out.numpy()).all())
    np.save({out!r}.format(t), out.numpy())
bad = sorted(n for n in sys.modules if n == "jax" or n.startswith("jax.")
             or n.startswith("dynamic_multiview_3d_tpu")
             or n.startswith("dynamic_multiview_3d_torch.models"))
print("FRESH_OK", served.seq_lens, bad)
"""


def test_multidepth_artifact_serves_in_a_fresh_process(artifacts, tmp_path):
    """A fresh interpreter loads the multidepth artifact and serves both
    its T with torch, numpy and the kernel modules only: afterwards no
    module of the port's model code, of jax or of the JAX package is
    loaded, and its views equal this process's."""
    _, path, _ = artifacts["multidepth"]
    out = str(tmp_path / "view_{}.npy")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", FRESH.format(root=root, path=path, out=out)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "FRESH_OK (2, 4) []" in proc.stdout, proc.stdout
    served = serving.ServedModel.load(path, device="cpu")
    rng = np.random.default_rng(0)
    for t in served.seq_lens:
        seq = rng.uniform(-1, 1, (2, t, 32, 32, 3)).astype(np.float32)
        src = (rng.uniform(0, 1, (2, t, 3)) + [0, 0, 1]).astype(np.float32)
        tgt = (rng.uniform(0, 1, served.manifest["tgt_poses"])
               + [0, 0, 1]).astype(np.float32)
        np.testing.assert_array_equal(
            np.load(out.format(t)),
            served.predict(seq, tgt, source_poses=src).numpy())


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cuda_served_views_equal_predict(artifacts, cuda, variant):
    """On the card the artifact launches the same kernels as
    ``Model.predict`` of the same weights and serves the same views, bit
    for bit."""
    model, path, _ = artifacts[variant]
    live = TModel(model.cfg, model.module.to(cuda))
    served = serving.ServedModel.load(path)
    rng = np.random.default_rng(8)
    try:
        for t in served.seq_lens:
            seq, src, tgt = _inputs(rng, t)
            torch.testing.assert_close(
                served.predict(seq, tgt, source_poses=src),
                live.predict(seq, tgt, source_poses=src), rtol=0, atol=0)
    finally:
        model.module.to("cpu")
