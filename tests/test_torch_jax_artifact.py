"""The JAX package's serving artifacts served by the port on the CPU
(serving.py ``ServedModel.load``), on the committed fixtures of
tests/torch_goldens/jax_artifact/ (written by the JAX package's own
``export_predict``, lowered for the CPU and the TPU, by
tests/_make_torch_jax_artifact_goldens.py).

The port never reads the StableHLO: it rebuilds each model from the
artifact's config and flat flax weights and traces its own programs at the
manifest's shapes. Every fixture is held at every exported T to the JAX
package's served views at 1e-4 as ``max |d| / (1 + |ref|)`` (the model
tolerance of tests/test_torch_model.py; smooth inputs, exact warps) and
bitwise to ``Model.predict`` of the rebuilt model. The manifest's contract
is the JAX loader's: the legacy manifest (no signatures, synthesis,
default pose or custom calls), the fixed shapes and source counts, a
pose-less multi-source request refused. A newer manifest version,
``param_names`` other than the npz's keys, a leaf that lands nowhere or
is missing, a config key the port does not know and a signature the baked
heads were not made for are refused naming the fault. ``cli.export_model``
converts a JAX artifact into the port's. The same fixture served with the
JAX stack blocked: tests/test_torch_imports.py.
"""

import io
import json
import os
import zipfile

import numpy as np
import pytest
import torch

from dynamic_multiview_3d_torch import config as tconfig
from dynamic_multiview_3d_torch import serving, weights
from dynamic_multiview_3d_torch.api import Model as TModel
from dynamic_multiview_3d_torch.cli import export_model as texport_cli

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "torch_goldens", "jax_artifact")
VARIANTS = {"flow": (2,), "depth": (2,), "flow_geo": (2,),
            "multidepth": (2, 4)}
TOL = 1e-4


def _path(name):
    return os.path.join(ROOT, f"{name}.dmv3d")


@pytest.fixture(scope="module")
def expected():
    with np.load(os.path.join(ROOT, "expected.npz")) as npz:
        return {k: npz[k] for k in npz.files}


@pytest.fixture(scope="module")
def served():
    """Each committed artifact loaded once on the CPU (one intra-op
    thread, as tests/test_torch_serving.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield {name: serving.ServedModel.load(_path(name), device="cpu")
           for name in (*VARIANTS, "legacy")}
    torch.set_num_threads(threads)


def _inputs(expected, name, t):
    key = f"inputs/{name}/T{t}/"
    return (expected[key + "seq"], expected.get(key + "src"),
            expected[key + "tgt"])


def _gap(got, want) -> float:
    return float((np.abs(got.numpy() - want) / (1 + np.abs(want))).max())


@pytest.mark.parametrize("name", list(VARIANTS))
def test_a_jax_artifact_serves_the_jax_views(served, expected, name):
    """Every exported T of the fixture: the JAX package's served views
    within 1e-4, and bit for bit what the model rebuilt from the
    artifact's config and weights predicts."""
    ours = served[name]
    assert ours.seq_lens == VARIANTS[name] == serving.jax_seq_lens(
        ours.manifest)
    live, manifest, _ = serving.read_jax_artifact(_path(name), device="cpu")
    assert manifest == ours.manifest and "format" not in manifest
    for t in ours.seq_lens:
        seq, src, tgt = _inputs(expected, name, t)
        got = ours.predict(seq, tgt, source_poses=src)
        assert got.dtype == torch.float32 and list(got.shape) == \
            manifest["view"]
        assert _gap(got, expected[f"views/{name}/T{t}"]) <= TOL, (name, t)
        assert torch.equal(got, live.predict(seq, tgt, source_poses=src))


def test_the_legacy_manifest_serves_its_primary_signature(served, expected):
    """A manifest older than signatures, synthesis, default_pose and
    custom_calls: one T (src_poses' middle dim), the single-source
    default pose (0.0, 0.3, 2.0) for a pose-less request, JAX's legacy
    views within 1e-4; its weights are flow.dmv3d's, so its views are
    bitwise those of flow.dmv3d given that pose."""
    legacy = served["legacy"]
    for key in ("signatures", "synthesis", "default_pose", "custom_calls"):
        assert key not in legacy.manifest
    assert legacy.seq_lens == (2,)
    seq, _, tgt = _inputs(expected, "legacy", 2)
    got = legacy.predict(seq, tgt)
    assert _gap(got, expected["views/legacy/T2"]) <= TOL
    pose = np.broadcast_to(np.float32([0.0, 0.3, 2.0]), (2, 2, 3))
    assert torch.equal(got, served["flow"].predict(seq, tgt,
                                                   source_poses=pose))


def test_the_manifest_contract_holds(served, expected):
    """As the JAX loader applies it: a T with no signature, a shape other
    than the exported ones and a pose-less multidepth request are
    refused; the traced programs take any batch (the JAX manifest's
    version 1 is not the port's), so a rank's rows serve, within 1e-5 of
    the whole request's (oneDNN may round another batch size otherwise)."""
    md = served["multidepth"]
    seq, src, tgt = _inputs(expected, "multidepth", 2)
    with pytest.raises(ValueError, match="source_poses"):
        md.predict(seq, tgt)
    with pytest.raises(ValueError, match=r"T in \[2, 4\]"):
        md.predict(np.zeros((2, 3, 32, 32, 3), np.float32), tgt,
                   source_poses=np.zeros((2, 3, 3), np.float32))
    with pytest.raises(ValueError, match="fixed-shape"):
        md.predict(seq[:1], tgt[:1], source_poses=src[:1])
    assert md.manifest["version"] == 1 and md.any_batch
    want = md.predict(seq, tgt, source_poses=src)
    with torch.inference_mode():
        row = md.call_for(2)(md.params, *(torch.from_numpy(a[1:]) for a in
                                          (seq, src, tgt)))
    torch.testing.assert_close(row, want[1:], rtol=1e-5, atol=1e-5)


def _rewrite(src, out, manifest=None, params=None, config=None):
    """A copy of the artifact ``src`` at ``out`` with its manifest, params
    or config changed in place by the given functions of their parsed
    forms; changed params keep ``param_names`` their keys."""
    with zipfile.ZipFile(src) as z:
        entries = {n: z.read(n) for n in z.namelist()}
    if params is not None:
        with np.load(io.BytesIO(entries["params.npz"])) as npz:
            flat = {k: npz[k] for k in npz.files}
        params(flat)
        buf = io.BytesIO()
        np.savez(buf, **flat)
        entries["params.npz"] = buf.getvalue()
        manifest = lambda m: m.update(param_names=sorted(flat))  # noqa: E731
    for entry, edit in (("manifest.json", manifest), ("config.json", config)):
        if edit is not None:
            d = json.loads(entries[entry])
            edit(d)
            entries[entry] = json.dumps(d).encode()
    with zipfile.ZipFile(out, "w") as z:
        for n, blob in entries.items():
            z.writestr(n, blob)
    return str(out)


def _baked(out):
    """A JAX-layout artifact of a baked multidepth model made for T = 2
    (the port's seeded init as flat flax weights) whose manifest claims a
    signature at T = 3."""
    cfg = tconfig.override(tconfig.Config(), [
        "model.image_size=32", "model.num_levels=3", "model.base_features=8",
        "model.max_features=32", "model.gru_features=16",
        "model.pose_embed_dim=16", "model.dtype=float32",
        "model.synthesis=multidepth", "model.multi_head_mode=baked",
        "data.image_size=32", "data.seq_len=2", "data.src_views=orbit"])
    flat = weights.flatten(weights.to_flax(TModel.init_random(
        cfg, device="cpu").module.state_dict()))
    buf = io.BytesIO()
    np.savez(buf, **flat)
    manifest = {"version": 1, "image_seq": [2, 3, 32, 32, 3],
                "src_poses": [2, 3, 3], "tgt_poses": [2, 2, 3],
                "view": [2, 2, 32, 32, 3], "param_names": sorted(flat),
                "synthesis": "multidepth"}
    with zipfile.ZipFile(out, "w") as z:
        z.writestr("predict.stablehlo", b"")
        z.writestr("params.npz", buf.getvalue())
        z.writestr("config.json", json.dumps(tconfig.to_dict(cfg)))
        z.writestr("manifest.json", json.dumps(manifest))
    return str(out)


def _drop_leaf(flat):
    del flat["decoder/heads/kernel"]


def _stray_leaf(flat):
    flat["decoder/stray/kernel"] = np.zeros((1, 1), np.float32)


# case: (rewrite of flow.dmv3d, or a function of the output path; the
# error's pattern)
BAD = {
    "newer_version": (dict(manifest=lambda m: m.update(version=2)),
                      r"version 2 is newer than the JAX package's "
                      r"MANIFEST_VERSION 1"),
    "names_not_the_npz_keys": (
        dict(manifest=lambda m: m.update(
            param_names=m["param_names"][1:] + ["bogus/kernel"])),
        r"only in param_names \['bogus/kernel'\], only in params.npz "
        r"\['bottleneck/mix1/conv/bias'\]"),
    "missing_leaf": (dict(params=_drop_leaf),
                     r"not filled \['decoder.heads.weight'\]"),
    "stray_leaf": (dict(params=_stray_leaf),
                   r"unmatched flax leaves \['decoder/stray/kernel'\]"),
    "unknown_config_key": (dict(config=lambda c: c["model"].update(
        wider=True)), r"does not know: \['model.wider'\]"),
    "baked_heads_at_another_t": (_baked, r"T=3, but the baked multi-source "
                                         r"heads are made for 2 sources"),
}


@pytest.mark.parametrize("case", list(BAD))
def test_a_faulty_jax_artifact_is_refused_naming_the_fault(tmp_path, case):
    """Each fault is refused before any program is traced, and the
    message names it."""
    make, pattern = BAD[case]
    out = tmp_path / f"{case}.dmv3d"
    path = make(out) if callable(make) else _rewrite(_path("flow"), out,
                                                     **make)
    with pytest.raises(ValueError, match=pattern):
        serving.ServedModel.load(path, device="cpu")


def test_export_model_cli_converts_a_jax_artifact(served, expected, tmp_path,
                                                  capsys):
    """``cli.export_model --ckpt <jax artifact>`` writes the port's
    artifact at the JAX manifest's shapes (batch, every T, K), checked
    against the rebuilt live model; it serves bitwise what the in-memory
    load of the JAX artifact serves."""
    out = str(tmp_path / "converted.dmv3d")
    texport_cli.main(["--ckpt", _path("flow"), "--out", out, "--device",
                      "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    check, line = json.loads(lines[-2]), json.loads(lines[-1])
    assert check["check"]["max_abs_err_by_T"] == {"2": 0.0}
    assert line["format"] == "torch.export" and line["version"] == 2
    assert line["image_seq"] == served["flow"].manifest["image_seq"]
    assert line["tgt_poses"] == served["flow"].manifest["tgt_poses"]
    assert list(line["signatures"]) == ["2"]
    converted = serving.ServedModel.load(out, device="cpu")
    seq, src, tgt = _inputs(expected, "flow", 2)
    assert torch.equal(converted.predict(seq, tgt, source_poses=src),
                       served["flow"].predict(seq, tgt, source_poses=src))
