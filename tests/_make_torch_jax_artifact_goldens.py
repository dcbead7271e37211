"""Regenerate tests/torch_goldens/jax_artifact/: serving artifacts written by
the JAX package's own ``serving.export_predict``, which the port's
``ServedModel.load`` (dynamic_multiview_3d_torch/serving.py) must serve on a
machine with no JAX.

    JAX_PLATFORMS=cpu python tests/_make_torch_jax_artifact_goldens.py

Writes, at the tiny widths of tests/test_torch_serving.py (``TINY``: f32,
``warp_precision=exact``), each model on JAX's own seeded init (seed 0),
exported at B = 2, K = 2 and lowered for the CPU and the TPU
(``platforms=("cpu", "tpu")``: a TPU deployment's artifact):

- ``flow.dmv3d``: flow synthesis, T = 2;
- ``depth.dmv3d``: depth synthesis with the depth head, T = 2;
- ``flow_geo.dmv3d``: flow synthesis with the geometric side view
  (``model.predict_depth``), T = 2;
- ``multidepth.dmv3d``: multidepth, shared heads, orbit sources,
  ``seq_len=(2, 4)``;
- ``legacy.dmv3d``: ``flow.dmv3d`` with the manifest a JAX loader older
  than signatures read: no ``signatures``, ``synthesis``,
  ``default_pose``, ``custom_calls``, ``src_views`` or
  ``trained_seq_len``;
- ``expected.npz``: ``inputs/<artifact>/T<t>/{seq,src,tgt}``, seeded
  smooth numpy inputs, and ``views/<artifact>/T<t>``, the views of the
  JAX package's ``ServedModel`` for them at every exported T (the legacy
  artifact's without source poses: its default pose).

Uses JAX only; imports nothing of the port.
"""

import io
import json
import os
import shutil
import sys
import zipfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from dynamic_multiview_3d_tpu import config as jconfig  # noqa: E402
from dynamic_multiview_3d_tpu import serving as jserving  # noqa: E402
from dynamic_multiview_3d_tpu.api import Model  # noqa: E402

OUT = os.path.join(REPO, "tests", "torch_goldens", "jax_artifact")
B, K = 2, 2
TINY = ["model.image_size=32", "model.num_levels=3", "model.base_features=8",
        "model.max_features=32", "model.gru_features=16",
        "model.pose_embed_dim=16", "model.dtype=float32",
        "model.use_pallas=False", "model.warp_precision=exact",
        "data.image_size=32", "data.seq_len=2", "data.num_targets=2"]
# name: (overrides, seq_len)
ARTIFACTS = {
    "flow": ([], None),
    "depth": (["model.synthesis=depth", "model.predict_depth=true"], None),
    "flow_geo": (["model.predict_depth=true"], None),
    "multidepth": (["model.synthesis=multidepth", "data.src_views=orbit",
                    "data.seq_len=4"], (2, 4)),
}
LEGACY_DROPS = ("signatures", "synthesis", "default_pose", "custom_calls",
                "src_views", "trained_seq_len")


def smooth_inputs(seed: int, t: int, size: int = 32):
    """Smooth seeded images in [-1, 1] [B, t, size, size, 3], and source
    and target poses (azimuth, elevation, radius) [B, t, 3] / [B, K, 3]."""
    rng = np.random.default_rng(seed)
    y, x = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size),
                       indexing="ij")
    f = rng.uniform(0.5, 2.0, (B, t, 1, 1, 3, 2))
    ph = rng.uniform(0, 2 * np.pi, (B, t, 1, 1, 3))
    seq = np.sin(2 * np.pi * (f[..., 0] * x[..., None]
                              + f[..., 1] * y[..., None]) + ph)
    seq = (0.9 * seq).astype(np.float32)

    def poses(n):
        return np.stack([rng.uniform(-0.6, 0.6, (B, n)),
                         rng.uniform(0.1, 0.5, (B, n)),
                         rng.uniform(1.8, 2.2, (B, n))], -1).astype(np.float32)
    return seq, poses(t), poses(K)


def write_legacy(src: str, out: str) -> None:
    """``src`` with its primary program only and the older manifest."""
    with zipfile.ZipFile(src) as z:
        entries = {n: z.read(n) for n in z.namelist()
                   if not n.startswith("predict_T")}
    manifest = json.loads(entries["manifest.json"])
    for key in LEGACY_DROPS:
        del manifest[key]
    entries["manifest.json"] = json.dumps(manifest).encode()
    with zipfile.ZipFile(out, "w", zipfile.ZIP_STORED) as z:
        for name, blob in entries.items():
            z.writestr(name, blob)


def main() -> None:
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    expected = {}
    for i, (name, (extra, seq_len)) in enumerate(ARTIFACTS.items()):
        cfg = jconfig.override(jconfig.Config(), TINY + extra)
        path = os.path.join(OUT, f"{name}.dmv3d")
        manifest = jserving.export_predict(
            Model.init_random(cfg, seed=0), path, batch=B, seq_len=seq_len,
            num_targets=K, platforms=("cpu", "tpu"))
        assert manifest["platforms"] == ["cpu", "tpu"], manifest["platforms"]
        served = jserving.ServedModel.load(path)
        for t in served.seq_lens:
            seq, src, tgt = smooth_inputs(100 * i + t, t)
            key = f"{name}/T{t}"
            expected.update({f"inputs/{key}/seq": seq,
                             f"inputs/{key}/src": src,
                             f"inputs/{key}/tgt": tgt})
            expected[f"views/{key}"] = np.asarray(
                served.predict(seq, tgt, source_poses=src), np.float32)
    legacy = os.path.join(OUT, "legacy.dmv3d")
    write_legacy(os.path.join(OUT, "flow.dmv3d"), legacy)
    served = jserving.ServedModel.load(legacy)
    assert served.seq_lens == (2,)
    seq, _, tgt = smooth_inputs(900, 2)
    expected["inputs/legacy/T2/seq"] = seq
    expected["inputs/legacy/T2/tgt"] = tgt
    expected["views/legacy/T2"] = np.asarray(served.predict(seq, tgt),
                                             np.float32)
    buf = io.BytesIO()
    np.savez(buf, **expected)
    with open(os.path.join(OUT, "expected.npz"), "wb") as f:
        f.write(buf.getvalue())
    sizes = {n: os.path.getsize(os.path.join(OUT, n))
             for n in sorted(os.listdir(OUT))}
    print(json.dumps({"out": OUT, "entries": len(expected), "bytes": sizes,
                      "total": sum(sizes.values())}))


if __name__ == "__main__":
    main()
