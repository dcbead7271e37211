"""Regenerate tests/torch_goldens/jax_orbax/: checkpoints written by the JAX
package (Orbax, through tensorstore) that the port's own Orbax reader
(dynamic_multiview_3d_torch/train/orbax.py) must read on a machine with
neither JAX nor tensorstore.

    JAX_PLATFORMS=cpu python tests/_make_torch_orbax_goldens.py

Writes, at the tiny widths of tests/test_torch_loop.py (f32,
``warp_precision=exact``):

- ``c2_model/``: a c2 flow model dir (``Model.save_checkpoint``, step 3);
- ``c3md_model/``: a c3md model dir (multidepth, shared heads, T = 3),
  step 5;
- ``c2_run/``: a c2 run dir from ``train.loop.train``: its
  ``train_config.json`` and the manager step ``1/default/`` (one SGD step,
  ``train.ema_decay=0.5``, so the step holds params, EMA params and an
  optimizer state); SGD keeps the three dirs under 1 MB together;
- ``expected.npz``: ``sha256/<dir>/<leaf>``, the digest of every leaf as
  tensorstore reads it (``leaf_digest``); ``inputs/<model>/{seq,src,tgt}``,
  seeded numpy inputs; ``views/<model>``, the JAX model's views for them
  (``views/c2_run`` from the run's EMA params, which ``cli.snapshot``
  exports).

Uses JAX, Orbax and tensorstore only; imports nothing of the port.
"""

import hashlib
import json
import os
import shutil
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from dynamic_multiview_3d_tpu import config as jconfig  # noqa: E402
from dynamic_multiview_3d_tpu.api import Model  # noqa: E402

OUT = os.path.join(REPO, "tests", "torch_goldens", "jax_orbax")
TINY = ["model.image_size=32", "model.num_levels=3", "model.base_features=8",
        "model.max_features=16", "model.gru_features=16",
        "model.pose_embed_dim=8", "model.dtype=float32",
        "model.use_pallas=False", "data.image_size=32",
        "model.warp_precision=exact"]
MODELS = {"c2_model": ("c2", [], 3, 11),
          "c3md_model": ("c3md", ["data.seq_len=3"], 5, 12)}
RUN = ["train.optimizer=sgd", "train.ema_decay=0.5", "train.lr=0.05",
       "train.num_steps=1", "train.ckpt_every=1", "train.log_every=1",
       "data.batch_size=2", "data.num_scenes=2", "mesh.data=1"]


def leaf_digest(a) -> str:
    """sha256 of a leaf's dtype name, shape and C-order bytes."""
    a = np.ascontiguousarray(a)
    head = f"{a.dtype.name}|{','.join(map(str, a.shape))}|".encode()
    return hashlib.sha256(head + a.tobytes()).hexdigest()


def ts_read(directory: str) -> dict:
    """Every leaf of an Orbax dir as tensorstore reads it."""
    import tensorstore as ts
    with open(os.path.join(directory, "_METADATA")) as f:
        meta = json.load(f)
    out = {}
    for leaf in meta["tree_metadata"].values():
        if leaf["value_metadata"].get("skip_deserialize"):
            continue                                   # a None leaf
        keys = [str(k["key"]) for k in leaf["key_metadata"]]
        spec = {"driver": "zarr",
                "kvstore": {"driver": "ocdbt", "base": f"file://{directory}",
                            "path": ".".join(keys)}}
        out["/".join(keys)] = ts.open(spec, open=True).result().read() \
            .result()
    return out


def smooth_inputs(seed: int, t: int, size: int = 32):
    """Smooth seeded images in [-1, 1] [2, t, size, size, 3], and source
    and target poses (azimuth, elevation, radius) [2, t, 3] / [2, 3, 3]."""
    rng = np.random.default_rng(seed)
    y, x = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size),
                       indexing="ij")
    f = rng.uniform(0.5, 2.0, (2, t, 1, 1, 3, 2))
    ph = rng.uniform(0, 2 * np.pi, (2, t, 1, 1, 3))
    seq = np.sin(2 * np.pi * (f[..., 0] * x[..., None]
                              + f[..., 1] * y[..., None]) + ph)
    seq = (0.9 * seq).astype(np.float32)

    def poses(n):
        return np.stack([rng.uniform(-0.6, 0.6, (2, n)),
                         rng.uniform(0.1, 0.5, (2, n)),
                         rng.uniform(1.8, 2.2, (2, n))], -1).astype(np.float32)
    return seq, poses(t), poses(3)


def main() -> None:
    from dynamic_multiview_3d_tpu.train import loop as jloop

    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    expected = {}
    views = {}
    for name, (preset, extra, step, seed) in MODELS.items():
        cfg = jconfig.get_config(preset, TINY + extra)
        Model.init_random(cfg, seed=seed).save_checkpoint(
            os.path.join(OUT, name), step=step)
        views[name] = (Model.from_checkpoint(os.path.join(OUT, name)),
                       cfg.data.seq_len)
        for k, v in ts_read(os.path.join(OUT, name, f"params_{step}")).items():
            expected[f"sha256/{name}/params_{step}/{k}"] = leaf_digest(v)

    with tempfile.TemporaryDirectory() as tmp:
        cfg = jconfig.get_config("c2", TINY + RUN
                                 + [f"train.ckpt_dir={tmp}/run"])
        jloop.train(cfg)
        run = os.path.join(OUT, "c2_run")
        os.makedirs(run)
        shutil.copy(os.path.join(tmp, "run", "train_config.json"), run)
        shutil.copytree(os.path.join(tmp, "run", "1"),
                        os.path.join(run, "1"))
        views["c2_run"] = (Model.from_checkpoint(os.path.join(tmp, "run",
                                                              "model")), 1)
    for k, v in ts_read(os.path.join(run, "1", "default")).items():
        expected[f"sha256/c2_run/1/default/{k}"] = leaf_digest(v)

    for i, (name, (model, t)) in enumerate(views.items()):
        seq, src, tgt = smooth_inputs(100 + i, t)
        expected[f"inputs/{name}/seq"] = seq
        expected[f"inputs/{name}/src"] = src
        expected[f"inputs/{name}/tgt"] = tgt
        expected[f"views/{name}"] = np.asarray(
            model.predict(seq, tgt, source_poses=src), np.float32)
    np.savez(os.path.join(OUT, "expected.npz"), **expected)
    print(json.dumps({"out": OUT, "entries": len(expected)}))


if __name__ == "__main__":
    main()
