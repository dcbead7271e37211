"""Regenerate tests/torch_goldens/tf1/: a TensorFlow 1 checkpoint of a tiny
c2 model that the port's own bundle reader (dynamic_multiview_3d_torch/
train/tf1.py) must read with no TensorFlow, and that its
``import_tf1_checkpoint`` maps onto the model.

    JAX_PLATFORMS=cpu python tests/_make_torch_tf1_goldens.py

Writes, at the tiny widths of tests/_make_torch_orbax_goldens.py (f32,
``warp_precision=exact``):

- ``model.ckpt.index`` and ``model.ckpt.data-00000-of-00001``: the JAX
  package's seeded c2 model (``Model.init_random``) saved by
  ``tf1.train.Saver`` under TF-style names (``dmv3d/<scope>/weights``,
  ``biases``, ``gamma``, ``beta``; dense kernels [in, out] as flax's,
  all square at these widths), and a ``global_step`` no map names; no
  meta graph, no ``checkpoint`` file;
- ``name_map.json``: TF variable name -> '/'-joined flax path;
- ``expected.npz``: ``sha256/<name>``, the digest of every tensor as
  TensorFlow's reader gives it (``_make_torch_orbax_goldens.leaf_digest``);
  ``inputs/{seq,src,tgt}``, seeded inputs; ``views``, the JAX model's views
  for them.

Uses JAX and TensorFlow only; imports nothing of the port.
"""

import json
import os
import shutil
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

from _make_torch_orbax_goldens import (TINY, leaf_digest,  # noqa: E402
                                       smooth_inputs)
from dynamic_multiview_3d_tpu import config as jconfig  # noqa: E402
from dynamic_multiview_3d_tpu.api import Model  # noqa: E402

OUT = os.path.join(REPO, "tests", "torch_goldens", "tf1")
PREFIX = os.path.join(OUT, "model.ckpt")
SEED = 21


def tf_name(path: str, leaves: set) -> str:
    """The TF-style name of a flax leaf ``a/b/kernel``: a GroupNorm's
    ``scale`` / ``bias`` are ``gamma`` / ``beta``, a layer's ``kernel`` /
    ``bias`` ``weights`` / ``biases``."""
    *scope, leaf = path.split("/")
    norm = "/".join(scope + ["scale"]) in leaves
    name = {"kernel": "weights", "scale": "gamma",
            "bias": "beta" if norm else "biases"}[leaf]
    return "/".join(["dmv3d", *scope, name])


def flat_params(params, prefix: str = "") -> dict:
    out = {}
    for k, v in params.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat_params(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def main() -> None:
    import tensorflow as tf
    from tensorflow.python.training import py_checkpoint_reader

    tf1 = tf.compat.v1
    tf1.disable_eager_execution()
    cfg = jconfig.get_config("c2", TINY)
    model = Model.init_random(cfg, seed=SEED)
    flat = flat_params(model.params)
    name_map = {tf_name(p, set(flat)): p for p in sorted(flat)}
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    with tf1.Graph().as_default():
        for name, path in name_map.items():
            tf1.get_variable(name, initializer=flat[path])
        tf1.train.get_or_create_global_step()
        saver = tf1.train.Saver()
        with tf1.Session() as sess:
            sess.run(tf1.global_variables_initializer())
            saver.save(sess, PREFIX, write_meta_graph=False,
                       write_state=False)
    with open(os.path.join(OUT, "name_map.json"), "w") as f:
        json.dump(name_map, f, indent=1, sort_keys=True)

    reader = py_checkpoint_reader.NewCheckpointReader(PREFIX)
    expected = {f"sha256/{name}": leaf_digest(reader.get_tensor(name))
                for name in reader.get_variable_to_shape_map()}
    seq, src, tgt = smooth_inputs(300, cfg.data.seq_len)
    expected.update({"inputs/seq": seq, "inputs/src": src,
                     "inputs/tgt": tgt,
                     "views": np.asarray(model.predict(seq, tgt,
                                                       source_poses=src),
                                         np.float32)})
    np.savez(os.path.join(OUT, "expected.npz"), **expected)
    print(json.dumps({"out": OUT, "tensors": len(name_map) + 1}))


if __name__ == "__main__":
    main()
