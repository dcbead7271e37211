"""The port's TensorFlow checkpoint reader (train/tf1.py) and its
``import_tf1_checkpoint`` (train/checkpoint.py) against TensorFlow's
reader and the JAX package's function, which are the oracles here and
nowhere in the port.

- The committed fixture tests/torch_goldens/tf1/ (a tiny c2 model saved by
  ``tf1.train.Saver``, written by tests/_make_torch_tf1_goldens.py) reads,
  with TensorFlow blocked, bitwise to the digests of TensorFlow's reader,
  and the model imported through its name map predicts within 1e-4 of the
  JAX model's views (f32, ``warp_precision=exact``).
- One test imports TensorFlow: the port's import and the JAX package's
  give the same tree on the fixture and its name map (and on a 2-D kernel
  that needs transposing and a map that leaves leaves out), and a
  partitioned variable (``partitioner=``) raises.
- A flipped byte of the data or of the index raises; so do the tables the
  reader does not guess at (a compressed block, a big-endian bundle, a
  dtype it does not read, a file that is not a table), built here by a
  small table writer.
- The C++ CRC32C equals the port's Python one on every length and
  alignment around its 8-byte step.
"""

import contextlib
import json
import os
import shutil
import struct
import sys

import numpy as np
import pytest

from dynamic_multiview_3d_torch import config as tconfig
from dynamic_multiview_3d_torch import weights
from dynamic_multiview_3d_torch.api import Model as TModel
from dynamic_multiview_3d_torch.data.tfrecords import (_field, _varint,
                                                       crc32c)
from dynamic_multiview_3d_torch.models import DMV3D
from dynamic_multiview_3d_torch.train import checkpoint as tckpt
from dynamic_multiview_3d_torch.train import tf1 as ttf1
from dynamic_multiview_3d_tpu.train import checkpoint as jckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from _make_torch_orbax_goldens import TINY, leaf_digest  # noqa: E402

FIXTURE = os.path.join(REPO, "tests", "torch_goldens", "tf1")
PREFIX = os.path.join(FIXTURE, "model.ckpt")
TOL = 1e-4


@contextlib.contextmanager
def _no_tensorflow():
    """An import of TensorFlow raises while the block runs."""
    saved = sys.modules.get("tensorflow")
    sys.modules["tensorflow"] = None
    try:
        yield
    finally:
        if saved is None:
            sys.modules.pop("tensorflow", None)
        else:
            sys.modules["tensorflow"] = saved


def _name_map() -> dict:
    with open(os.path.join(FIXTURE, "name_map.json")) as f:
        return json.load(f)


def test_fixture_reads_bitwise_to_tensorflow():
    expected = np.load(os.path.join(FIXTURE, "expected.npz"))
    want = {k[len("sha256/"):]: str(expected[k]) for k in expected.files
            if k.startswith("sha256/")}
    with _no_tensorflow():
        reader = ttf1.BundleReader(PREFIX)
        got = {name: leaf_digest(reader.tensor(name))
               for name in reader.names()}
    assert got == want
    assert "global_step" in got and len(got) == len(_name_map()) + 1


def test_imported_model_predicts_like_jax():
    expected = np.load(os.path.join(FIXTURE, "expected.npz"))
    cfg = tconfig.get_config("c2", TINY)
    module = DMV3D(cfg.model, num_sources=cfg.data.seq_len)
    with _no_tensorflow():
        sd = tckpt.import_tf1_state_dict(PREFIX, _name_map(), module)
    module.load_state_dict(sd)
    model = TModel(cfg, module.eval())
    views = model.predict(expected["inputs/seq"], expected["inputs/tgt"],
                          source_poses=expected["inputs/src"])
    want = expected["views"]
    gap = np.abs(views.numpy() - want) / (1 + np.abs(want))
    assert views.shape == want.shape and gap.max() <= TOL


def _assert_same_tree(a, b) -> None:
    fa, fb = weights.flatten(a), weights.flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_import_matches_jax_and_refuses_partitioned_variables(tmp_path):
    """The only test that imports TensorFlow (~10 s): the JAX package's
    import_tf1_checkpoint, which reads with TensorFlow, against the
    port's, which does not."""
    tf = pytest.importorskip("tensorflow")
    cfg = tconfig.get_config("c2", TINY)
    template = weights.to_flax(TModel.init_random(cfg, seed=3, device="cpu")
                               .module.state_dict())
    name_map = _name_map()
    _assert_same_tree(tckpt.import_tf1_checkpoint(PREFIX, name_map,
                                                  template),
                      jckpt.import_tf1_checkpoint(PREFIX, name_map,
                                                  template))
    partial = dict(list(name_map.items())[::2])       # the rest: template
    _assert_same_tree(tckpt.import_tf1_checkpoint(PREFIX, partial, template),
                      jckpt.import_tf1_checkpoint(PREFIX, partial, template))

    # a dense kernel saved [out, in], a conv kernel, and a partitioned one
    tf1 = tf.compat.v1
    rng = np.random.default_rng(0)
    conv = rng.standard_normal((3, 3, 4, 8)).astype(np.float32)
    fc = rng.standard_normal((5, 7)).astype(np.float32)
    prefix = str(tmp_path / "model.ckpt")
    with tf1.Graph().as_default():
        tf1.get_variable("enc/conv1/weights", initializer=conv)
        tf1.get_variable("fc/weights", initializer=fc)
        tf1.get_variable("split/weights", shape=(8, 3),
                         initializer=tf1.ones_initializer(),
                         partitioner=tf1.fixed_size_partitioner(2))
        saver = tf1.train.Saver()
        with tf1.Session(graph=tf1.get_default_graph()) as sess:
            sess.run(tf1.global_variables_initializer())
            saver.save(sess, prefix, write_meta_graph=False,
                       write_state=False)
    tree = {"encoder": {"conv1": {"kernel": np.zeros((3, 3, 4, 8),
                                                     np.float32),
                                  "bias": np.ones((8,), np.float32)}},
            "dense": {"kernel": np.zeros((7, 5), np.float32)},
            "split": {"kernel": np.zeros((8, 3), np.float32)}}
    small = {"enc/conv1/weights": "encoder/conv1/kernel",
             "fc/weights": "dense/kernel"}
    ours = tckpt.import_tf1_checkpoint(prefix, small, tree)
    _assert_same_tree(ours, jckpt.import_tf1_checkpoint(prefix, small, tree))
    np.testing.assert_array_equal(ours["dense"]["kernel"], fc.T)
    with pytest.raises(KeyError, match="nope"):
        tckpt.import_tf1_checkpoint(prefix, {"fc/weights": "nope"}, tree)
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.import_tf1_checkpoint(
            prefix, {"enc/conv1/weights": "encoder/conv1/kernel"},
            {"encoder": {"conv1": {"kernel": np.zeros((3, 3, 8, 4))}}})
    with pytest.raises(ValueError, match="sliced"):
        tckpt.import_tf1_checkpoint(
            prefix, {"split/weights": "split/kernel"}, tree)
    np.testing.assert_array_equal(
        jckpt.import_tf1_checkpoint(prefix, {"split/weights":
                                             "split/kernel"}, tree)
        ["split"]["kernel"], np.ones((8, 3), np.float32))


def test_flipped_bytes_raise(tmp_path):
    shutil.copytree(FIXTURE, tmp_path / "tf1")
    prefix = str(tmp_path / "tf1" / "model.ckpt")
    entry = ttf1.BundleReader(prefix).entries["dmv3d/decoder/heads/weights"]
    data = tmp_path / "tf1" / "model.ckpt.data-00000-of-00001"
    raw = bytearray(data.read_bytes())
    raw[entry["offset"] + entry["size"] // 2] ^= 0x01
    data.write_bytes(bytes(raw))
    reader = ttf1.BundleReader(prefix)
    with pytest.raises(ValueError, match="CRC32C mismatch"):
        reader.tensor("dmv3d/decoder/heads/weights")
    reader.tensor("dmv3d/decoder/heads/biases")         # the others read
    index = tmp_path / "tf1" / "model.ckpt.index"
    raw = bytearray(index.read_bytes())
    raw[len(raw) // 3] ^= 0x01
    index.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC32C mismatch"):
        ttf1.BundleReader(prefix)


# ------------------------------------------------ a table written here
def _block(entries, compression: int = 0) -> bytes:
    """A table block of ``entries`` (no shared prefixes, one restart) and
    its trailer."""
    body = b"".join(_varint(0) + _varint(len(k)) + _varint(len(v)) + k + v
                    for k, v in entries)
    body += struct.pack("<II", 0, 1)
    trailer = bytes([compression])
    crc = crc32c(body + trailer)
    masked = ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF
    return body + trailer + struct.pack("<I", masked)


def _table(entries, compression: int = 0) -> bytes:
    data = _block(entries, compression)
    size = len(data) - 5
    meta = _block([])
    index = _block([(entries[-1][0], _varint(0) + _varint(size))])
    footer = (_varint(len(data)) + _varint(len(meta) - 5)
              + _varint(len(data) + len(meta)) + _varint(len(index) - 5))
    footer += b"\0" * (40 - len(footer)) + struct.pack("<Q",
                                                       ttf1.TABLE_MAGIC)
    return data + meta + index + footer


def _entry(dtype: int, shape, size: int, crc: int) -> bytes:
    dims = b"".join(_field(2, _varint(1 << 3) + _varint(d)) for d in shape)
    return (_varint(1 << 3) + _varint(dtype) + _field(2, dims)
            + _varint(4 << 3) + _varint(0) + _varint(5 << 3) + _varint(size)
            + _varint(6 << 3 | 5) + struct.pack("<I", crc))


def _bundle(tmp_path, header: bytes, dtype: int = 1, compression: int = 0,
            value: bytes = np.arange(4, dtype="<f4").tobytes()) -> str:
    prefix = str(tmp_path / "t.ckpt")
    crc = crc32c(value)
    masked = ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF
    with open(f"{prefix}.index", "wb") as f:
        f.write(_table([(b"", header),
                        (b"x", _entry(dtype, (4,), len(value), masked))],
                       compression))
    with open(f"{prefix}.data-00000-of-00001", "wb") as f:
        f.write(value)
    return prefix


LITTLE = _varint(1 << 3) + _varint(1)                 # num_shards 1


# "read": what the writer above makes reads; each other case changes one
# thing of it
@pytest.mark.parametrize("case,match", [
    ("read", None), ("compressed", "compressed"),
    ("big-endian", "big-endian"), ("dtype", "dtype 7"),
    ("magic", "not a table"), ("missing", "not in the checkpoint")])
def test_tables_it_does_not_guess_at(tmp_path, case, match):
    if case == "read":
        reader = ttf1.BundleReader(_bundle(tmp_path, LITTLE))
        np.testing.assert_array_equal(reader.tensor("x"),
                                      np.arange(4, dtype=np.float32))
        return
    if case == "missing":
        with pytest.raises(KeyError, match=match):
            ttf1.BundleReader(_bundle(tmp_path, LITTLE)).tensor("y")
        return
    prefix = _bundle(
        tmp_path, LITTLE + _varint(2 << 3) + _varint(1)
        if case == "big-endian" else LITTLE,
        dtype=7 if case == "dtype" else 1,
        compression=1 if case == "compressed" else 0)
    if case == "magic":
        raw = bytearray(open(f"{prefix}.index", "rb").read())
        raw[-1] ^= 0xFF
        open(f"{prefix}.index", "wb").write(bytes(raw))
    with pytest.raises(ValueError, match=match):
        ttf1.BundleReader(prefix).tensor("x")


@pytest.mark.parametrize("offset", range(9))
def test_fast_crc32c_equals_the_python_one(offset):
    data = np.random.default_rng(offset).integers(
        0, 256, 100 + offset, dtype=np.uint8).tobytes()
    for n in (0, 1, 7, 8, 9, 15, 16, 17, 63, 64, 65, 100):
        chunk = data[offset:offset + n]
        assert ttf1.fast_crc32c(chunk) == crc32c(chunk), n
    assert crc32c(b"123456789") == 0xE3069283         # the check value
