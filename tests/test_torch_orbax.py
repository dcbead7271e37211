"""The port's Orbax reader and writer (train/orbax.py) against Orbax 0.11
and tensorstore, which are the oracles here and nowhere in the port.

- Reader: with tensorstore, zstandard, jax, flax, orbax and ml_dtypes
  blocked in ``sys.modules``, ``read_orbax`` gives every leaf bitwise equal
  (dtype, shape, bytes) to what tensorstore reads: tiny flax trees the JAX
  package's ``save_model`` writes, a bf16 / int32 / uint8 / bool / f64 /
  0-d / sequence-keyed tree, a leaf sharded over 4 CPU devices (one chunk
  per shard, written in a subprocess with 4 host devices), three
  processes' stores merged as Orbax merges a multi-host save, a JAX
  ``CheckpointManager`` step's ``default/``, and the full-width c2 preset
  params. The OCDBT key-value store alone, against tensorstore's, on trees
  of interior nodes, indirect values and many versions, compressed and not.
- Writer: ``write_orbax`` output is read bitwise by tensorstore and by
  Orbax's ``StandardCheckpointer``; a model dir that
  ``save_model(fmt="orbax")`` writes is read by the JAX package's
  ``load_model`` and ``Model.from_checkpoint``, whose views are within
  test_torch_model.py's TOL = 1e-4 of the port's (f32,
  ``warp_precision=exact``).
- The committed fixtures (tests/torch_goldens/jax_orbax/, written by
  tests/_make_torch_orbax_goldens.py) read the same through both, match
  the digests of ``expected.npz``, and load into the port with the views
  of the JAX model within 1e-4; ``cli.snapshot`` turns the JAX run dir into
  a port model dir from its EMA params, which ``cli.predict`` serves.
- Corruption (a changed byte of a manifest or node) and the layouts not
  read (zarr3, no OCDBT) raise ``ValueError``.
"""

import contextlib
import hashlib
import json
import os
import shutil
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch

from dynamic_multiview_3d_torch import config as tconfig
from dynamic_multiview_3d_torch import weights
from dynamic_multiview_3d_torch.api import Model as TModel
from dynamic_multiview_3d_torch.cli import predict as tpredict_cli
from dynamic_multiview_3d_torch.cli import snapshot as tsnapshot_cli
from dynamic_multiview_3d_torch.data.synthetic import (random_poses,
                                                       smooth_images)
from dynamic_multiview_3d_torch.train import checkpoint as tckpt
from dynamic_multiview_3d_torch.train import orbax as torbax
from dynamic_multiview_3d_tpu import config as jconfig
from dynamic_multiview_3d_tpu.api import Model as JModel
from dynamic_multiview_3d_tpu.train import checkpoint as jckpt
from test_torch_model import TOL, _assert_outputs_close, _multi, _pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "torch_goldens", "jax_orbax")
BLOCKED = ("tensorstore", "zstandard", "jax", "jaxlib", "flax", "orbax",
           "ml_dtypes")


@contextlib.contextmanager
def _blocked():
    """An import of any of BLOCKED raises while the block runs."""
    saved = {n: sys.modules.get(n) for n in BLOCKED}
    for n in BLOCKED:
        sys.modules[n] = None
    try:
        yield
    finally:
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m


def _port_read(directory) -> dict:
    with _blocked():
        return torbax.read_orbax(str(directory))


def _ts_read(directory) -> dict:
    """Every leaf as tensorstore reads it."""
    with open(os.path.join(directory, "_METADATA")) as f:
        meta = json.load(f)
    out = {}
    for leaf in meta["tree_metadata"].values():
        if leaf["value_metadata"].get("skip_deserialize"):
            continue
        keys = [str(k["key"]) for k in leaf["key_metadata"]]
        spec = {"driver": "zarr",
                "kvstore": {"driver": "ocdbt",
                            "base": f"file://{os.path.abspath(directory)}",
                            "path": ".".join(keys)}}
        out["/".join(keys)] = ts.open(spec, open=True).result().read() \
            .result()
    return out


def _as_numpy(v) -> np.ndarray:
    """A port leaf as numpy; bf16 tensors as ml_dtypes bfloat16."""
    if torch.is_tensor(v):
        assert v.dtype == torch.bfloat16
        return v.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return v


def _assert_same_leaves(ours: dict, ref: dict) -> None:
    assert sorted(ours) == sorted(ref)
    for k in ref:
        a, b = _as_numpy(ours[k]), np.asarray(ref[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype,
                                                            b.dtype)
        assert a.tobytes() == b.tobytes(), k


def _digest(a) -> str:
    """tests/_make_torch_orbax_goldens.py's ``leaf_digest``."""
    a = np.ascontiguousarray(_as_numpy(a))
    head = f"{a.dtype.name}|{','.join(map(str, a.shape))}|".encode()
    return hashlib.sha256(head + a.tobytes()).hexdigest()


def _orbax_save(path, tree) -> None:
    with ocp.StandardCheckpointer() as c:
        c.save(os.path.abspath(path), tree)


# ------------------------------------------------------------------ reader
def test_tiny_trees_the_jax_package_writes(tmp_path):
    for name, extra in (("flow", ()), ("multidepth", _multi("multidepth",
                                                             "baked"))):
        _, _, params = _pair(extra)
        path = tmp_path / name
        jckpt.save_model(str(path), jax.tree.map(jnp.asarray, params),
                         jconfig.Config(), step=2)
        _assert_same_leaves(_port_read(path / "params_2"),
                            _ts_read(path / "params_2"))


def test_mixed_dtypes_0d_and_sequence_keys(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"bf": rng.standard_normal((5, 7)).astype(ml_dtypes.bfloat16),
            "i32": rng.integers(-9, 9, (3, 4)).astype(np.int32),
            "u8": rng.integers(0, 255, 17).astype(np.uint8),
            "b": rng.random(6) > 0.5,
            "f64": rng.standard_normal(3),
            "i64": np.arange(4, dtype=np.int64) - 2,
            "f16": rng.standard_normal(9).astype(np.float16),
            "scalar": np.float32(2.5), "int0": np.int32(-3),
            "seq": [rng.standard_normal(2).astype(np.float32),
                    {"deep": np.zeros((2, 1, 3), np.float32),
                     "big": rng.standard_normal((200, 30))
                     .astype(np.float32)}]}
    _orbax_save(tmp_path / "ck", tree)
    ours = _port_read(tmp_path / "ck")
    _assert_same_leaves(ours, _ts_read(tmp_path / "ck"))
    assert ours["bf"].dtype == torch.bfloat16
    assert ours["scalar"].shape == () and "seq/1/big" in ours


SHARDED = """
import numpy as np, jax, orbax.checkpoint as ocp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
mesh = Mesh(np.array(jax.devices()), ("x",))
a = np.random.default_rng(1).standard_normal((12, 6)).astype(np.float32)
b = np.arange(32, dtype=np.int32).reshape(4, 8)
tree = {"w": jax.device_put(a, NamedSharding(mesh, P("x", None))),
        "v": jax.device_put(b, NamedSharding(mesh, P(None, "x"))),
        "r": jax.device_put(a[0], NamedSharding(mesh, P()))}
assert len(jax.devices()) == 4
with ocp.StandardCheckpointer() as c:
    c.save(%r, tree)
"""


def test_a_leaf_sharded_over_4_devices(tmp_path):
    """Orbax writes one chunk per shard (the chunk smaller than the array,
    the edge chunk stored full): the port reads the whole array."""
    path = str(tmp_path / "sharded")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    run = subprocess.run([sys.executable, "-c", SHARDED % path], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    refs = torbax.OcdbtReader(path).refs()
    chunks = json.loads(torbax.OcdbtReader(path).value(refs[b"w/.zarray"]))
    assert chunks["chunks"] == [3, 6] and chunks["shape"] == [12, 6]
    assert sum(k.startswith(b"w/") and not k.endswith(b".zarray")
               for k in refs) == 4
    ours = _port_read(path)
    _assert_same_leaves(ours, _ts_read(path))
    np.testing.assert_array_equal(
        ours["w"], np.random.default_rng(1).standard_normal((12, 6))
        .astype(np.float32))


def test_three_processes_merged_as_orbax_merges_them(tmp_path):
    """A multi-host save: each process writes its arrays under
    ``ocdbt.process_<i>/`` and Orbax merges them into the top-level store
    (``merge_ocdbt_per_process_files``), whose references reach into the
    three subtrees."""
    import asyncio

    from etils import epath
    from orbax.checkpoint._src.serialization import ocdbt_utils

    rng = np.random.default_rng(4)
    meta = {}
    for proc in range(3):
        for j in range(4):
            name = f"p{proc}_leaf{j}"
            a = rng.standard_normal(40 + 100 * j).astype(np.float32)
            ts.open({"driver": "zarr",
                     "kvstore": {"driver": "ocdbt", "path": name,
                                 "base": f"file://{tmp_path}/"
                                         f"ocdbt.process_{proc}/",
                                 "config": {"max_decoded_node_bytes": 300,
                                            "max_inline_value_bytes": 64}},
                     "metadata": {"shape": list(a.shape), "chunks": [50],
                                  "dtype": "<f4",
                                  "compressor": {"id": "zstd", "level": 1}}},
                    create=True).result().write(a).result()
            meta[str((name,))] = {
                "key_metadata": [{"key": name, "key_type": 2}],
                "value_metadata": {"value_type": "np.ndarray",
                                   "skip_deserialize": False}}
    asyncio.run(ocdbt_utils.merge_ocdbt_per_process_files(
        epath.Path(tmp_path), ocdbt_utils.ts_utils.get_ts_context(),
        use_zarr3=False))
    (tmp_path / "_METADATA").write_text(json.dumps({
        "tree_metadata": meta, "use_ocdbt": True, "use_zarr3": False}))
    with _blocked():
        files = {f[0] for f, _, _ in (v for v in torbax.OcdbtReader(
            str(tmp_path)).refs().values() if not isinstance(v, bytes))}
    assert files == {f"ocdbt.process_{i}/" for i in range(3)}
    _assert_same_leaves(_port_read(tmp_path), _ts_read(tmp_path))


@pytest.mark.parametrize("dtype", ["<f4", "<i8", "bfloat16"])
def test_edge_chunks_and_missing_chunks(tmp_path, dtype):
    """A zarr v2 array whose chunks overhang its shape (edge chunks stored
    full, cropped on read) and some of whose chunks were never written
    (the fill value), in an OCDBT store, as tensorstore writes it."""
    arr = ts.open({"driver": "zarr",
                   "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}",
                               "path": "e"},
                   "metadata": {"shape": [10, 7], "chunks": [4, 3],
                                "dtype": dtype, "fill_value": 3,
                                "compressor": {"id": "zstd", "level": 1}}},
                  create=True).result()
    data = np.arange(8 * 7).reshape(8, 7) - 20
    arr[:8, :].write(data.astype(arr.dtype.numpy_dtype)).result()
    (tmp_path / "_METADATA").write_text(json.dumps({
        "tree_metadata": {"('e',)": {
            "key_metadata": [{"key": "e", "key_type": 2}],
            "value_metadata": {"value_type": "np.ndarray",
                               "skip_deserialize": False}}},
        "use_ocdbt": True, "use_zarr3": False}))
    ours = _port_read(tmp_path)
    _assert_same_leaves(ours, _ts_read(tmp_path))
    assert _as_numpy(ours["e"]).astype(np.float64)[9, 6] == 3


def test_a_manager_step(tmp_path):
    """A JAX ``CheckpointManager`` step (``<step>/default/``) of a train
    state: params, EMA, Adam moments, step."""
    _, _, params = _pair()
    p = jax.tree.map(jnp.asarray, params)
    state = {"params": p, "ema_params": jax.tree.map(lambda x: x * 0.5, p),
             "opt_state": [{"count": jnp.int32(3),
                            "mu": jax.tree.map(jnp.zeros_like, p)}, None],
             "step": jnp.int32(3)}
    mgr = jckpt.make_manager(str(tmp_path))
    mgr.save(3, args=ocp.args.StandardSave(state))
    mgr.wait_until_finished()
    mgr.close()
    ours = _port_read(tmp_path / "3" / "default")
    _assert_same_leaves(ours, _ts_read(tmp_path / "3" / "default"))
    assert int(ours["step"]) == 3 and "opt_state/0/count" in ours
    with _blocked():
        assert tckpt.is_jax_step(str(tmp_path), 3)
        assert sorted(tckpt.read_jax_step(str(tmp_path), 3)) == sorted(ours)


def test_full_width_c2_params(tmp_path):
    """The c2 preset (13,284,966 params, f32) as the JAX package's
    save_model writes it: every leaf bitwise."""
    cfg = tconfig.get_config("c2")
    model = TModel.init_random(cfg, seed=3, device="cpu")
    flat = weights.flatten(weights.to_flax(model.module.state_dict()))
    assert sum(v.size for v in flat.values()) == 13_284_966
    jckpt.save_model(str(tmp_path / "m"),
                     jax.tree.map(jnp.asarray, weights.to_flax(
                         model.module.state_dict())),
                     jconfig.get_config("c2"), step=9)
    ours = _port_read(tmp_path / "m" / "params_9")
    _assert_same_leaves(ours, _ts_read(tmp_path / "m" / "params_9"))
    with _blocked():
        back = TModel.from_checkpoint(str(tmp_path / "m"), device="cpu")
    sd = model.module.state_dict()
    for k, v in back.module.state_dict().items():
        assert torch.equal(v, sd[k]), k


@pytest.mark.parametrize("compression", [None, {"id": "zstd", "level": 3}])
def test_ocdbt_store_matches_tensorstore(tmp_path, compression):
    """Small nodes (interior levels), 4-byte inline limit (indirect values),
    30 versions (a version tree), as tensorstore writes them."""
    kv = ts.KvStore.open({
        "driver": "ocdbt", "base": f"file://{tmp_path}/",
        "config": {"compression": compression, "max_decoded_node_bytes": 160,
                   "max_inline_value_bytes": 4}}).result()
    txn = ts.Transaction()
    for i in range(40):
        kv.with_transaction(txn).write(f"pre/key{i:03d}",
                                       b"%d" % i * (1 + i % 4)).result()
    txn.commit_async().result()
    for i in range(30):
        kv.write(f"x{i}", b"y" * i).result()
    kv.delete_range(ts.KvStore.KeyRange("pre/key007", "pre/key008")) \
        .result()
    ref = {k: kv.read(k).result().value for k in kv.list().result()}
    with _blocked():
        reader = torbax.OcdbtReader(str(tmp_path))
        assert reader.root[3] > 0                      # interior nodes
        assert reader.items() == ref


# ------------------------------------------------------------------ writer
def test_write_orbax_reads_in_tensorstore_and_orbax(tmp_path):
    rng = np.random.default_rng(2)
    tree = {"enc/conv/kernel": rng.standard_normal((3, 3, 4, 8))
            .astype(np.float32),
            "enc/conv/bias": np.zeros(8, np.float32),
            "big/kernel": rng.standard_normal((300, 500)).astype(np.float32),
            "i": np.arange(5, dtype=np.int32), "s": np.float64(3.5),
            "bf": torch.randn(4, 3, generator=torch.Generator()
                              .manual_seed(0)).bfloat16(),
            "mask": np.array([True, False])}
    path = str(tmp_path / "w")
    torbax.write_orbax(path, tree)
    ref = {k: _as_numpy(v) if torch.is_tensor(v) else np.asarray(v)
           for k, v in tree.items()}
    _assert_same_leaves(_ts_read(path), ref)
    _assert_same_leaves(_port_read(path), ref)
    with ocp.StandardCheckpointer() as c:
        restored = c.restore(path)
    flat = {"/".join(k.key for k in p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(restored)[0]}
    _assert_same_leaves(flat, ref)
    # chunks are frames of raw blocks of at most 128 KiB
    kv = torbax.OcdbtReader(path)
    frame = kv.value(kv.refs()[b"big.kernel/0.0"])
    assert len(frame) == 600_000 + 9 + 3 * 5


@pytest.mark.parametrize("extra,t", [((), 1),
                                     (_multi("multidepth", "shared"), 3)],
                         ids=["flow", "multidepth-shared"])
def test_save_model_orbax_reads_in_jax(tmp_path, extra, t):
    _, tm, _ = _pair(extra)
    path = str(tmp_path / "m")
    tm.save_checkpoint(path, step=4, fmt="orbax")
    assert sorted(os.listdir(path)) == ["config.json", "params_4"]
    params, cfg, step = jckpt.load_model(path)
    assert step == 4 and jconfig.to_dict(cfg) == tconfig.to_dict(tm.cfg)
    jm = JModel.from_checkpoint(path)
    rng = np.random.default_rng(3)
    seq, src, tgt = (smooth_images(rng, 2, t, 32), random_poses(rng, 2, t),
                     random_poses(rng, 2, 3))
    _assert_outputs_close(
        jm.predict(seq, tgt, source_poses=src, return_aux=True),
        tm.predict(seq, tgt, source_poses=src, return_aux=True), tm.cfg)
    back = TModel.from_checkpoint(path, device="cpu")
    for k, v in tm.module.state_dict().items():
        assert torch.equal(back.module.state_dict()[k], v), k
    with pytest.raises(ValueError, match="fmt"):
        tm.save_checkpoint(str(tmp_path / "x"), fmt="npz")


# ---------------------------------------------------------------- fixtures
FIXTURES = ["c2_model/params_3", "c3md_model/params_5", "c2_run/1/default"]


@pytest.mark.parametrize("fixture", FIXTURES)
def test_fixtures_read_as_tensorstore_reads_them(fixture):
    path = os.path.join(GOLDENS, fixture)
    ours = _port_read(path)
    _assert_same_leaves(ours, _ts_read(path))
    expected = np.load(os.path.join(GOLDENS, "expected.npz"))
    digests = {k[len(f"sha256/{fixture}/"):]: str(expected[k])
               for k in expected.files if k.startswith(f"sha256/{fixture}/")}
    assert digests == {k: _digest(v) for k, v in ours.items()}


@pytest.mark.parametrize("name", ["c2_model", "c3md_model"])
def test_fixture_models_predict_like_jax(name):
    expected = np.load(os.path.join(GOLDENS, "expected.npz"))
    with _blocked():
        model = TModel.from_checkpoint(os.path.join(GOLDENS, name),
                                       device="cpu")
    x = {k: expected[f"inputs/{name}/{k}"] for k in ("seq", "src", "tgt")}
    views = model.predict(x["seq"], x["tgt"], source_poses=x["src"])
    np.testing.assert_allclose(views.numpy(), expected[f"views/{name}"],
                               rtol=TOL, atol=TOL)


def test_snapshot_of_a_jax_run_exports_its_ema(tmp_path, capsys):
    out = str(tmp_path / "snap")
    with _blocked():
        tsnapshot_cli.main(["--ckpt-dir", os.path.join(GOLDENS, "c2_run"),
                            "--out", out])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"out": out, "step": 1, "ema": True}
    state = _port_read(os.path.join(GOLDENS, "c2_run", "1", "default"))
    ema = {k[len("ema_params/"):]: v for k, v in state.items()
           if k.startswith("ema_params/")}
    raw = {k[len("params/"):]: v for k, v in state.items()
           if k.startswith("params/")}
    model = TModel.from_checkpoint(out, device="cpu")
    module = model.module
    assert all(torch.equal(v, module.state_dict()[k]) for k, v in
               weights.from_flax(ema, module).items())
    assert not all(torch.equal(v, module.state_dict()[k]) for k, v in
                   weights.from_flax(raw, module).items())
    expected = np.load(os.path.join(GOLDENS, "expected.npz"))
    x = {k: expected[f"inputs/c2_run/{k}"] for k in ("seq", "src", "tgt")}
    np.testing.assert_allclose(
        model.predict(x["seq"], x["tgt"], source_poses=x["src"]).numpy(),
        expected["views/c2_run"], rtol=TOL, atol=TOL)
    with _blocked():
        tpredict_cli.main(["--ckpt", out, "--out", str(tmp_path / "v"),
                           "--azimuths", "0,90", "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "v")) == [
        "source.png", "view_00.png", "view_01.png"]


def test_snapshot_of_a_jax_run_without_ema_exports_params(tmp_path,
                                                          capsys):
    _, tm, params = _pair()
    run = tmp_path / "run"
    mgr = jckpt.make_manager(str(run))
    mgr.save(6, args=ocp.args.StandardSave(
        {"params": jax.tree.map(jnp.asarray, params), "ema_params": None,
         "step": jnp.int32(6)}))
    mgr.wait_until_finished()
    mgr.close()
    with open(run / "train_config.json", "w") as f:
        json.dump(tconfig.to_dict(tm.cfg), f)
    tsnapshot_cli.main(["--ckpt-dir", str(run), "--out",
                        str(tmp_path / "m")])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["ema"] is False and line["step"] == 6
    back = TModel.from_checkpoint(str(tmp_path / "m"), device="cpu")
    for k, v in tm.module.state_dict().items():
        assert torch.equal(back.module.state_dict()[k], v), k


# -------------------------------------------------------------- corruption
def test_corruption_and_other_layouts_raise(tmp_path):
    src = os.path.join(GOLDENS, "c2_model", "params_3")
    for target in ("manifest.ocdbt", None):
        bad = tmp_path / f"bad_{target}"
        shutil.copytree(src, bad)
        if target is None:          # the top-level root node
            target = os.path.join("d", os.listdir(bad / "d")[0])
        data = bytearray((bad / target).read_bytes())
        data[len(data) // 2] ^= 0x40
        (bad / target).write_bytes(bytes(data))
        with pytest.raises(ValueError, match="CRC32C|truncated|zstd"):
            _port_read(bad)
    for key in ("use_zarr3", "use_ocdbt"):
        other = tmp_path / key
        shutil.copytree(src, other)
        meta = json.loads((other / "_METADATA").read_text())
        meta[key] = not meta[key]
        (other / "_METADATA").write_text(json.dumps(meta))
        with pytest.raises(ValueError, match="OCDBT over zarr v2"):
            _port_read(other)


def test_reader_runs_with_its_dependencies_absent(tmp_path):
    """A fresh interpreter with every oracle package blocked reads a
    fixture and loads nothing of them."""
    code = textwrap.dedent(f"""
        import sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        from dynamic_multiview_3d_torch.train import orbax
        leaves = orbax.read_orbax({os.path.join(GOLDENS, FIXTURES[1])!r})
        assert len(leaves) > 50
        oracles = {BLOCKED!r} + ("dynamic_multiview_3d_tpu",)
        loaded = [n for n in sys.modules if sys.modules[n] is not None
                  and n.split(".")[0] in oracles]
        assert not loaded, loaded
    """)
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
