"""The port's data sources (data/frames.py, tfrecords.py, shapenet.py,
native.py, utils/png.py) against the JAX package's, mirroring
tests/test_frames.py, test_tfrecords.py and test_shapenet.py.

The inputs are exports written by the JAX package's own exporters
(imageio, OpenCV and TensorFlow are installed here), read through both
packages: uint8 frames and examples must be bitwise equal, with the same
``sample_indices`` draws and poses. The other way, the JAX readers (and
``tf.data`` / ``example_pb2``) must read the port's exports bitwise.
``SyntheticFrames`` renders with the port's renderer, which fills faces
without anti-aliasing: its poses and draws are exact, its pixels held to
tests/test_torch_data.py's edge bound (mean under 3 levels, under 5% of
pixels off by more than 8). The native packer at identity size: the
port's C++ bitwise equal to the JAX package's C++, the numpy version
within 1 ulp; the resize within 1 level of ``cv2.resize``.
"""

import dataclasses
import glob
import io
import os
import shutil

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from dynamic_multiview_3d_torch import config as tconfig
from dynamic_multiview_3d_torch.data import frames as tframes
from dynamic_multiview_3d_torch.data import native as tnative
from dynamic_multiview_3d_torch.data import pipeline as tpipeline
from dynamic_multiview_3d_torch.data import resident as tresident
from dynamic_multiview_3d_torch.data import shapenet as tshapenet
from dynamic_multiview_3d_torch.data import tfrecords as ttfr
from dynamic_multiview_3d_torch.utils import png as tpng
from dynamic_multiview_3d_tpu import config as jconfig
from dynamic_multiview_3d_tpu.data import frames as jframes
from dynamic_multiview_3d_tpu.data import native as jnative
from dynamic_multiview_3d_tpu.data import shapenet as jshapenet
from dynamic_multiview_3d_tpu.data import tfrecords as jtfr

tf = pytest.importorskip("tensorflow")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tiny model: the suite runs
    several worker processes on a few cores, and torch's default of a
    thread per core each makes them wait on one another's threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(**kw):
    """The same DataConfig in both packages."""
    return tconfig.DataConfig(**kw), jconfig.DataConfig(**kw)


def _same_examples(a, b, raw=True):
    assert a.keys() == b.keys()
    for k in a:
        if raw or k.endswith("poses"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            np.testing.assert_allclose(a[k], b[k], atol=1e-6, err_msg=k)


def _same_draws(a, b):
    """Two sample_indices draws: (scene, src_views, tgt_views, t0)."""
    assert a[0] == b[0] and a[3] == b[3]
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])


def _edge_bound(a, b):
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert d.mean() < 3.0 and (d > 8).mean() < 0.05, (d.mean(),
                                                      (d > 8).mean())


@pytest.fixture(scope="module")
def jax_exports(tmp_path_factory):
    """Frame folders (png, packed) and tfrecord shards written by the JAX
    package's exporters."""
    root = tmp_path_factory.mktemp("jax_exports")
    kw = dict(num_scenes=2, image_size=48, num_views=4, seq_len=3,
              dynamic=True, seed=3)
    out = {fmt: jframes.export_synthetic(str(root / fmt), fmt=fmt, **kw)
           for fmt in ("png", "packed")}
    out["tfr"] = jtfr.export_tfrecords(str(root / "tfr"), num_scenes=3,
                                       image_size=32, num_views=4,
                                       seq_len=2, dynamic=True, seed=0,
                                       shards=2)
    return out


@pytest.fixture(scope="module")
def shapenet_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("shapenet"))
    jshapenet.export_fixture(root, num_scenes=3, image_size=48, num_views=6,
                             with_synset_level=True, rgba=True)
    # one model without the synset level or rendering/ subdir, plain RGB
    jshapenet.export_fixture(root, num_scenes=1, image_size=48, num_views=6,
                             with_synset_level=False, rgba=False,
                             nested_rendering=False, model_prefix="flat",
                             seed=7)
    return root


# ---------------------------------------------------------------- PNG reader
def _filters(png: bytes) -> set:
    """The filter types of a PNG's rows (8-bit, non-interlaced)."""
    import struct
    import zlib
    pos, idat, header = 8, b"", None
    while pos < len(png):
        length, tag = struct.unpack(">I4s", png[pos:pos + 8])
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", png[pos + 8:pos + 8 + length])
        if tag == b"IDAT":
            idat += png[pos + 8:pos + 8 + length]
        pos += 12 + length
    w, h, _, color = header[:4]
    stride = 1 + w * {0: 1, 2: 3, 6: 4}[color]
    raw = zlib.decompress(idat)
    return {raw[y * stride] for y in range(h)}


def test_read_png_matches_imageio(rng):
    """imageio (PIL) picks a filter per row; read_png decodes its files
    bitwise as imageio does, in gray, RGB and RGBA."""
    from dynamic_multiview_3d_tpu.data.synthetic import SyntheticScenes
    src = SyntheticScenes(num_scenes=2, image_size=64)
    yy, xx = np.mgrid[0:40, 0:56]
    images = [src.render(1, np.array([0.5, 0.3, 2.0], np.float32)),
              rng.integers(0, 256, (37, 53, 3), dtype=np.uint8),
              ((xx * 5 + yy * 3) % 256).astype(np.uint8),
              np.stack([(xx * 4) % 256, (yy * 6) % 256, (xx + yy) % 256,
                        np.full_like(xx, 200)], -1).astype(np.uint8)]
    seen = set()
    for img in images:
        buf = io.BytesIO()
        imageio.imwrite(buf, img, format="png")
        seen |= _filters(buf.getvalue())
        np.testing.assert_array_equal(tpng.read_png(buf.getvalue()),
                                      imageio.imread(buf.getvalue()))
    assert seen > {0, 1, 2}, seen       # PIL's adaptive choice at work


def _filtered_png(img: np.ndarray, kind: int) -> bytes:
    """A PNG of ``img`` [H, W, C] whose every row carries filter ``kind``
    (0 None, 1 Sub, 2 Up, 3 Avg, 4 Paeth), filtered here with numpy."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    out, prior = [], np.zeros(w * c, np.int64)
    for cur in rows:
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prior[:-c]])
        p = left + prior - upleft
        pa, pb, pc = (np.abs(p - q) for q in (left, prior, upleft))
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, prior, upleft))
        pred = [0, left, prior, (left + prior) // 2, paeth][kind]
        out.append(np.concatenate([[kind], (cur - pred) % 256]))
        prior = cur
    return _png(w, h, 8, {1: 0, 3: 2, 4: 6}[c], 0,
                np.asarray(out, np.uint8).tobytes())


def _png(w, h, depth, color, interlace, rows: bytes) -> bytes:
    """A PNG file of the given header and filtered rows."""
    import struct
    import zlib

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0,
                                         0, interlace))
            + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_read_png_undoes_every_filter(rng, kind, channels):
    """Every row filtered by one type: read_png and imageio both give the
    image back."""
    img = rng.integers(0, 256, (11, 13, channels), dtype=np.uint8)
    data = _filtered_png(img, kind)
    want = img[..., 0] if channels == 1 else img
    assert _filters(data) == {kind}
    np.testing.assert_array_equal(imageio.imread(data), want)
    np.testing.assert_array_equal(tpng.read_png(data), want)


@pytest.mark.parametrize("shape", [(9, 7), (9, 7, 1), (9, 7, 3), (9, 7, 4)])
def test_encode_png_reads_back_in_both_readers(tmp_path, rng, shape):
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    data = tpng.encode_png(img)
    want = img.reshape(img.shape[:2]) if img.ndim == 2 or shape[-1] == 1 \
        else img
    np.testing.assert_array_equal(tpng.read_png(data), want)
    np.testing.assert_array_equal(imageio.imread(data), want)


@pytest.mark.parametrize("depth,color,interlace,what", [
    (16, 0, 0, "bit depth 16"), (8, 3, 0, "colour type 3"),
    (8, 4, 0, "colour type 4"), (8, 2, 1, "interlace 1")])
def test_read_png_refuses_other_formats(depth, color, interlace, what):
    data = _png(4, 4, depth, color, interlace, bytes(4 * 25))
    with pytest.raises(ValueError, match=what):
        tpng.read_png(data)
    with pytest.raises(ValueError, match="signature"):
        tpng.read_png(b"GIF89a")


# ---------------------------------------------------------- packer, resize
@pytest.mark.parametrize("src,dst", [((48, 48), (32, 32)),
                                     ((137, 137), (128, 128)),
                                     ((20, 20), (40, 40)),
                                     ((33, 17), (64, 9)),
                                     ((1, 1), (4, 4))])
def test_resize_u8_within_one_level_of_cv2(rng, src, dst):
    img = rng.integers(0, 256, (3, *src, 3), dtype=np.uint8)
    ours = tnative.resize_u8(img, *dst)
    ref = np.stack([cv2.resize(f, dst[::-1], interpolation=cv2.INTER_LINEAR)
                    .reshape(*dst, 3) for f in img])
    d = np.abs(ours.astype(np.int32) - ref)
    assert ours.shape == ref.shape and d.max() <= 1
    if src[0] > dst[0]:                 # OpenCV's vector path: exact
        assert d.max() == 0


@pytest.mark.parametrize("src,dst", [((16, 16), (16, 16)),
                                     ((48, 48), (32, 32)),
                                     ((20, 20), (40, 40)),
                                     ((1, 7), (3, 7))])
def test_packer_matches_the_jax_packer(rng, src, dst):
    """The port's copy of framepack.cpp gives the JAX package's C++
    outputs bitwise; the numpy version is within 1 ulp (at identity
    size, and at the resizes too: it repeats the C++ arithmetic)."""
    assert jnative.available()
    img = rng.integers(0, 256, (3, *src, 3), dtype=np.uint8)
    ours = tnative.resize_normalize_pack(img, *dst)
    np.testing.assert_array_equal(ours,
                                  jnative.resize_normalize_pack(img, *dst))
    plain = tnative.resize_normalize_pack(img, *dst, native=False)
    ulps = np.abs(ours.view(np.int32) - plain.view(np.int32))
    assert ulps.max() <= 1
    store = rng.integers(0, 256, (6, *src, 3), dtype=np.uint8)
    idx = np.array([5, 0, 2, 2])
    ours = tnative.gather_pack(store, idx)
    np.testing.assert_array_equal(ours, jnative.gather_pack(store, idx))
    plain = tnative.gather_pack(store, idx, native=False)
    assert np.abs(ours.view(np.int32) - plain.view(np.int32)).max() <= 1
    np.testing.assert_allclose(ours, store[idx] / 127.5 - 1.0, atol=1e-6)


@pytest.mark.parametrize("native", [True, False])
def test_packer_edge_cases(rng, native):
    """A constant image stays constant through a resize, and 1-pixel-tall
    or wide inputs read nothing out of bounds (every output row equals
    the input row)."""
    out = tnative.resize_normalize_pack(
        np.full((1, 20, 20, 3), 100, np.uint8), 40, 40, native=native)
    np.testing.assert_allclose(out, 100 / 127.5 - 1.0, atol=1e-5)
    out = tnative.resize_normalize_pack(np.full((1, 1, 1, 3), 200, np.uint8),
                                        4, 4, native=native)
    np.testing.assert_allclose(out, 200 / 127.5 - 1.0, atol=1e-6)
    row = rng.integers(0, 256, (1, 1, 7, 3)).astype(np.uint8)
    out = tnative.resize_normalize_pack(row, 3, 7, native=native)
    for y in range(3):
        np.testing.assert_allclose(out[0, y], row[0, 0] / 127.5 - 1.0,
                                   atol=1e-6)
    with pytest.raises(IndexError):
        tnative.gather_pack(np.zeros((2, 4, 4, 3), np.uint8), [2],
                            native=native)


def test_native_build_is_cached_and_a_failed_build_raises(tmp_path,
                                                          monkeypatch):
    tnative.build()
    assert tnative.build() == ("", 0.0)           # cached: no compiler run
    bad = tmp_path / "framepack.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="build failed"):
        tnative.build()


# ------------------------------------------------------------ frame folders
def test_example_contract(jax_exports):
    """png frames resized 48 -> 32: uint8 examples bitwise equal to the JAX
    package's (the resize is OpenCV's), f32 within 1e-6 (both through
    the C++ packer), deterministic per index."""
    tcfg, jcfg = _cfgs(source="frames", root=jax_exports["png"],
                       image_size=32, seq_len=2, num_targets=2)
    ours, ref = tframes.FrameFolderScenes(tcfg), jframes.FrameFolderScenes(
        jcfg)
    for i in (0, 3):
        _same_draws(ours.sample_indices(i), ref.sample_indices(i))
        _same_examples(ours.example(i, raw=True), ref.example(i, raw=True))
        _same_examples(ours.example(i), ref.example(i), raw=False)
    ex = ours.example(0)
    assert ex["image_seq"].shape == (2, 32, 32, 3)
    assert -1.0 <= ex["image_seq"].min() and ex["image_seq"].max() <= 1.0
    np.testing.assert_array_equal(ex["image_seq"],
                                  ours.example(0)["image_seq"])


def test_batch_and_pipeline_make_source(jax_exports):
    tcfg, jcfg = _cfgs(source="frames", root=jax_exports["packed"],
                       image_size=48, seq_len=1, num_targets=1)
    ours = tpipeline.make_source(tcfg)
    assert isinstance(ours, tframes.FrameFolderScenes)
    b = ours.batch(range(3), raw=True)
    assert b["image_seq"].shape == (3, 1, 48, 48, 3)
    _same_examples(b, jframes.FrameFolderScenes(jcfg).batch(range(3),
                                                            raw=True))


def test_missing_root_raises(tmp_path):
    for root in ("/nonexistent/xyz", str(tmp_path)):
        with pytest.raises(FileNotFoundError):
            tframes.FrameFolderScenes(tconfig.DataConfig(source="frames",
                                                         root=root))


@pytest.mark.parametrize("use_native", [True, False])
def test_packed_and_png_give_the_jax_examples(jax_exports, use_native):
    """fmt='packed' (memory-mapped banks) and fmt='png' give identical
    examples in the port, equal to the JAX package's: raw bitwise; f32 (the
    packed gather fast path against per-frame decode) within 1e-6."""
    for i in (0, 5, 7):
        exs = {}
        for fmt in ("png", "packed"):
            tcfg, jcfg = _cfgs(source="frames", root=jax_exports[fmt],
                               image_size=48, seq_len=2, num_targets=2,
                               seed=3, use_native_packer=use_native)
            ours = tframes.FrameFolderScenes(tcfg)
            exs[fmt] = ours.example(i, raw=True), ours.example(i)
            ref = jframes.FrameFolderScenes(jcfg)
            _same_examples(exs[fmt][0], ref.example(i, raw=True))
            _same_examples(exs[fmt][1], ref.example(i), raw=False)
        _same_examples(exs["png"][0], exs["packed"][0])
        _same_examples(exs["png"][1], exs["packed"][1], raw=False)


def test_the_jax_readers_read_the_port_exports(tmp_path):
    """The port's exporters (its PNG writer, its .npy banks) write what
    the JAX readers read back bitwise, with the same draws."""
    for fmt in ("png", "packed"):
        root = tframes.export_synthetic(str(tmp_path / fmt), num_scenes=2,
                                        image_size=32, num_views=3,
                                        seq_len=2, dynamic=True, seed=5,
                                        fmt=fmt)
        tcfg, jcfg = _cfgs(source="frames", root=root, image_size=32,
                           seq_len=2, num_targets=2, seed=5)
        ours = tframes.FrameFolderScenes(tcfg)
        ref = jframes.FrameFolderScenes(jcfg)
        _same_examples(ours.batch(range(4), raw=True),
                       ref.batch(range(4), raw=True))
        _same_examples(ours.batch(range(4)), ref.batch(range(4)), raw=False)


def test_scene_offset_gives_disjoint_scenes(tmp_path):
    for off in (0, 1):
        tframes.export_synthetic(str(tmp_path / "d"), num_scenes=1,
                                 image_size=32, num_views=2, seq_len=1,
                                 fmt="packed", seed=0, scene_offset=off)
    assert sorted(os.listdir(tmp_path / "d")) == ["scene_00000",
                                                  "scene_00001"]
    b0 = np.load(tmp_path / "d" / "scene_00000" / "frames.npy")
    b1 = np.load(tmp_path / "d" / "scene_00001" / "frames.npy")
    assert not np.array_equal(b0, b1)   # different procedural geometry
    with pytest.raises(ValueError, match="format"):
        tframes.export_synthetic(str(tmp_path / "e"), num_scenes=1,
                                 image_size=32, fmt="jpeg")


@pytest.mark.parametrize("mode", ["orbit", "fixed"])
def test_src_views_draws_equal_jax(jax_exports, mode):
    """orbit: each frame from its own camera (distinct when V >= T);
    fixed: one camera for the whole sequence. The draws are the JAX
    package's, index for index."""
    tcfg, jcfg = _cfgs(source="frames", root=jax_exports["packed"],
                       image_size=48, seq_len=3, num_targets=2,
                       src_views=mode)
    ours, ref = tframes.FrameFolderScenes(tcfg), jframes.FrameFolderScenes(
        jcfg)
    for i in range(8):
        a = ours.sample_indices(i)
        _same_draws(a, ref.sample_indices(i))
        assert len(set(a[1].tolist())) == (3 if mode == "orbit" else 1)
    ex = ours.example(1)
    spread = np.abs(np.diff(ex["src_poses"], axis=0)).max()
    assert spread > 1e-3 if mode == "orbit" else spread < 1e-6


# ---------------------------------------------------- disk-free synthetic
def test_synthetic_frames_source_contract():
    """SyntheticFrames: cameras and draws exact against the JAX package's,
    pixels within the edge bound; ineligible for residency before
    materialize, eligible after, and the stream unchanged by it."""
    kw = dict(source="frames", root="", image_size=32, seq_len=3,
              num_targets=2, num_scenes=4, src_views="orbit", dynamic=True)
    tcfg, jcfg = _cfgs(**kw)
    ours, ref = tframes.SyntheticFrames(tcfg), jframes.SyntheticFrames(jcfg)
    assert ours.scenes == ref.scenes and ours.num_views == ref.num_views
    for scene in ours.scenes:
        np.testing.assert_array_equal(ours._meta(scene)["poses"],
                                      ref._meta(scene)["poses"])
    for i in range(8):
        _same_draws(ours.sample_indices(i), ref.sample_indices(i))
    a, b = ours.batch(range(4), raw=True), ref.batch(range(4), raw=True)
    for k in ("src_poses", "tgt_poses"):
        np.testing.assert_array_equal(a[k], b[k])
    for k in ("image_seq", "tgt_images"):
        _edge_bound(a[k], b[k])
    assert not tresident.fits_budget(ours, tcfg)
    before = ours.batch(range(4), raw=True)
    ours.materialize_packed()
    assert tresident.fits_budget(ours, tcfg)
    _same_examples(before, ours.batch(range(4), raw=True))


def test_make_source_empty_root_falls_back_to_synthetic_frames():
    cfg = tconfig.DataConfig(source="frames", root="", image_size=32,
                             num_scenes=2)
    with pytest.warns(UserWarning, match="SyntheticFrames"):
        src = tpipeline.make_source(cfg)
    assert isinstance(src, tframes.SyntheticFrames)


def test_synthetic_frames_disjoint_scene_offsets():
    def make(off):
        return tframes.SyntheticFrames(tconfig.DataConfig(
            source="frames", root="", image_size=32, num_scenes=2,
            scene_offset=off))
    a, b = make(0), make(2)
    fa = a._read_frame(a.scenes[0], 0, 0)
    fb = b._read_frame(b.scenes[0], 0, 0)
    assert np.abs(fa.astype(int) - fb.astype(int)).max() > 8


# ----------------------------------------------------------------- tfrecords
def _records(path):
    if tf.executing_eagerly():
        return [r.numpy() for r in tf.data.TFRecordDataset(path)]
    # another test file may have turned eager off for the whole process
    return list(tf.compat.v1.io.tf_record_iterator(path))


def test_tfrecord_framing_is_tf_io_compatible(tmp_path):
    """The port's framing (masked crc32c included) parses with tf.data,
    and tf.io.TFRecordWriter's output parses with the port's span walker;
    example_pb2 parses the port's examples, and the port's decoder reads
    TensorFlow's."""
    from tensorflow.core.example import example_pb2
    root = ttfr.export_tfrecords(str(tmp_path / "t"), num_scenes=2,
                                 image_size=16, num_views=2, seq_len=2,
                                 dynamic=True, shards=2)
    shard = sorted(glob.glob(root + "/*.tfrecord"))[0]
    theirs = _records(shard)
    with open(shard, "rb") as f:
        data = f.read()
    spans = list(ttfr.iter_record_spans(shard, verify_crc=True))
    assert [data[o:o + n] for o, n in spans] == theirs and theirs
    for payload in theirs:
        ex = example_pb2.Example.FromString(payload)
        ours = ttfr.decode_example(payload)
        feat = ex.features.feature
        assert set(feat) == set(ours)
        assert list(feat["view"].int64_list.value) == ours["view"]
        np.testing.assert_array_equal(
            np.asarray(feat["pose"].float_list.value, np.float32),
            ours["pose"])
        assert feat["image/encoded"].bytes_list.value[0] == \
            ours["image/encoded"][0]
        # TensorFlow's serialization (packed repeated numbers) decodes too
        again = ttfr.decode_example(ex.SerializeToString())
        assert again["view"] == ours["view"] and again["t"] == ours["t"]
        np.testing.assert_array_equal(again["pose"], ours["pose"])
    path = str(tmp_path / "tfio.tfrecord")
    with tf.io.TFRecordWriter(path) as w:
        for payload in theirs[:3]:
            w.write(payload)
    with open(path, "rb") as f:
        tdata = f.read()
    assert [tdata[o:o + n] for o, n in
            ttfr.iter_record_spans(path, verify_crc=True)] == theirs[:3]


def test_example_codec_unpacked_and_negative_numbers():
    """Repeated numbers written unpacked decode as packed ones do; int64s
    round-trip through their 10-byte two's complement."""
    from tensorflow.core.example import example_pb2
    ex = example_pb2.Example()
    feat = ex.features.feature
    feat["i"].int64_list.value.extend([-3, 0, 2 ** 40])
    feat["f"].float_list.value.extend([1.5, -2.25])
    feat["b"].bytes_list.value.extend([b"", b"xy"])
    want = {"i": [-3, 0, 2 ** 40], "b": [b"", b"xy"]}
    packed = ttfr.decode_example(ex.SerializeToString())
    assert {k: packed[k] for k in want} == want
    np.testing.assert_array_equal(packed["f"], [1.5, -2.25])
    # the same numbers unpacked: one tag per value (protobuf parsers
    # accept both forms; example_pb2 checks this construction)
    def entry(name, feature):
        return ttfr._field(1, ttfr._field(1, name) + ttfr._field(2, feature))
    ints = b"".join(ttfr._varint(1 << 3) + ttfr._varint(v)
                    for v in want["i"])
    floats = b"".join(ttfr._varint(1 << 3 | 5) + np.float32(v).tobytes()
                      for v in (1.5, -2.25))
    unpacked = ttfr._field(1, entry(b"i", ttfr._field(3, ints))
                           + entry(b"f", ttfr._field(2, floats)))
    check = example_pb2.Example.FromString(unpacked).features.feature
    assert list(check["i"].int64_list.value) == want["i"]
    again = ttfr.decode_example(unpacked)
    assert again["i"] == want["i"]
    np.testing.assert_array_equal(again["f"], [1.5, -2.25])
    back = example_pb2.Example.FromString(ttfr.encode_example(
        {"i": want["i"], "b": want["b"], "f": np.float32([1.5, -2.25])}))
    assert list(back.features.feature["i"].int64_list.value) == want["i"]
    assert list(back.features.feature["b"].bytes_list.value) == want["b"]


def test_reader_reassembles_scenes_across_shards(jax_exports):
    """On the JAX package's shards: the same scenes, poses and uint8
    examples as its reader, bitwise."""
    tcfg, jcfg = _cfgs(source="tfrecords", root=jax_exports["tfr"],
                       image_size=32, seq_len=2, num_targets=2)
    ours, ref = ttfr.TFRecordScenes(tcfg), jtfr.TFRecordScenes(jcfg)
    assert ours.scenes == ref.scenes == ["scene_00000", "scene_00001",
                                         "scene_00002"]
    meta = ours._meta(ours.scenes[0])
    assert meta["num_views"] == 4 and meta["seq_len"] == 2
    for scene in ours.scenes:
        np.testing.assert_array_equal(ours._meta(scene)["poses"],
                                      ref._meta(scene)["poses"])
    _same_examples(ours.batch(range(7), raw=True),
                   ref.batch(range(7), raw=True))
    _same_examples(ours.example(7), ref.example(7), raw=False)


def test_the_jax_reader_reads_the_port_shards(tmp_path):
    root = ttfr.export_tfrecords(str(tmp_path / "t"), num_scenes=2,
                                 image_size=32, num_views=3, seq_len=2,
                                 dynamic=True, seed=1, shards=2)
    tcfg, jcfg = _cfgs(source="tfrecords", root=root, image_size=32,
                       seq_len=2, num_targets=2, verify_crc=True)
    ours, ref = ttfr.TFRecordScenes(tcfg), jtfr.TFRecordScenes(jcfg)
    _same_examples(ours.batch(range(4), raw=True),
                   ref.batch(range(4), raw=True))


def test_tfrecord_frames_match_synthetic_render(tmp_path):
    """Pixel parity with the procedural renderer the export drew from."""
    from dynamic_multiview_3d_torch.data.synthetic import SyntheticScenes
    root = ttfr.export_tfrecords(str(tmp_path / "t"), num_scenes=3,
                                 image_size=32, num_views=4, seq_len=2,
                                 dynamic=True, seed=0, shards=2)
    ds = ttfr.TFRecordScenes(tconfig.DataConfig(
        source="tfrecords", root=root, image_size=32))
    src = SyntheticScenes(num_scenes=3, image_size=32, seq_len=2,
                          dynamic=True, seed=0)
    poses = src.sample_poses(np.random.default_rng(0 + 11), 4)
    np.testing.assert_array_equal(ds._read_frame("scene_00000", 2, 1),
                                  src.render(0, poses[2], time=1.0))


def test_pipeline_source_dispatch(jax_exports):
    src = tpipeline.make_source(tconfig.DataConfig(
        source="tfrecords", root=jax_exports["tfr"] + "/*.tfrecord",
        image_size=32, seq_len=2, num_targets=1))
    assert isinstance(src, ttfr.TFRecordScenes) and len(src.shards) == 2
    assert src.batch(range(4))["image_seq"].shape == (4, 2, 32, 32, 3)


def test_missing_frame_is_loud(jax_exports, tmp_path):
    """A scene with a missing (view, t) frame fails at init, not
    mid-train; so do a truncated shard and no shard at all."""
    shards = sorted(glob.glob(jax_exports["tfr"] + "/frames-*.tfrecord"))
    broken = tmp_path / "broken"
    broken.mkdir()
    shutil.copy(shards[0], broken / "frames-00000-of-00001.tfrecord")
    cfg = tconfig.DataConfig(source="tfrecords", root=str(broken),
                             image_size=32)
    with pytest.raises(ValueError, match="missing frames"):
        ttfr.TFRecordScenes(cfg)
    with open(shards[0], "rb") as f:
        data = f.read()
    (broken / "frames-00000-of-00001.tfrecord").write_bytes(data[:-7])
    with pytest.raises(ValueError, match="truncated"):
        ttfr.TFRecordScenes(cfg)
    with pytest.raises(FileNotFoundError):
        ttfr.TFRecordScenes(dataclasses.replace(cfg,
                                                root=str(tmp_path / "no")))


def test_framing_roundtrip_property():
    """Arbitrary payloads survive write -> span walk byte-exact, and
    their CRCs verify."""
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=20, deadline=None)
    @given(st.lists(st.binary(min_size=0, max_size=300), min_size=1,
                    max_size=8))
    def check(payloads):
        import tempfile
        fd, path = tempfile.mkstemp(suffix=".tfrecord")
        os.close(fd)
        try:
            ttfr.write_records(path, payloads)
            with open(path, "rb") as f:
                data = f.read()
            assert [data[o:o + n] for o, n in ttfr.iter_record_spans(
                path, verify_crc=True)] == payloads
        finally:
            os.unlink(path)

    check()


def test_crc32c_matches_the_c_implementation(rng):
    import google_crc32c
    for n in (0, 1, 7, 300):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert ttfr.crc32c(data) == google_crc32c.value(data)
    assert ttfr.crc32c(b"123456789") == 0xE3069283   # the check value


def test_verify_crc_catches_payload_bitflip(jax_exports, tmp_path):
    """data.verify_crc: framing alone cannot see a bit-flip inside a
    payload (it parses, feeding wrong pixels); the CRC pass must."""
    root = tmp_path / "corrupt"
    shutil.copytree(jax_exports["tfr"], root)
    shard = sorted(str(p) for p in root.glob("*.tfrecord"))[0]
    off, length = next(ttfr.iter_record_spans(shard))
    with open(shard, "r+b") as f:
        f.seek(off + length // 2)
        b = f.read(1)
        f.seek(off + length // 2)
        f.write(bytes([b[0] ^ 0x10]))
    cfg = tconfig.DataConfig(source="tfrecords", root=str(root),
                             image_size=32, seq_len=2, num_targets=1)
    ttfr.TFRecordScenes(cfg)              # framing only: corruption unseen
    with pytest.raises(ValueError, match="payload-CRC mismatch"):
        ttfr.TFRecordScenes(dataclasses.replace(cfg, verify_crc=True))
    ttfr.TFRecordScenes(dataclasses.replace(cfg, root=jax_exports["tfr"],
                                            verify_crc=True))


def test_tfrecord_source_pickles_without_its_maps(jax_exports):
    """A worker process gets the index but no memory maps: it maps the
    shards again and reads the same frames."""
    import pickle
    src = ttfr.TFRecordScenes(tconfig.DataConfig(
        source="tfrecords", root=jax_exports["tfr"], image_size=32,
        seq_len=2, num_targets=2))
    want = src.batch(range(3), raw=True)
    assert src._mmaps is not None
    copy = pickle.loads(pickle.dumps(src))
    assert copy._mmaps is None and copy._meta_cache.keys() == \
        src._meta_cache.keys()
    _same_examples(copy.batch(range(3), raw=True), want)


# ------------------------------------------------------------------ shapenet
def _snet_cfgs(root, **kw):
    return _cfgs(source="shapenet_dir", root=root, image_size=32, seq_len=1,
                 num_targets=2, batch_size=2, **kw)


def test_discovers_all_layout_variants(shapenet_root):
    tcfg, jcfg = _snet_cfgs(shapenet_root)
    src = tpipeline.make_source(tcfg)
    assert isinstance(src, tshapenet.ShapeNetDirScenes)
    assert src.scenes == jshapenet.ShapeNetDirScenes(jcfg).scenes
    assert len(src.scenes) == 4          # 3 synset-nested + 1 flat
    with pytest.raises(FileNotFoundError):
        tshapenet.ShapeNetDirScenes(dataclasses.replace(
            tcfg, root=str(os.path.dirname(shapenet_root)) + "/none"))


def test_shapenet_example_contract(shapenet_root):
    """Poses (degrees -> radians, distance as radius) and uint8 examples
    (resized 48 -> 32) bitwise equal to the JAX reader's."""
    tcfg, jcfg = _snet_cfgs(shapenet_root)
    ours = tshapenet.ShapeNetDirScenes(tcfg)
    ref = jshapenet.ShapeNetDirScenes(jcfg)
    for scene in ours.scenes:
        np.testing.assert_array_equal(ours._meta(scene)["poses"],
                                      ref._meta(scene)["poses"])
    _same_examples(ours.batch(range(5), raw=True),
                   ref.batch(range(5), raw=True))
    ex = ours.example(0)
    assert ex["image_seq"].shape == (1, 32, 32, 3)
    assert ex["tgt_images"].shape == (2, 32, 32, 3)
    assert ex["image_seq"].std() > 0.05
    poses = ours._meta(ours.scenes[0])["poses"]
    assert poses.shape == (6, 3) and poses[:, 2].min() > 0.5
    assert 0.0 <= poses[:, 0].min() and poses[:, 0].max() < 2 * np.pi + 1e-5


def test_rgba_composite_matches_rgb_render(shapenet_root, tmp_path):
    """Opaque RGBA frames decode to the plain-RGB render; a half-transparent
    one composites over white by the JAX package's integer formula."""
    from dynamic_multiview_3d_torch.data.synthetic import SyntheticScenes
    root = tshapenet.export_fixture(str(tmp_path / "s"), num_scenes=1,
                                    image_size=48, num_views=2)
    src = tshapenet.ShapeNetDirScenes(_snet_cfgs(root)[0])
    scene = src.scenes[0]
    ref = SyntheticScenes(num_scenes=1, image_size=48, seed=0).render(
        0, src._meta(scene)["poses"][0], time=0.0)
    np.testing.assert_array_equal(src._read_frame(scene, 0, 0), ref)
    rgba = np.concatenate([ref, np.full((48, 48, 1), 128, np.uint8)], -1)
    with open(os.path.join(root, scene, "01.png"), "wb") as f:
        f.write(tpng.encode_png(rgba))
    jsrc = jshapenet.ShapeNetDirScenes(_snet_cfgs(root)[1])
    np.testing.assert_array_equal(src._read_frame(scene, 1, 0),
                                  jsrc._read_frame(scene, 1, 0))
    # the JAX reader reads the port's fixture bitwise
    _same_examples(src.batch(range(2), raw=True),
                   jsrc.batch(range(2), raw=True))


def test_training_runs_on_foreign_layout(shapenet_root, tmp_path):
    from dynamic_multiview_3d_torch.train import loop as tloop
    cfg = tconfig.get_config("default", [
        "model.image_size=32", "model.num_levels=3", "model.base_features=8",
        "model.max_features=16", "model.gru_features=16",
        "model.pose_embed_dim=8", "model.dtype=float32",
        "data.source=shapenet_dir", f"data.root={shapenet_root}",
        "data.image_size=32", "data.batch_size=2", "data.num_targets=2",
        "train.lr=1e-3", "train.num_steps=2", "train.log_every=1",
        f"train.ckpt_dir={tmp_path}/ckpt", "train.ckpt_every=2"])
    with pytest.warns(UserWarning, match="resolved to OFF"):
        _, metrics = tloop.train(cfg, device="cpu")
    assert np.isfinite(metrics["loss/total"])
