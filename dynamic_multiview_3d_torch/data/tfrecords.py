"""TFRecord ingestion (port of data/tfrecords.py; ``data.source=
"tfrecords"``), with no TensorFlow.

On-disk contract: ``cfg.root`` holds one or more ``*.tfrecord`` shard
files. Each record is a serialized ``tf.train.Example`` describing one
frame:

    scene          bytes   scene id (records of one scene may span shards)
    view           int64   camera index v in [0, V)
    t              int64   timestep in [0, T)
    image/encoded  bytes   PNG-encoded RGB(A) frame
    pose           floats  (az, el, radius) look-at pose of camera v
    num_views      int64   V for the scene
    seq_len        int64   T for the scene
    dynamic        int64   0/1

The reader walks each shard's record framing once at init (u64le length,
masked crc32c of the length, payload, masked crc32c of the payload),
recording (shard, offset, size) per frame, then memory-maps the shards and
parses only the records a batch touches. The ``tf.train.Example`` codec
(``encode_example`` / ``decode_example``) and the crc32c are this module's
own: protobuf's wire format for Features -> map<string, Feature> ->
BytesList / FloatList / Int64List, decoding repeated numbers packed (as
TensorFlow writes them) or not. ``export_tfrecords`` writes shards that
``tf.data.TFRecordDataset`` and ``example_pb2`` read.

Sampling and batching are FrameFolderScenes', so the stream iterator,
orbit sources and the train loop do not depend on the layout.
"""

from __future__ import annotations

import glob
import os
import struct

import numpy as np

from dynamic_multiview_3d_torch.config import DataConfig
from dynamic_multiview_3d_torch.data.frames import FrameFolderScenes
from dynamic_multiview_3d_torch.utils.png import encode_png, read_png

# --- masked crc32c (Castagnoli), as TFRecord framing requires ------------

_CRC_TABLE: list[int] = []


def _crc32c_table() -> list[int]:
    if not _CRC_TABLE:
        poly = 0x82F63B78                      # reflected Castagnoli
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc32c_table()
    crc = 0xFFFFFFFF
    for b in bytes(data):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# --- tf.train.Example wire format ----------------------------------------

def _varint(value: int) -> bytes:
    value &= (1 << 64) - 1                     # int64: two's complement
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    value = shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated protobuf varint")
        byte = data[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return value, pos
        shift += 7


def _field(number: int, payload: bytes) -> bytes:
    """A length-delimited field (wire type 2)."""
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def _fields(data: bytes):
    """Yield (field number, wire type, value) of a message: ints for
    varints, bytes for the other wire types."""
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(data, pos)
        elif wire == 1:
            value, pos = data[pos:pos + 8], pos + 8
        elif wire == 2:
            length, pos = _read_varint(data, pos)
            value, pos = data[pos:pos + length], pos + length
        elif wire == 5:
            value, pos = data[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        if pos > len(data):
            raise ValueError("truncated protobuf field")
        yield number, wire, value


def encode_example(features: dict) -> bytes:
    """A serialized tf.train.Example of ``features``: name -> a list of
    bytes (BytesList), of ints (Int64List) or of floats / a float array
    (FloatList, packed)."""
    entries = []
    for name, values in features.items():
        values = list(values)
        if all(isinstance(v, (bytes, bytearray)) for v in values):
            kind, body = 1, b"".join(_field(1, bytes(v)) for v in values)
        elif all(isinstance(v, (int, np.integer)) for v in values):
            kind, body = 3, _field(1, b"".join(_varint(int(v))
                                               for v in values))
        else:
            kind, body = 2, _field(1, np.asarray(values, "<f4").tobytes())
        feature = _field(kind, body)
        entries.append(_field(1, _field(1, name.encode()) + _field(2, feature)))
    return _field(1, b"".join(entries))


def _decode_feature(data: bytes):
    for kind, _, body in _fields(data):
        if kind == 1:                                       # BytesList
            return [bytes(v) for n, _, v in _fields(body) if n == 1]
        if kind == 2:                                       # FloatList
            chunks = [v for n, _, v in _fields(body) if n == 1]
            return np.frombuffer(b"".join(chunks), "<f4").astype(np.float32)
        if kind == 3:                                       # Int64List
            out = []
            for n, wire, v in _fields(body):
                if n != 1:
                    continue
                if wire == 0:
                    out.append(v)
                else:                                       # packed
                    pos = 0
                    while pos < len(v):
                        x, pos = _read_varint(v, pos)
                        out.append(x)
            return [x - (1 << 64) if x >> 63 else x for x in out]
    return []


def decode_example(data: bytes) -> dict:
    """A serialized tf.train.Example -> {name: list of bytes | list of
    ints | float32 array}."""
    out = {}
    for n, _, features in _fields(bytes(data)):
        if n != 1:
            continue
        for m, _, entry in _fields(features):
            if m != 1:
                continue
            key, value = b"", b""
            for k, _, v in _fields(entry):
                if k == 1:
                    key = v
                elif k == 2:
                    value = v
            out[key.decode()] = _decode_feature(value)
    return out


# --- framing -------------------------------------------------------------

def iter_record_spans(path: str, verify_crc: bool = False):
    """Yield (offset, length) of each record payload in a TFRecord shard.

    Default: framing only, one pass over the 12-byte headers (framing
    corruption surfaces as a parse error at access time). A bit-flip
    inside a payload still parses, feeding wrong pixels; ``verify_crc``
    (``data.verify_crc``) checks both masked CRCs of every record and
    raises with the shard and offset at the first mismatch.
    """
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        pos = 0
        while pos + 12 <= size:
            header = f.read(12)
            (length,) = struct.unpack("<Q", header[:8])
            payload_at = pos + 12
            if payload_at + length + 4 > size:
                raise ValueError(f"truncated tfrecord shard: {path}")
            if verify_crc:
                (len_crc,) = struct.unpack("<I", header[8:12])
                if len_crc != _masked_crc(header[:8]):
                    raise ValueError(
                        f"tfrecord length-CRC mismatch at {path}:{pos}")
                payload = f.read(length)
                (pay_crc,) = struct.unpack("<I", f.read(4))
                if pay_crc != _masked_crc(payload):
                    raise ValueError(
                        f"tfrecord payload-CRC mismatch at "
                        f"{path}:{payload_at} (length {length})")
            yield payload_at, length
            pos = payload_at + length + 4
            f.seek(pos)


def write_records(path: str, payloads) -> None:
    """Write serialized payloads in TFRecord framing (tf.io-compatible)."""
    with open(path, "wb") as f:
        for data in payloads:
            header = struct.pack("<Q", len(data))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(data)
            f.write(struct.pack("<I", _masked_crc(data)))


class TFRecordScenes(FrameFolderScenes):
    """Random-access examples over TFRecord shards (``data.root`` glob)."""

    def __init__(self, cfg: DataConfig):
        if not cfg.root:
            raise FileNotFoundError("tfrecords source needs data.root")
        pattern = cfg.root if any(ch in cfg.root for ch in "*?[") else \
            os.path.join(cfg.root, "*.tfrecord*")
        self.shards = sorted(glob.glob(pattern))
        if not self.shards:
            raise FileNotFoundError(f"no tfrecord shards match {pattern!r}")
        self.cfg = cfg
        # index pass: (scene, view, t) -> (shard, offset, size) + poses
        scenes: dict[str, dict] = {}
        for si, shard in enumerate(self.shards):
            with open(shard, "rb") as f:
                data = f.read()
            for off, length in iter_record_spans(
                    shard, verify_crc=cfg.verify_crc):
                feat = decode_example(data[off:off + length])
                name = feat["scene"][0].decode()
                v, t = int(feat["view"][0]), int(feat["t"][0])
                rec = scenes.setdefault(name, {
                    "num_views": int(feat["num_views"][0]),
                    "seq_len": int(feat["seq_len"][0]),
                    "dynamic": bool(feat["dynamic"][0]),
                    "packed": False,
                    "_spans": {},
                    "_poses": {},
                })
                rec["_spans"][(v, t)] = (si, off, length)
                rec["_poses"][v] = np.asarray(feat["pose"], np.float32)
        for name, rec in scenes.items():
            vv, tt = rec["num_views"], rec["seq_len"]
            missing = [(v, t) for v in range(vv) for t in range(tt)
                       if (v, t) not in rec["_spans"]]
            if missing:
                raise ValueError(
                    f"tfrecord scene {name!r} is missing frames "
                    f"{missing[:4]}{'...' if len(missing) > 4 else ''}")
            rec["poses"] = np.stack(
                [rec["_poses"][v] for v in range(vv)]).astype(np.float32)
        self.scenes = sorted(scenes)
        self._meta_cache = {name: scenes[name] for name in self.scenes}
        self._pack_cache: dict[str, np.ndarray] = {}
        self._mmaps: list[np.ndarray] | None = None

    def __getstate__(self) -> dict:
        """For worker processes: the index, but no memory maps and no
        materialized banks (the worker maps the shards again)."""
        state = dict(self.__dict__)
        state["_meta_cache"] = {name: dict(meta, packed=False)
                                for name, meta in self._meta_cache.items()}
        state["_pack_cache"] = {}
        state["_mmaps"] = None
        return state

    def _meta(self, scene: str) -> dict:
        return self._meta_cache[scene]

    def _read_frame(self, scene: str, view: int, t: int) -> np.ndarray:
        if self._mmaps is None:
            self._mmaps = [np.memmap(s, np.uint8, "r") for s in self.shards]
        si, off, length = self._meta_cache[scene]["_spans"][(view, t)]
        feat = decode_example(self._mmaps[si][off:off + length].tobytes())
        img = read_png(feat["image/encoded"][0])
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        return img[..., :3]


def export_tfrecords(root: str, num_scenes: int = 4, image_size: int = 64,
                     num_views: int = 8, seq_len: int = 1,
                     dynamic: bool = False, seed: int = 0,
                     shards: int = 2, scene_offset: int = 0) -> str:
    """Materialize procedural scenes as TFRecord shards. Frames go
    round-robin over ``shards`` files, so scenes span shards (the reader
    must reassemble them)."""
    from dynamic_multiview_3d_torch.data.synthetic import SyntheticScenes

    src = SyntheticScenes(num_scenes=num_scenes + scene_offset,
                          image_size=image_size, seq_len=seq_len,
                          dynamic=dynamic, seed=seed)
    rng = np.random.default_rng(seed + 11)
    os.makedirs(root, exist_ok=True)
    payloads: list[list[bytes]] = [[] for _ in range(shards)]
    n = 0
    for i in range(scene_offset, scene_offset + num_scenes):
        poses = src.sample_poses(rng, num_views)
        for v in range(num_views):
            for t in range(seq_len):
                img = src.render(i, poses[v],
                                 time=t / max(seq_len - 1, 1))
                payloads[n % shards].append(encode_example({
                    "scene": [f"scene_{i:05d}".encode()],
                    "view": [v],
                    "t": [t],
                    "image/encoded": [encode_png(img)],
                    "pose": np.asarray(poses[v], np.float32),
                    "num_views": [num_views],
                    "seq_len": [seq_len],
                    "dynamic": [int(dynamic)],
                }))
                n += 1
    for s in range(shards):
        write_records(
            os.path.join(root, f"frames-{s:05d}-of-{shards:05d}.tfrecord"),
            payloads[s])
    return root
