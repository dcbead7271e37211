"""Orbax checkpoints with numpy alone: the reader and writer of the layout
that the JAX package's ``StandardCheckpointer`` writes (its model dirs'
``params_<step>/`` and its manager's ``<step>/default/``).

That layout is three formats, one inside the other:

- ``_METADATA``: JSON naming every leaf of the tree (``tree_metadata``, the
  key path of each leaf: key_type 1 a sequence index, 2 a dict key).
- OCDBT, tensorstore's key-value store: ``manifest.ocdbt`` names the root
  of a B-tree whose nodes sit in data files under ``d/``; a value is inline
  in its leaf node or a byte range of a data file. A multi-process writer
  puts each process's tree under ``ocdbt.process_<i>/`` and a top-level
  tree over them, whose references carry that prefix.
- zarr v2: each leaf ``a.b.c`` is an array of keys ``a.b.c/.zarray``
  (JSON) and ``a.b.c/<i>.<j>...`` (one chunk each, zstd-compressed).

Manifests and nodes are a header (magic, length, version, compression),
a body (zstd-compressed when the header says so) and a CRC32C. Their
fields are varints laid out by column (every entry's key prefix length,
then every suffix length, ...). The zstd decoder is ``utils/zstd.py``.

``write_orbax`` writes the same layout from one process: a top-level
manifest and one data file holding the large values and a single leaf
node, both uncompressed (compression method 0, which tensorstore reads),
with the config Orbax itself records, so that Orbax and tensorstore read
it as one of their own. Its chunks are zstd frames of raw blocks: the
whole array in one chunk, no compressor needed.
"""

from __future__ import annotations

import json
import os
import struct
import time
import uuid

import numpy as np
import torch

from dynamic_multiview_3d_torch.data.tfrecords import crc32c
from dynamic_multiview_3d_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_NO_ROOT = (1 << 64) - 1          # offset/length of an empty tree's root
# the config Orbax 0.11 records: inline values up to 1 KiB, nodes up to
# 100 MB decoded, version tree arity 2**4, zstd level 0
ORBAX_CONFIG = {"max_inline_value_bytes": 1024,
                "max_decoded_node_bytes": 100_000_000,
                "version_tree_arity_log2": 4}
_DTYPES = ("<f2", "<f4", "<f8", "|i1", "<i2", "<i4", "<i8", "|u1", "<u2",
           "<u4", "<u8", "|b1", "bfloat16")


class _Bytes:
    """A cursor over a decoded body; running off its end is corruption."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value = shift = 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint too long")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def done(self) -> None:
        if self.pos != len(self.data):
            raise ValueError(f"{self.what}: {len(self.data) - self.pos} "
                             "bytes after its last field")


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _varints(values) -> bytes:
    return b"".join(_varint(v) for v in values)


# ------------------------------------------------------ manifests and nodes
def _unwrap(data: bytes, magic: int, what: str, max_body: int) -> _Bytes:
    """The body of a manifest or node: checks magic, length, version and
    CRC32C, and decodes the compression."""
    if len(data) < 18 or struct.unpack(">I", data[:4])[0] != magic:
        kind = "manifest" if magic == MANIFEST_MAGIC else "node"
        raise ValueError(f"{what}: not an OCDBT {kind}")
    (length,) = struct.unpack("<Q", data[4:12])
    if length != len(data):
        raise ValueError(f"{what}: length {length} in its header, "
                         f"{len(data)} read")
    (crc,) = struct.unpack("<I", data[-4:])
    if crc != crc32c(data[:-4]):
        raise ValueError(f"{what}: CRC32C mismatch")
    head = _Bytes(data[12:-4], what)
    version, method = head.varint(), head.varint()
    if version != 0:
        raise ValueError(f"{what}: format version {version}, not 0")
    body = head.data[head.pos:]
    if method == 1:
        body = zstd.decompress(body, max_body)
    elif method != 0:
        raise ValueError(f"{what}: compression method {method}")
    return _Bytes(body, what)


def _wrap(body: bytes, magic: int) -> bytes:
    """A manifest or node around ``body``, uncompressed (method 0)."""
    head = _varint(0) + _varint(0)
    n = 4 + 8 + len(head) + len(body) + 4
    data = struct.pack(">I", magic) + struct.pack("<Q", n) + head + body
    return data + struct.pack("<I", crc32c(data))


def _read_files(r: _Bytes, transitive: str) -> list[tuple[str, str]]:
    """A data file table -> [(base path, relative path)], the base paths
    under ``transitive`` (the base path of the file the node came from)."""
    n = r.varint()
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix, base_len = r.varints(n), r.varints(n)
    out, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"{r.what}: data file prefix")
        path = prev[:prefix[i]] + r.take(suffix[i])
        if base_len[i] > len(path):
            raise ValueError(f"{r.what}: data file base path")
        out.append((transitive + path[:base_len[i]].decode(),
                    path[base_len[i]:].decode()))
        prev = path
    return out


def _write_files(paths: list[str]) -> bytes:
    """A data file table of ``paths`` (sorted, base paths empty)."""
    enc = [p.encode() for p in paths]
    prefix = [len(os.path.commonprefix([a, b])) for a, b in zip(enc, enc[1:])]
    suffix = [e[n:] for e, n in zip(enc, [0] + prefix)]
    return (_varint(len(enc)) + _varints(prefix)
            + _varints(len(s) for s in suffix) + _varints(0 for _ in enc)
            + b"".join(suffix))


def _read_keys(r: _Bytes, n: int, interior: bool):
    """The key columns of ``n`` entries -> (keys, subtree common prefix
    lengths or None)."""
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    common = r.varints(n) if interior else None
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"{r.what}: key prefix")
        prev = prev[:prefix[i]] + r.take(suffix[i])
        keys.append(prev)
    return keys, common


class OcdbtReader:
    """The key-value store of an OCDBT directory (its top-level manifest's
    latest version), read from disk with numpy and the port's zstd."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        path = os.path.join(self.directory, "manifest.ocdbt")
        with open(path, "rb") as f:
            r = _unwrap(f.read(), MANIFEST_MAGIC, path, 1 << 30)
        r.take(16)                                         # uuid
        if r.varint() != 0:
            raise ValueError(f"{path}: only single-file manifests are read")
        self.max_inline_value_bytes = r.varint()
        self.max_decoded_node_bytes = r.varint()
        r.byte()                                           # arity log2
        if r.varint() == 1:
            r.take(4)                                      # zstd level
        files = _read_files(r, "")
        n = r.varint()
        gen = r.varints(n)
        height = [r.byte() for _ in range(n)]
        cols = [r.varints(n) for _ in range(6)]  # file, offset, length, keys,
        r.take(8 * n)                            # tree, indirect; times
        # version tree nodes (older versions) follow; the latest is inline
        self._files: dict[str, int] = {}
        self.root = None
        if n:
            i = int(np.argmax(gen))
            file, offset, length = cols[0][i], cols[1][i], cols[2][i]
            if offset != _NO_ROOT:
                self.root = (self._file(files, file, path), offset, length,
                             height[i])

    def _file(self, files, i, what) -> tuple[str, str]:
        if i >= len(files):
            raise ValueError(f"{what}: data file {i} of {len(files)}")
        return files[i]

    def _read(self, file: tuple[str, str], offset: int, length: int) -> bytes:
        path = os.path.join(self.directory, file[0] + file[1])
        with open(path, "rb") as f:
            data = os.pread(f.fileno(), length, offset)
        if len(data) != length:
            raise ValueError(f"{path}: {length} bytes at {offset} asked, "
                             f"{len(data)} there")
        return data

    def _node(self, ref, height: int, prefix: bytes, out: dict) -> None:
        file, offset, length = ref
        what = f"{file[0]}{file[1]}@{offset}"
        r = _unwrap(self._read(file, offset, length), NODE_MAGIC, what,
                    self.max_decoded_node_bytes)
        if r.byte() != height:
            raise ValueError(f"{what}: height differs from its reference")
        files = _read_files(r, file[0])
        n = r.varint()
        keys, common = _read_keys(r, n, height > 0)
        if height > 0:
            cols = [r.varints(n) for _ in range(6)]
            r.done()
            children = [(self._file(files, cols[0][i], what), cols[1][i],
                         cols[2][i]) for i in range(n)]
            for key, c, child in zip(keys, common, children):
                self._node(child, height - 1, prefix + key[:c], out)
            return
        lengths = r.varints(n)
        kinds = r.varints(n)
        if any(k > 1 for k in kinds):
            raise ValueError(f"{what}: value kind {max(kinds)}")
        indirect = [i for i in range(n) if kinds[i] == 1]
        files_of = r.varints(len(indirect))
        offsets = r.varints(len(indirect))
        refs = dict(zip(indirect, zip(files_of, offsets)))
        for i, key in enumerate(keys):
            if i in refs:
                f, o = refs[i]
                out[prefix + key] = (self._file(files, f, what), o, lengths[i])
            else:
                out[prefix + key] = r.take(lengths[i])
        r.done()

    def refs(self) -> dict[bytes, object]:
        """Every key -> its inline value (bytes) or (file, offset, length)."""
        out: dict[bytes, object] = {}
        if self.root is not None:
            file, offset, length, height = self.root
            self._node((file, offset, length), height, b"", out)
        return out

    def value(self, ref) -> bytes:
        return ref if isinstance(ref, bytes) else self._read(*ref)

    def items(self) -> dict[bytes, bytes]:
        """Every key and its value."""
        return {k: self.value(v) for k, v in self.refs().items()}


# ------------------------------------------------------------------ zarr v2
def _zarr_dtype(name: str) -> np.dtype:
    if name not in _DTYPES:
        raise ValueError(f"zarr dtype {name!r} is not read")
    return np.dtype("<u2" if name == "bfloat16" else name)


def _fill_value(fill, name: str):
    """A .zarray fill value as a value of the stored dtype (bf16: its
    bits); null reads as 0, and "NaN" / "Infinity" as floats."""
    if fill is None:
        return 0
    if isinstance(fill, str):
        fill = float(fill)
    if name == "bfloat16":
        return torch.tensor(fill, dtype=torch.bfloat16).view(torch.int16) \
            .item() & 0xFFFF
    return fill


def _read_zarr(kv: OcdbtReader, refs: dict, path: str):
    meta = json.loads(kv.value(refs[f"{path}/.zarray".encode()]))
    if meta.get("zarr_format") != 2 or meta.get("filters"):
        raise ValueError(f"{path}: zarr v2 without filters is read")
    dtype = _zarr_dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    order = meta.get("order", "C")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{path}: compressor {comp.get('id')!r}")
    sep = meta.get("dimension_separator", ".")
    out = np.full(shape, _fill_value(meta.get("fill_value"), meta["dtype"]),
                  dtype)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    chunk_bytes = int(np.prod(chunks)) * dtype.itemsize
    for idx in np.ndindex(*grid):
        key = sep.join(map(str, idx)) if idx else "0"
        ref = refs.get(f"{path}/{key}".encode())
        if ref is None:
            continue                                   # the fill value
        data = kv.value(ref)
        if comp is not None:
            buf = np.empty(chunk_bytes, np.uint8)
            n = zstd.decompress_into(data, buf)
            data = buf[:n]
        else:
            data = np.frombuffer(data, np.uint8)
        if data.size != chunk_bytes:
            raise ValueError(f"{path}/{key}: {data.size} bytes, a chunk "
                             f"holds {chunk_bytes}")
        block = data.view(dtype).reshape(chunks, order=order)
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(out).view(torch.bfloat16)
    return out


def read_orbax(directory: str) -> dict:
    """The leaves of an Orbax ``StandardCheckpointer`` directory as a flat
    ``{"a/b/c": array}``: numpy arrays, and ``torch.bfloat16`` tensors for
    bf16 leaves (numpy has no bf16); a leaf Orbax stored as None (an
    empty optimizer state) is left out. Only Orbax's default layout (OCDBT
    over zarr v2) is read."""
    directory = os.path.abspath(directory)
    with open(os.path.join(directory, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt") or meta.get("use_zarr3"):
        raise ValueError(f"{directory}: only Orbax's default layout (OCDBT "
                         "over zarr v2) is read")
    kv = OcdbtReader(directory)
    refs = kv.refs()
    out = {}
    for leaf in meta["tree_metadata"].values():
        if leaf["value_metadata"].get("skip_deserialize"):
            continue                      # a None leaf: nothing is stored
        keys = [str(k["key"]) for k in leaf["key_metadata"]]
        out["/".join(keys)] = _read_zarr(kv, refs, ".".join(keys))
    return out


# ------------------------------------------------------------------ writer
def _zarray(a: np.ndarray, name: str) -> bytes:
    shape = list(a.shape)
    return json.dumps({
        "chunks": shape,
        "compressor": {"id": "zstd", "level": 1},
        "dimension_separator": ".", "dtype": name, "fill_value": None,
        "filters": None, "order": "C", "shape": shape, "zarr_format": 2},
        separators=(",", ":")).encode()


def _as_leaf(value) -> tuple[np.ndarray, str]:
    """A leaf as (C-ordered little-endian array, zarr dtype name)."""
    if torch.is_tensor(value):
        t = value.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("<u2"), "bfloat16"
        value = t.numpy()
    a = np.asarray(value)
    name = a.dtype.newbyteorder("<").str if a.dtype.itemsize > 1 \
        else a.dtype.str
    if name not in _DTYPES:
        raise ValueError(f"dtype {a.dtype} is not written")
    return a.astype(name, order="C", copy=False), name     # keeps 0-d


def write_orbax(directory: str, flat_tree: dict) -> None:
    """Write ``flat_tree`` (``{"a/b/c": array or tensor}``, keys split on
    "/" into dict keys) as an Orbax ``StandardCheckpointer`` directory:
    ``_METADATA``, ``_CHECKPOINT_METADATA``, ``manifest.ocdbt`` and one data
    file under ``d/``. ``directory`` must not exist yet."""
    t0 = time.time_ns()
    os.makedirs(os.path.join(directory, "d"))
    values: dict[bytes, bytes] = {}
    tree_meta = {}
    for path, value in flat_tree.items():
        keys = path.split("/")
        a, name = _as_leaf(value)
        if a.size == 0:
            raise ValueError(f"{path}: Orbax saves no array of zero size")
        base = ".".join(keys)
        values[f"{base}/.zarray".encode()] = _zarray(a, name)
        chunk = "0" if a.ndim == 0 else ".".join("0" * a.ndim)
        values[f"{base}/{chunk}".encode()] = zstd.compress_raw(a.data)
        tree_meta[str(tuple(keys))] = {
            "key_metadata": [{"key": k, "key_type": 2} for k in keys],
            "value_metadata": {"value_type": "np.ndarray",
                               "skip_deserialize": False}}

    # the data file: the values too large to inline, then the root leaf
    data_name = f"d/{uuid.uuid4().hex}"
    keys = sorted(values)
    blobs, kinds, offsets, inline = [], [], [], []
    pos = 0
    for k in keys:
        v = values[k]
        if len(v) > ORBAX_CONFIG["max_inline_value_bytes"]:
            kinds.append(1)
            offsets.append(pos)
            blobs.append(v)
            pos += len(v)
        else:
            kinds.append(0)
            inline.append(v)
    prefix = [len(os.path.commonprefix([a, b])) for a, b in zip(keys,
                                                                keys[1:])]
    n_indirect = len(offsets)
    node = _wrap(
        bytes([0]) + (_write_files([data_name]) if n_indirect
                      else _varint(0))
        + _varint(len(keys)) + _varints(prefix)
        + _varints(len(k) - n for k, n in zip(keys, [0] + prefix))
        + b"".join(k[n:] for k, n in zip(keys, [0] + prefix))
        + _varints(len(values[k]) for k in keys) + _varints(kinds)
        + _varints(0 for _ in offsets) + _varints(offsets)
        + b"".join(inline), NODE_MAGIC)
    with open(os.path.join(directory, data_name), "wb") as f:
        for b in blobs:
            f.write(b)
        f.write(node)

    manifest = _wrap(
        uuid.uuid4().bytes + _varint(0)
        + _varint(ORBAX_CONFIG["max_inline_value_bytes"])
        + _varint(ORBAX_CONFIG["max_decoded_node_bytes"])
        + bytes([ORBAX_CONFIG["version_tree_arity_log2"]])
        + _varint(1) + struct.pack("<i", 0)               # zstd, level 0
        + _write_files([data_name])
        + _varint(1) + _varint(1) + bytes([0])            # generation 1, leaf
        + _varint(0) + _varint(pos) + _varint(len(node))  # file, offset, len
        + _varint(len(keys)) + _varint(len(node)) + _varint(pos)
        + struct.pack("<Q", time.time_ns())
        + _varint(0), MANIFEST_MAGIC)                     # no version nodes
    with open(os.path.join(directory, "manifest.ocdbt"), "wb") as f:
        f.write(manifest)
    with open(os.path.join(directory, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": tree_meta, "use_ocdbt": True,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, f)
    with open(os.path.join(directory, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": "orbax.checkpoint._src.handlers."
                   "standard_checkpoint_handler.StandardCheckpointHandler",
                   "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": t0,
                   "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)
