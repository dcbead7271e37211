"""TensorFlow checkpoints (the tensor bundle that ``tf.train.Saver`` and
``tf.train.Checkpoint`` write) with numpy alone: the reader behind the
port's ``import_tf1_checkpoint`` (``train/checkpoint.py``).

A checkpoint ``prefix`` is two kinds of file:

- ``prefix.index``: a LevelDB-style table (TensorFlow's
  ``core/lib/io/table``). A 48-byte footer holds the block handles (two
  varints each: offset, size) of the metaindex and index blocks, zero
  padding and the magic ``0xdb4775248b80fb57``. A block is a run of
  entries (shared key prefix length, unshared length, value length, the
  unshared key bytes, the value), then its restart offsets (u32 each) and
  their count; after each block, a 5-byte trailer: the compression type
  and the masked CRC32C of the block and that byte. The index block maps
  the last key of each data block to that block's handle.
- ``prefix.data-<i>-of-<n>``: the tensors' bytes, little-endian.

The table's key "" holds a ``BundleHeaderProto`` (num_shards, endianness,
version); every other key is a tensor name mapped to its
``BundleEntryProto`` (dtype, shape, shard_id, offset, size, masked crc32c,
slices). The protobuf fields and the masked CRC32C of the index blocks
use ``data/tfrecords.py``'s codec; a tensor's checksum is computed by
``csrc/crc32c.cpp`` (built with g++ at first use, ``utils/cxx.py``).

What is not guessed but refused with ``ValueError``: a compressed block,
a big-endian bundle, a sliced (partitioned) variable, a dtype other than
float32, float64, int32, int64, bfloat16 and float16, and any checksum
that does not match.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading

import numpy as np
import torch

from dynamic_multiview_3d_torch.data.tfrecords import (_fields,
                                                       _read_varint, crc32c)
from dynamic_multiview_3d_torch.utils import cxx

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_BYTES = 48
# TensorFlow's DataType enum -> numpy dtype (bfloat16: its bits as <u2)
DTYPES = {1: "<f4", 2: "<f8", 3: "<i4", 9: "<i8", 14: "bfloat16",
          19: "<f2"}
SOURCE = cxx.CSRC / "crc32c.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def build() -> tuple[str, float]:
    """Compile the CRC32C library unless it is cached. -> (the compiler's
    output, seconds; "" and 0.0 when the cached library was kept)."""
    return cxx.build(SOURCE, cxx.BUILD_DIR, "crc32c", CXX_FLAGS, "crc32c")


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(cxx.library_path(
                SOURCE, cxx.BUILD_DIR, "crc32c", CXX_FLAGS)))
            lib.dmv3d_crc32c.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
            lib.dmv3d_crc32c.restype = ctypes.c_uint32
            _lib = lib
        return _lib


def fast_crc32c(data) -> int:
    """The CRC32C of ``data`` (bytes or a contiguous array), in C++."""
    buf = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) \
        else data.reshape(-1).view(np.uint8)
    return _load().dmv3d_crc32c(buf.ctypes.data, buf.size)


def _mask(crc: int) -> int:
    """LevelDB's and TensorFlow's masked CRC32C."""
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------------ table
def _handle(data: bytes, pos: int) -> tuple[int, int, int]:
    offset, pos = _read_varint(data, pos)
    size, pos = _read_varint(data, pos)
    return offset, size, pos


def _block(data: bytes, offset: int, size: int, what: str) -> bytes:
    """A block's contents, its trailer checked."""
    if offset + size + 5 > len(data):
        raise ValueError(f"{what}: block at {offset} runs past the file")
    block = data[offset:offset + size]
    kind = data[offset + size]
    if kind != 0:
        raise ValueError(f"{what}: the block at {offset} is compressed "
                         f"(type {kind}); only uncompressed tables are read")
    (crc,) = struct.unpack("<I", data[offset + size + 1:offset + size + 5])
    if crc != _mask(crc32c(data[offset:offset + size + 1])):
        raise ValueError(f"{what}: CRC32C mismatch in the block at {offset}")
    return block


def _entries(block: bytes, what: str) -> list[tuple[bytes, bytes]]:
    """A block's (key, value) entries, in order."""
    if len(block) < 4:
        raise ValueError(f"{what}: block of {len(block)} bytes")
    (n_restarts,) = struct.unpack("<I", block[-4:])
    end = len(block) - 4 - 4 * n_restarts
    if end < 0:
        raise ValueError(f"{what}: {n_restarts} restarts in a block of "
                         f"{len(block)} bytes")
    out, key, pos = [], b"", 0
    while pos < end:
        shared, pos = _read_varint(block, pos)
        unshared, pos = _read_varint(block, pos)
        size, pos = _read_varint(block, pos)
        if shared > len(key) or pos + unshared + size > end:
            raise ValueError(f"{what}: corrupt block entry")
        key = key[:shared] + block[pos:pos + unshared]
        pos += unshared
        out.append((key, block[pos:pos + size]))
        pos += size
    return out


def _read_table(path: str) -> dict[bytes, bytes]:
    """Every key and value of a table file."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < FOOTER_BYTES:
        raise ValueError(f"{path}: {len(data)} bytes, not a table")
    footer = data[-FOOTER_BYTES:]
    (magic,) = struct.unpack("<Q", footer[-8:])
    if magic != TABLE_MAGIC:
        raise ValueError(f"{path}: not a table (magic {magic:#x})")
    _, _, pos = _handle(footer, 0)                        # metaindex
    offset, size, _ = _handle(footer, pos)
    out = {}
    for _, value in _entries(_block(data, offset, size, path), path):
        b_offset, b_size, _ = _handle(value, 0)
        out.update(_entries(_block(data, b_offset, b_size, path), path))
    return out


# ---------------------------------------------------------------- protos
def _int64(value: int) -> int:
    return value - (1 << 64) if value >= 1 << 63 else value


def _header(value: bytes, what: str) -> int:
    """A BundleHeaderProto -> num_shards; refuses a big-endian bundle."""
    shards, endian = 1, 0
    for number, _, v in _fields(value):
        if number == 1:
            shards = v
        elif number == 2:
            endian = v
    if endian != 0:
        raise ValueError(f"{what}: a big-endian bundle is not read")
    return shards


def _shape(value: bytes) -> tuple[int, ...]:
    dims = []
    for number, _, v in _fields(value):
        if number == 2:
            size = 0
            for n, _, d in _fields(v):
                if n == 1:
                    size = _int64(d)
            dims.append(size)
        elif number == 3 and v:
            raise ValueError("a tensor of unknown rank")
    return tuple(dims)


def _entry(value: bytes) -> dict:
    """A BundleEntryProto as a dict."""
    e = {"dtype": 0, "shape": (), "shard_id": 0, "offset": 0, "size": 0,
         "crc32c": 0, "slices": 0}
    for number, _, v in _fields(value):
        if number == 1:
            e["dtype"] = v
        elif number == 2:
            e["shape"] = _shape(v)
        elif number == 3:
            e["shard_id"] = v
        elif number == 4:
            e["offset"] = _int64(v)
        elif number == 5:
            e["size"] = _int64(v)
        elif number == 6:
            (e["crc32c"],) = struct.unpack("<I", v)
        elif number == 7:
            e["slices"] += 1
    return e


class BundleReader:
    """The tensors of a TensorFlow checkpoint ``prefix`` (V2 bundle)."""

    def __init__(self, prefix: str):
        self.prefix = os.fspath(prefix)
        index = f"{self.prefix}.index"
        if not os.path.exists(index):
            raise FileNotFoundError(f"{index}: no TensorFlow checkpoint at "
                                    f"prefix {self.prefix}")
        table = _read_table(index)
        if b"" not in table:
            raise ValueError(f"{index}: no bundle header")
        self.num_shards = _header(table.pop(b""), index)
        # a partitioned variable's slices sit under binary keys (TF's
        # OrderedCode, first byte 0) beside its own entry, which lists them
        self.entries = {k.decode(): _entry(v) for k, v in table.items()
                        if not k.startswith(b"\x00")}

    def names(self) -> list[str]:
        return sorted(self.entries)

    def tensor(self, name: str):
        """The tensor ``name``: a numpy array, or a ``torch.bfloat16``
        tensor for bfloat16 (numpy has no bf16). Raises ``KeyError`` for
        a name the bundle lacks."""
        if name not in self.entries:
            raise KeyError(f"{name!r} is not in the checkpoint "
                           f"{self.prefix}")
        e = self.entries[name]
        what = f"{self.prefix}: {name}"
        if e["slices"]:
            raise ValueError(f"{what} is sliced (a partitioned variable, "
                             f"{e['slices']} slices); sliced entries are "
                             "not read")
        if e["dtype"] not in DTYPES:
            raise ValueError(f"{what}: TensorFlow dtype {e['dtype']} is not "
                             f"read (only {sorted(DTYPES)})")
        if not 0 <= e["shard_id"] < self.num_shards:
            raise ValueError(f"{what}: shard {e['shard_id']} of "
                             f"{self.num_shards}")
        name_ = DTYPES[e["dtype"]]
        dtype = np.dtype("<u2" if name_ == "bfloat16" else name_)
        if e["size"] != int(np.prod(e["shape"])) * dtype.itemsize:
            raise ValueError(f"{what}: {e['size']} bytes for shape "
                             f"{e['shape']} of {name_}")
        path = (f"{self.prefix}.data-{e['shard_id']:05d}-of-"
                f"{self.num_shards:05d}")
        with open(path, "rb") as f:
            data = os.pread(f.fileno(), e["size"], e["offset"])
        if len(data) != e["size"]:
            raise ValueError(f"{what}: {e['size']} bytes at {e['offset']} "
                             f"of {path}, {len(data)} there")
        if e["crc32c"] != _mask(fast_crc32c(data)):
            raise ValueError(f"{what}: CRC32C mismatch in {path}")
        a = np.frombuffer(data, dtype).reshape(e["shape"]).copy()
        if name_ == "bfloat16":
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return a
