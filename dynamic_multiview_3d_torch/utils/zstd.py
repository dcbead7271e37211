"""Zstandard frames with numpy alone: ``decompress`` runs the hand-written
decoder of ``csrc/zstd_decode.cpp`` (RFC 8878, built with g++ at first use,
``utils/cxx.py``) and ``compress_raw`` writes frames of raw blocks.

The Orbax checkpoint format stores its zarr chunks and OCDBT nodes as zstd
frames; the machine with the GPU has no zstd module, hence a decoder of its
own. It takes every frame but those that name a dictionary (Orbax writes
none), verifies the content checksum when a frame has one, and raises
``ValueError`` on a truncated or corrupt frame, and on an output larger
than the capacity the caller gives. The writer needs no compressor: a frame
of raw blocks is valid zstd, at the size of its content.
"""

from __future__ import annotations

import ctypes
import struct
import threading

import numpy as np

from dynamic_multiview_3d_torch.utils import cxx

SOURCE = cxx.CSRC / "zstd_decode.cpp"
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-Wall")
MAGIC = 0xFD2FB528
MAX_BLOCK = 128 * 1024
# the decoder's path counters, in the order of csrc/zstd_decode.cpp's Path
PATHS = ("frame_single_segment", "frame_windowed", "frame_no_content_size",
         "frame_checksum", "frame_skippable", "block_raw", "block_rle",
         "block_compressed", "lit_raw", "lit_rle", "lit_compressed",
         "lit_treeless", "lit_1_stream", "lit_4_streams", "weights_fse",
         "weights_direct", "seq_none", "seq_predefined", "seq_rle", "seq_fse",
         "seq_repeat", "offset_repeat", "offset_repeat_ll0")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def build() -> tuple[str, float]:
    """Compile the decoder unless it is cached. -> (the compiler's output,
    seconds; "" and 0.0 when the cached library was kept)."""
    return cxx.build(SOURCE, cxx.BUILD_DIR, "zstd_decode", CXX_FLAGS,
                     "zstd decoder")


def load() -> ctypes.CDLL:
    """The loaded decoder, built if needed."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(cxx.library_path(
                SOURCE, cxx.BUILD_DIR, "zstd_decode", CXX_FLAGS)))
            lib.dmv3d_zstd_decompress.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p,
                ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64]
            lib.dmv3d_zstd_decompress.restype = ctypes.c_int64
            lib.dmv3d_xxh64.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
            lib.dmv3d_xxh64.restype = ctypes.c_uint64
            lib.dmv3d_zstd_path_counts.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            lib.dmv3d_zstd_path_counts.restype = ctypes.c_int
            _lib = lib
        return _lib


def decompress_into(data: bytes, out: np.ndarray) -> int:
    """Decode every frame of ``data`` into the uint8 buffer ``out``
    (C-contiguous, its size the capacity). -> the bytes written."""
    if out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError("decompress_into takes a C-contiguous uint8 buffer")
    err = ctypes.create_string_buffer(256)
    n = load().dmv3d_zstd_decompress(bytes(data), len(data), out.ctypes.data,
                                     out.size, err, len(err))
    if n < 0:
        raise ValueError(f"zstd: {err.value.decode()}")
    return n


def decompress(data: bytes, capacity: int) -> bytes:
    """The content of every frame of ``data``; raises ``ValueError`` when
    it is larger than ``capacity`` bytes. The capacity is reserved, not
    touched: pages beyond the content are never written."""
    out = np.empty(capacity, np.uint8)
    return out[:decompress_into(data, out)].tobytes()


def xxh64(data: bytes) -> int:
    """XXH64 with seed 0 (a zstd frame's checksum is its low 32 bits)."""
    return load().dmv3d_xxh64(bytes(data), len(data))


def path_counts(reset: bool = False) -> dict[str, int]:
    """How often the decoder took each path of the format (per frame, block
    or section) since the library loaded or was last reset."""
    out = np.zeros(len(PATHS), np.uint64)
    n = load().dmv3d_zstd_path_counts(out.ctypes.data, len(PATHS), int(reset))
    if n != len(PATHS):
        raise RuntimeError(f"the decoder counts {n} paths, PATHS names "
                           f"{len(PATHS)}")
    return dict(zip(PATHS, map(int, out)))


def compress_raw(data) -> bytes:
    """One zstd frame holding ``data`` (bytes-like) in raw blocks of at most
    128 KiB: single segment, the content size in 4 bytes, no checksum."""
    view = memoryview(data).cast("B")
    n = len(view)
    if n >= 1 << 32:
        raise ValueError("compress_raw writes frames under 4 GiB")
    parts = [struct.pack("<IBI", MAGIC, 0xA0, n)]   # FCS 4 bytes, 1 segment
    pos = 0
    while True:
        size = min(MAX_BLOCK, n - pos)
        last = pos + size == n
        parts.append((size << 3 | int(last)).to_bytes(3, "little"))
        parts.append(view[pos:pos + size])
        pos += size
        if last:
            return b"".join(parts)
