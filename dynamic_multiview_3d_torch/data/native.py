"""The host-side frame packer (port of data/native.py): ctypes binding to
``csrc/framepack.cpp``, a numpy version of each of its functions, and a
numpy bilinear resize of uint8 frames.

``resize_normalize_pack`` (uint8 frames -> resized, normalized float32
NHWC) and ``gather_pack`` (rows of a uint8 frame store -> normalized
float32) run the C++ library with ``native=True`` and their numpy versions
with ``native=False``; a data source passes ``data.use_native_packer``.
The library is compiled with g++ at first use into ``_build/`` beside the
package, under a file name that carries the hash of the source and the
flags (an edited source rebuilds). There is no silent fallback: a failed
build raises with the compiler's output.

``resize_u8`` reproduces OpenCV's ``cv2.resize(..., INTER_LINEAR)`` on
uint8 frames (11-bit fixed-point weights, half-pixel centres, edges
clamped) to within one level; the JAX package calls OpenCV for it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "framepack.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-fopenmp", "-shared", "-std=c++17", "-Wall")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + b"\0"
                            + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libframepack_{digest.hexdigest()[:16]}.so"


def build() -> tuple[str, float]:
    """Compile the library unless it is cached. -> (the compiler's output,
    seconds; "" and 0.0 when the cached library was kept)."""
    out = library_path()
    if out.exists():
        return "", 0.0
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native frame packer "
                           "cannot be built (set data.use_native_packer="
                           "false for the numpy packer)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native frame packer build failed (g++ exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)              # atomic: concurrent builders are safe
    return proc.stdout, time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The loaded library, built if needed."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(library_path()))
            u8p, f32p = (ctypes.POINTER(ctypes.c_uint8),
                         ctypes.POINTER(ctypes.c_float))
            lib.dmv3d_resize_normalize_pack.argtypes = [
                u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                f32p, ctypes.c_int, ctypes.c_int]
            lib.dmv3d_resize_normalize_pack.restype = None
            lib.dmv3d_gather_pack.argtypes = [
                u8p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                ctypes.c_int64, f32p]
            lib.dmv3d_gather_pack.restype = None
            lib.dmv3d_num_threads.argtypes = []
            lib.dmv3d_num_threads.restype = ctypes.c_int
            _lib = lib
        return _lib


_INV = np.float32(1.0) / np.float32(127.5)      # the C++ 1.0f / 127.5f


def _normalize(x: np.ndarray) -> np.ndarray:
    """uint8 or f32 values -> x * (1/127.5) - 1 in f32, as the C++ does."""
    return x.astype(np.float32) * _INV - np.float32(1.0)


def _as_u8(frames: np.ndarray, what: str) -> np.ndarray:
    frames = np.asarray(frames)
    if frames.dtype != np.uint8 or frames.ndim < 3:
        raise ValueError(f"{what} takes uint8 [..., H, W, C], got "
                         f"{frames.dtype} {frames.shape}")
    return frames


def resize_normalize_pack(frames_u8: np.ndarray, h_out: int, w_out: int,
                          native: bool = True) -> np.ndarray:
    """uint8 [..., H, W, C] -> float32 [..., h_out, w_out, C] in [-1, 1]:
    bilinear resize (half-pixel centres, edges clamped) and x / 127.5 - 1."""
    frames_u8 = _as_u8(frames_u8, "resize_normalize_pack")
    lead = frames_u8.shape[:-3]
    h_in, w_in, c = frames_u8.shape[-3:]
    flat = np.ascontiguousarray(frames_u8.reshape(-1, h_in, w_in, c))
    if not native:
        return resize_normalize_pack_plain(flat, h_out, w_out) \
            .reshape(*lead, h_out, w_out, c)
    out = np.empty((flat.shape[0], h_out, w_out, c), np.float32)
    load().dmv3d_resize_normalize_pack(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), flat.shape[0],
        h_in, w_in, c, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        h_out, w_out)
    return out.reshape(*lead, h_out, w_out, c)


def _source_taps(n_in: int, n_out: int):
    """The C++ packer's taps along one axis: first source index and the
    f32 weight of the second (0 where the axis is one pixel long)."""
    step = 1 if n_in >= 2 else 0
    scale = np.float32(n_in) / np.float32(n_out)
    f = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * scale \
        - np.float32(0.5)
    f = np.maximum(f, np.float32(0.0))
    i0 = np.minimum(f.astype(np.int64), n_in - 1 - step)
    w = (f - i0.astype(np.float32)) if step else np.zeros(n_out, np.float32)
    return i0, i0 + step, w.astype(np.float32)


def resize_normalize_pack_plain(flat: np.ndarray, h_out: int, w_out: int
                                ) -> np.ndarray:
    """The numpy version of ``dmv3d_resize_normalize_pack`` on uint8
    [N, H, W, C]: the same f32 operations in the same order."""
    _, h_in, w_in, _ = flat.shape
    if (h_in, w_in) == (h_out, w_out):
        return _normalize(flat)
    y0, y1, wy = _source_taps(h_in, h_out)
    x0, x1, wx = _source_taps(w_in, w_out)
    wx = wx[None, None, :, None]

    def row(rows):                   # [N, h_out, W_in, C] -> horizontal lerp
        p0 = rows[:, :, x0].astype(np.int32)
        p1 = rows[:, :, x1].astype(np.int32)
        return p0.astype(np.float32) + (p1 - p0).astype(np.float32) * wx

    top, bot = row(flat[:, y0]), row(flat[:, y1])
    return (top + (bot - top) * wy[None, :, None, None]) * _INV \
        - np.float32(1.0)


def gather_pack(store_u8: np.ndarray, indices, native: bool = True
                ) -> np.ndarray:
    """store [num, H, W, C] uint8 + indices [K] -> float32 [K, H, W, C] in
    [-1, 1]."""
    store_u8 = _as_u8(store_u8, "gather_pack")
    idx = np.ascontiguousarray(indices, np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= store_u8.shape[0]):
        raise IndexError(f"gather_pack: indices out of [0, "
                         f"{store_u8.shape[0]})")
    if not native:
        return _normalize(store_u8[idx])
    frame_shape = store_u8.shape[1:]
    store = np.ascontiguousarray(store_u8)
    out = np.empty((len(idx),) + frame_shape, np.float32)
    load().dmv3d_gather_pack(
        store.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(idx),
        int(np.prod(frame_shape)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


# OpenCV's INTER_RESIZE_COEF_BITS: bilinear weights in 11-bit fixed point
_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def _cv_taps(n_in: int, n_out: int):
    """OpenCV's INTER_LINEAR taps along one axis: source indices and the
    two fixed-point weights per output pixel."""
    scale = n_in / n_out
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = f - i0.astype(np.float32)
    clamp = (i0 < 0) | (i0 >= n_in - 1)
    f[clamp] = 0.0
    i0 = np.clip(i0, 0, n_in - 1)
    a0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE))
    a1 = np.rint(f * np.float32(_COEF_SCALE))
    return i0, np.minimum(i0 + 1, n_in - 1), a0.astype(np.int64), \
        a1.astype(np.int64)


def resize_u8(frames: np.ndarray, h_out: int, w_out: int) -> np.ndarray:
    """uint8 [..., H, W, C] -> uint8 [..., h_out, w_out, C]: bilinear, as
    ``cv2.resize(f, (w_out, h_out), interpolation=cv2.INTER_LINEAR)``
    computes it: bitwise where OpenCV takes its vector path (every
    downscale tried), within one level elsewhere (its scalar tail rounds
    once, at the end)."""
    frames = _as_u8(frames, "resize_u8")
    h_in, w_in = frames.shape[-3:-1]
    if (h_in, w_in) == (h_out, w_out):
        return frames
    y0, y1, b0, b1 = _cv_taps(h_in, h_out)
    x0, x1, a0, a1 = _cv_taps(w_in, w_out)
    src = frames.astype(np.int64)
    rows = (src[..., x0, :] * a0[:, None]
            + src[..., x1, :] * a1[:, None])           # [..., H, w_out, C]
    # the vertical pass as OpenCV's vector code rounds it: each row's
    # product by its 16-bit weight keeps the high half, then the sum is
    # rounded to 8 bits
    top = ((rows[..., y0, :, :] >> 4) * b0[:, None, None]) >> 16
    bot = ((rows[..., y1, :, :] >> 4) * b1[:, None, None]) >> 16
    return np.clip((top + bot + 2) >> 2, 0, 255).astype(np.uint8)
