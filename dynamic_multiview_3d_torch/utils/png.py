"""A PNG reader and writer from the standard library (zlib + struct) and
numpy.

They stand in for the JAX package's ``imageio.imread`` / ``imwrite``, so
the CLIs and the data sources work where neither ``imageio`` nor PIL is
installed. ``encode_png`` writes 8-bit gray, RGB or RGBA, one unfiltered
scanline after another; ``read_png`` decodes non-interlaced 8-bit gray, RGB
and RGBA with any of the five scanline filters (``imageio`` and PIL choose
a filter per row, so Sub, Avg and Paeth all occur) and raises, naming the
format, on anything else.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels, for the 8-bit formats read and written here
_CHANNELS = {0: 1, 2: 3, 6: 4}
_COLOR_TYPE = {c: t for t, c in _CHANNELS.items()}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """The PNG file of a uint8 image [H, W] (gray) or [H, W, C] with C = 1
    (gray), 3 (RGB) or 4 (RGBA)."""
    image = np.asarray(image)
    if image.ndim == 2:
        image = image[..., None]
    if image.dtype != np.uint8 or image.ndim != 3 \
            or image.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"encode_png takes uint8 [H, W] or [H, W, 1|3|4], "
                         f"got {image.dtype} {image.shape}")
    h, w, c = image.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),      # filter: none
                           image.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> None:
    """Write a uint8 [H, W, 3] image to ``path``."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"write_png takes uint8 [H, W, 3], got "
                         f"{image.dtype} {image.shape}")
    with open(path, "wb") as f:
        f.write(encode_png(image))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of ``raw`` [h, 1 + stride] -> [h, stride]."""
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(raw[y, 0]), raw[y, 1:]
        if kind == 0:                                       # None
            row = line.copy()
        elif kind == 1:                                     # Sub
            # recon[x] = line[x] + recon[x - bpp]: per channel a running
            # sum, mod 256 in uint8
            row = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(stride)
        elif kind == 2:                                     # Up
            row = line + prior
        elif kind in (3, 4):                                # Avg, Paeth
            cur, up = line.tolist(), prior.tolist()
            for x in range(stride):
                left = cur[x - bpp] if x >= bpp else 0
                if kind == 3:
                    pred = (left + up[x]) >> 1
                else:
                    pred = _paeth(left, up[x],
                                  up[x - bpp] if x >= bpp else 0)
                cur[x] = (cur[x] + pred) & 0xFF
            row = np.array(cur, np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = row
        prior = row
    return out


def read_png(source) -> np.ndarray:
    """Decode a PNG (a path, or the file's bytes) -> uint8 [H, W] for gray,
    [H, W, 3] for RGB, [H, W, 4] for RGBA, as ``imageio.imread`` returns
    them."""
    if isinstance(source, (bytes, bytearray, memoryview)):
        data = bytes(source)
    else:
        with open(source, "rb") as f:
            data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"truncated PNG chunk {tag!r}")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(
            f"unsupported PNG format: bit depth {depth}, colour type "
            f"{color}, interlace {interlace} (read_png takes non-interlaced "
            "8-bit gray, RGB or RGBA)")
    c = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * c):
        raise ValueError(f"PNG image data holds {raw.size} bytes, not "
                         f"{h * (1 + w * c)}")
    pixels = _unfilter(raw.reshape(h, 1 + w * c), h, w * c, c)
    return pixels.reshape(h, w) if c == 1 else pixels.reshape(h, w, c)
