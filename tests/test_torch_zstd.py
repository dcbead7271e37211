"""The port's zstd decoder (csrc/zstd_decode.cpp via utils/zstd.py) against
the ``zstandard`` package, and its raw-block writer.

- Every frame ``zstandard`` writes at levels -5, 1, 3 and 19 decodes to
  the same bytes: zeros (RLE blocks), random bytes (raw blocks), float32
  normals (Huffman literals in 4 streams, treeless literals), repetitive
  text (FSE sequences and repeat offsets), bytes below 16 (Huffman weights
  given directly), slices of an early block joined by one byte (RLE
  literals), with and without the content size and the content checksum,
  streamed frames that carry no content size, concatenated and skippable
  frames, and a hypothesis sweep of mixed inputs. The decoder's path
  counters show that these frames take every path it has.
- A truncated frame, or one with a byte changed, raises ``ValueError`` (a
  change the frame cannot detect may decode, but only to the right bytes
  when the frame has a checksum); so do an output larger than the given
  capacity and a frame that names a dictionary.
- ``compress_raw`` frames (raw blocks of at most 128 KiB) decode with
  ``zstandard`` and with the port.
"""

import io
import struct

import numpy as np
import pytest
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamic_multiview_3d_torch.utils import cxx, zstd

LEVELS = (-5, 1, 3, 19)


def _data(kind: str, n: int = 300_000, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    if kind == "zeros":
        return bytes(n)
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == "f32":
        return rng.standard_normal(n // 4).astype(np.float32).tobytes()
    if kind == "text":
        words = [b"view", b"pose", b"flow", b"depth", b"frame", b"source",
                 b"target", b"kernel", b"\n", b" ", b", "]
        picks = rng.integers(0, len(words), n // 4)
        return b"".join(words[i] for i in picks)[:n]
    if kind == "nibbles":    # few low symbols: Huffman weights given directly
        return rng.integers(0, 16, n, dtype=np.uint8).tobytes()
    if kind == "spliced":    # slices of an early block joined by one byte:
        head = _data("random", 150_000, seed)   # later blocks' literals are
        parts, total = [head], len(head)        # all that byte (RLE)
        while total < n:
            a = int(rng.integers(0, len(head) - 400))
            parts += [b"x", head[a:a + int(rng.integers(40, 400))]]
            total += len(parts[-1]) + 1
        return b"".join(parts)[:n]
    if kind == "mixed":      # runs, text and noise in one input
        return b"".join([bytes(5000), _data("text", 40_000, seed),
                         _data("random", 3000, seed), b"ab" * 9000,
                         _data("f32", 60_000, seed)])
    raise ValueError(kind)


KINDS = ("zeros", "random", "f32", "text", "nibbles", "spliced", "mixed")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("level", LEVELS)
def test_matches_zstandard(level, kind):
    data = _data(kind)
    for checksum, size in ((False, True), (True, False), (True, True)):
        frame = zstandard.ZstdCompressor(
            level=level, write_checksum=checksum,
            write_content_size=size).compress(data)
        assert zstd.decompress(frame, len(data)) == data, (checksum, size)


@pytest.mark.parametrize("level", LEVELS)
def test_streamed_frames_without_content_size(level):
    data = _data("mixed", seed=level + 10)
    buf = io.BytesIO()
    with zstandard.ZstdCompressor(level=level, write_checksum=True) \
            .stream_writer(buf, closefd=False) as w:
        for i in range(0, len(data), 7777):         # many flushes: many
            w.write(data[i:i + 7777])                # blocks, repeat modes
            w.flush(zstandard.FLUSH_BLOCK)
    frame = buf.getvalue()
    assert frame[4] >> 6 == 0                       # no content size
    assert zstd.decompress(frame, len(data)) == data


def test_concatenated_and_skippable_frames():
    a, b = _data("text", 50_000), _data("f32", 80_000, seed=3)
    skip = struct.pack("<II", 0x184D2A53, 5) + b"hello"
    frames = (zstandard.ZstdCompressor(level=3).compress(a) + skip
              + zstandard.ZstdCompressor(level=19).compress(b) + skip)
    assert zstd.decompress(frames, len(a) + len(b)) == a + b


def test_small_and_empty_inputs():
    for data in (b"", b"x", b"ab" * 3, bytes(range(256))):
        for level in LEVELS:
            frame = zstandard.ZstdCompressor(level=level).compress(data)
            assert zstd.decompress(frame, max(len(data), 1)) == data


@settings(max_examples=60, deadline=None)
@given(parts=st.lists(st.tuples(st.sampled_from(["zeros", "random", "text",
                                                 "f32"]),
                                st.integers(0, 30_000),
                                st.integers(0, 1000)),
                      min_size=1, max_size=5),
       level=st.sampled_from(LEVELS), checksum=st.booleans())
def test_hypothesis_inputs(parts, level, checksum):
    data = b"".join(_data(k, n, s) for k, n, s in parts)
    frame = zstandard.ZstdCompressor(level=level,
                                     write_checksum=checksum).compress(data)
    assert zstd.decompress(frame, len(data) + 1) == data


def test_truncated_frames_raise():
    data = _data("mixed", seed=4)
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True) \
        .compress(data)
    cuts = sorted(set(range(0, 64)) | set(range(0, len(frame), 97))
                  | set(range(len(frame) - 64, len(frame))))
    for n in cuts:
        with pytest.raises(ValueError):
            zstd.decompress(frame[:n], len(data))


@pytest.mark.parametrize("kind", ["text", "f32", "mixed"])
def test_corrupt_frames_raise_or_decode_right(kind):
    """Every byte of a checksummed frame changed in turn (some of them):
    the decoder raises ValueError or returns the original bytes (a header
    change such as a larger window is harmless); it never crashes."""
    data = _data(kind, 60_000, seed=5)
    frame = bytearray(zstandard.ZstdCompressor(level=3, write_checksum=True)
                      .compress(data))
    rng = np.random.default_rng(6)
    raised = 0
    for pos in sorted(set(range(12)) | set(rng.integers(0, len(frame), 300))):
        bad = bytearray(frame)
        bad[pos] ^= int(rng.integers(1, 256))
        try:
            out = zstd.decompress(bytes(bad), 2 * len(data))
        except ValueError:
            raised += 1
            continue
        assert out == data, pos
    assert raised > 250


def test_capacity_and_dictionary_raise():
    data = _data("text", 10_000)
    frame = zstandard.ZstdCompressor(level=1).compress(data)
    assert zstd.decompress(frame, len(data)) == data
    with pytest.raises(ValueError, match="capacity"):
        zstd.decompress(frame, len(data) - 1)
    unsized = zstandard.ZstdCompressor(level=1, write_content_size=False) \
        .compress(data)
    with pytest.raises(ValueError, match="capacity"):
        zstd.decompress(unsized, len(data) - 1)
    # the same frame naming dictionary 7 (Dictionary_ID_flag 1, one byte
    # after the header descriptor of a single-segment frame)
    single = zstandard.ZstdCompressor(level=1).compress(b"abc" * 10)
    assert single[4] & 0x20
    named = single[:4] + bytes([single[4] | 1, 7]) + single[5:]
    with pytest.raises(ValueError, match="dictionary"):
        zstd.decompress(named, 100)
    with pytest.raises(ValueError, match="magic"):
        zstd.decompress(b"not a frame", 100)


@pytest.mark.parametrize("n", [0, 1, 131072, 131073, 400_000])
def test_raw_frames_decode_everywhere(n):
    data = _data("random", n, seed=7)
    frame = zstd.compress_raw(data)
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert zstd.decompress(frame, n) == data
    assert len(frame) == len(data) + 9 + 3 * max(1, -(-n // 131072))
    assert zstandard.get_frame_parameters(frame).content_size == n


def test_the_corpus_reaches_every_path():
    """The frames of these tests take every path the decoder has: each
    block, literals and sequence mode, both Huffman weight forms, 1 and 4
    streams, repeat offsets with and without the literal-length-0 rule."""
    zstd.path_counts(reset=True)
    for level in LEVELS:
        for kind in KINDS:
            data = _data(kind, 400_000, seed=level + 20)
            zstd.decompress(zstandard.ZstdCompressor(
                level=level, write_checksum=True).compress(data), len(data))
        test_streamed_frames_without_content_size(level)
    test_concatenated_and_skippable_frames()
    test_small_and_empty_inputs()
    counts = zstd.path_counts()
    assert not [p for p, n in counts.items() if n == 0], counts


def test_xxh64_is_the_frame_checksum():
    data = _data("text", 5000)
    frame = zstandard.ZstdCompressor(level=1, write_checksum=True) \
        .compress(data)
    assert struct.unpack("<I", frame[-4:])[0] == zstd.xxh64(data) & 0xFFFFFFFF
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999          # the XXH64 vector


def test_build_is_cached_and_a_failed_build_raises(tmp_path, monkeypatch):
    zstd.build()
    assert zstd.build() == ("", 0.0)
    bad = tmp_path / "zstd_decode.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(zstd, "SOURCE", bad)
    monkeypatch.setattr(cxx, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="zstd decoder build failed"):
        zstd.build()
