"""Fuzz the port's zstd decoder (csrc/zstd_decode.cpp) under AddressSanitizer
and UndefinedBehaviorSanitizer: frames ``zstandard`` writes from the
corpus of tests/test_torch_zstd.py, each corrupted many times (1-3 bytes
replaced, some cut short), decoded with a random output capacity. Every
decode must return or raise ValueError; a sanitizer report ends the
process with a non-zero exit.

    python tests/_fuzz_torch_zstd_asan.py [--per-frame 150] [--seed 0]

Builds an instrumented copy of the decoder with g++ into a temporary
directory and runs itself again with the sanitizer runtimes preloaded
(ctypes loads the library into an uninstrumented interpreter). Prints
one JSON line: frames, corruptions, how many decoded and how many raised.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "dynamic_multiview_3d_torch", "csrc",
                      "zstd_decode.cpp")
FLAGS = ("-O1", "-g", "-fsanitize=address,undefined",
         "-fno-omit-frame-pointer", "-fPIC", "-shared", "-std=c++17")


def _runtime(name: str) -> str:
    return subprocess.run(["g++", f"-print-file-name={name}"], check=True,
                          capture_output=True, text=True).stdout.strip()


def fuzz(lib_path: str, per_frame: int, seed: int) -> dict:
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import zstandard
    from dynamic_multiview_3d_torch.utils import zstd
    from test_torch_zstd import KINDS, LEVELS, _data

    lib = ctypes.CDLL(lib_path)
    lib.dmv3d_zstd_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_uint64]
    lib.dmv3d_zstd_decompress.restype = ctypes.c_int64
    zstd._lib = lib                    # the instrumented decoder from here on
    rng = np.random.default_rng(seed)
    frames = decoded = raised = 0
    for level in LEVELS:
        for kind in KINDS:
            data = _data(kind, 60_000, seed=level + 10)
            for checksum in (False, True):
                frame = zstandard.ZstdCompressor(
                    level=level, write_checksum=checksum).compress(data)
                if zstd.decompress(frame, len(data)) != data:
                    raise AssertionError(f"{kind} level {level}: wrong bytes")
                frames += 1
                for _ in range(per_frame):
                    bad = bytearray(frame)
                    for _ in range(int(rng.integers(1, 4))):
                        bad[int(rng.integers(0, len(bad)))] = \
                            int(rng.integers(0, 256))
                    if rng.random() < 0.3:
                        bad = bad[:int(rng.integers(0, len(bad)))]
                    try:
                        zstd.decompress(bytes(bad),
                                        int(rng.integers(1, 2 * len(data))))
                        decoded += 1
                    except ValueError:
                        raised += 1
    return {"frames": frames, "corruptions": decoded + raised,
            "decoded": decoded, "raised_value_error": raised,
            "sanitizers": "address,undefined"}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--per-frame", type=int, default=150)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lib", help=argparse.SUPPRESS)   # set by the re-run
    args = p.parse_args()
    if args.lib:
        print(json.dumps(fuzz(args.lib, args.per_frame, args.seed)))
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        lib = os.path.join(tmp, "libzstd_decode_asan.so")
        subprocess.run(["g++", *FLAGS, "-o", lib, SOURCE], check=True)
        env = dict(os.environ,
                   LD_PRELOAD=f"{_runtime('libasan.so')}:"
                              f"{_runtime('libubsan.so')}",
                   ASAN_OPTIONS="detect_leaks=0",
                   UBSAN_OPTIONS="halt_on_error=1:print_stacktrace=1")
        return subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--lib", lib,
             "--per-frame", str(args.per_frame), "--seed", str(args.seed)],
            env=env).returncode


if __name__ == "__main__":
    sys.exit(main())
