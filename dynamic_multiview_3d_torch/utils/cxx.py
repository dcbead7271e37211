"""Build a host library of ``csrc/`` with g++ at first use, for ctypes.

The library goes into ``_build/`` beside the package (listed in
``.gitignore``) under a file name that carries the hash of the source and
the flags, so an edited source rebuilds and an unchanged one loads the
cached file. Concurrent builds are safe: each compiles to a temporary
name and renames it into place. There is no fallback: a failed build
raises with the compiler's output.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"


def library_path(source: Path, build_dir: Path, stem: str,
                 flags: tuple) -> Path:
    digest = hashlib.sha256(Path(source).read_bytes() + b"\0"
                            + " ".join(flags).encode())
    return Path(build_dir) / f"lib{stem}_{digest.hexdigest()[:16]}.so"


def build(source: Path, build_dir: Path, stem: str, flags: tuple,
          what: str) -> tuple[str, float]:
    """Compile ``source`` unless it is cached. -> (the compiler's output,
    seconds; "" and 0.0 when the cached library was kept). ``what`` names
    the library in errors."""
    out = library_path(source, build_dir, stem, flags)
    if out.exists():
        return "", 0.0
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found on PATH: the {what} cannot be "
                           "built")
    Path(build_dir).mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([cxx, *flags, "-o", str(tmp), str(source)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{what} build failed (g++ exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return proc.stdout, time.perf_counter() - t0
