"""Build, load and launch the port's CUDA kernels: nvcc -> shared library ->
ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point (no PyTorch headers,
so a build takes seconds); it may include headers of ``csrc/`` in the
``#include "x.cuh"`` form. It is compiled for Hopper (``sm_90a``) at first
use into ``_build/`` beside the package (listed in ``.gitignore``), under a
file name that carries the hash of the source, the headers it includes and
the flags — an edited source or header rebuilds, an unchanged one loads the
cached library. A source may also be built per instantiation: ``defines``
(``("NAME=value", ...)``, passed to nvcc as ``-D``) pick compile-time
constants such as the multi-source kernels' source count, and are hashed
with the rest, so each instantiation is its own cached library, built at
its first use. Pointers and the stream cross into C as ``ctypes.c_void_p``,
sizes and modes as ``ctypes.c_int``; each entry point returns
``cudaGetLastError()`` and ``launch`` raises if it is not 0.

Each forward kernel is the CUDA implementation of a registered operator
(``torch.library.custom_op`` in the ``dmv3d`` namespace, defined beside its
wrapper) whose CPU implementation is the kernel's plain version and whose
fake implementation gives the output shapes, so ``torch.export`` traces
through it and a program that calls it runs the same kernel. What reads a
tensor's memory (``ptr``, the 16-byte alignment tests ``staged`` and
``check_aligned``, the launch counters) runs only inside an operator's
implementation or a backward, never where a graph is traced; the layout
tests (``channels_last``, ``staged_layout``, ``check_inputs``) read strides
only. ``stage`` copies a frame into the staged layout through the
``dmv3d::stage`` operator.

``launch`` enqueues on the current stream, so a CUDA graph captures the
kernels (the train step's, ``train.step.StepGraph``). The launch counters
(``stage.copies``, the wrappers' ``*_launches``) count the launches Python
issues: a capture's, and none of its replays'.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
MAX_IMAGES = 65535           # the kernels' grid.y extent: one row per image

_lock = threading.Lock()
_libs: dict[tuple, ctypes.CDLL] = {}
_INCLUDE = re.compile(r'^\s*#include\s+"([^"]+)"', re.MULTILINE)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (not on PATH, nor under CUDA_HOME "
                           "or /usr/local/cuda): the CUDA kernels cannot be "
                           "built")
    return path


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every ``csrc/`` header it includes, directly
    or through another header, in the order first included."""
    found = [CSRC / f"{name}.cu"]
    for path in found:
        for header in _INCLUDE.findall(path.read_text()):
            if CSRC / header not in found:
                found.append(CSRC / header)
    return found


def library_path(name: str, defines: tuple = ()) -> Path:
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    digest.update(" ".join(NVCC_FLAGS).encode())
    digest.update(b"\0" + " ".join(defines).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(name: str, defines: tuple = ()) -> str:
    """Compile ``csrc/<name>.cu`` with ``defines`` unless its library is
    cached. Returns the compiler output of a new build (``-Xptxas=-v``:
    registers, shared memory, spills per kernel), or "" when the cached
    library was kept."""
    out = library_path(name, defines)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o",
           str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"CUDA kernel build failed: {name} {defines} "
                           f"(nvcc exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)              # atomic: concurrent builders are safe
    return proc.stdout


def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` built with ``defines``,
    building it if needed."""
    with _lock:
        lib = _libs.get((name, defines))
        if lib is None:
            build(name, defines)
            lib = ctypes.CDLL(str(library_path(name, defines)))
            _libs[name, defines] = lib
        return lib


def entry(lib_name: str, fn_name: str, n_ptrs: int, n_ints: int,
          defines: tuple = ()):
    """The C entry ``fn_name`` of ``csrc/<lib_name>.cu`` built with
    ``defines``: ``n_ptrs`` pointers, ``n_ints`` ints (sizes, then modes),
    the stream; returns the CUDA error code."""
    fn = getattr(load(lib_name, defines), fn_name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def ptr(t: torch.Tensor | None):
    """A tensor's device address for a C entry; None (a null pointer) for
    an absent one."""
    return None if t is None else t.data_ptr()


def channels_last(t: torch.Tensor) -> bool:
    """Whether ``t`` [..., C, H, W] lies in memory as [..., H, W, C] (and
    not also contiguous, as it is where C or H*W is 1)."""
    return not t.is_contiguous() and t.movedim(-3, -1).is_contiguous()


def as_channels_last(t: torch.Tensor) -> torch.Tensor:
    """``t`` [..., C, H, W] as the gather kernels read it: channels-last
    (its memory [..., H, W, C]). A channels-last tensor is returned as it
    is; any other is copied into that layout."""
    if t.movedim(-3, -1).is_contiguous():
        return t
    return t.movedim(-3, -1).contiguous().movedim(-1, -3)


def staged_layout(t: torch.Tensor) -> bool:
    """Whether ``t`` [N, 3, H, W] float32 has the strides of the first three
    channels of an [N, H, W, 4] tensor whose storage holds all of it: the
    layout in which the gather kernels read a 3-channel frame, one 16-byte
    load per tap (the fourth lane is never read as a value). Reads the
    tensor's metadata only, so a traced tensor answers too; ``staged``
    adds the alignment."""
    if t.dim() != 4 or t.shape[1] != 3 or t.dtype != torch.float32:
        return False
    n, _, h, w = t.shape
    want = (4 * h * w, 1, 4 * w, 4)
    return (all(s == x or d == 1
                for s, x, d in zip(t.stride(), want, t.shape))
            and t.untyped_storage().nbytes()
            >= 4 * (t.storage_offset() + 4 * n * h * w))


def staged(t: torch.Tensor) -> bool:
    """Whether ``t`` is in the ``staged_layout`` and its pixels start on a
    16-byte boundary (reads its address: not for a traced tensor)."""
    return staged_layout(t) and t.data_ptr() % 16 == 0


def check_aligned(t: torch.Tensor, name: str) -> None:
    """Raise where ``t`` cannot be read in 16-byte loads: a tensor in the
    ``staged_layout`` whose pixels do not start on a 16-byte boundary, or,
    for ``name`` "params" (12 camera scalars an image), one that does not
    start on it. Reads the address: an operator's implementation calls
    it, on either device."""
    if name == "params" and t.data_ptr() % 16:
        raise ValueError("params must start on a 16-byte boundary")
    if staged_layout(t) and t.data_ptr() % 16:
        raise ValueError(f"{name} has the staged strides but does not start "
                         f"on a 16-byte boundary (staged frames must be "
                         f"16-byte aligned)")


@torch.library.custom_op("dmv3d::stage", mutates_args=())
def _stage_copy(img: torch.Tensor) -> torch.Tensor:
    """A new [N, H, W, 4] tensor holding ``img`` [N, 3, H, W] in its first
    three lanes (the fourth left unset: no kernel reads it as a value).
    Counted in ``stage.copies``."""
    frames = img.new_empty((img.shape[0], *img.shape[2:], 4))
    frames[..., :3].copy_(img.movedim(1, -1))
    stage.copies += 1
    return frames


@_stage_copy.register_fake
def _(img):
    return img.new_empty((img.shape[0], *img.shape[2:], 4))


def stage(t: torch.Tensor) -> torch.Tensor:
    """An image ``t`` [N, C, H, W] in the layout the single-source gather
    kernels read: three channels in the ``staged_layout``, other C
    channels-last (``as_channels_last``); itself where it is in that layout
    already, else one copy: for three channels a new [N, H, W, 4] tensor
    from ``dmv3d::stage`` (so a traced program stages as the eager path
    does), returned as its [N, 3, H, W] view. Copies are counted in
    ``stage.copies``. Reads no memory; a frame in the staged layout that
    is not 16-byte aligned is refused by the kernel it is handed to."""
    if t.shape[1] != 3:
        out = as_channels_last(t)
        stage.copies += int(out is not t)
        return out
    if staged_layout(t):
        return t
    return torch.ops.dmv3d.stage(t)[..., :3].movedim(-1, 1)


stage.copies = 0


def check_inputs(what: str, ref: torch.Tensor, tensors: dict,
                 channels_last_ok: tuple = ()) -> None:
    """Raise unless each of ``tensors`` ({name: (tensor, shape)}; a tensor
    of None is skipped) has that shape and is float32, contiguous and on
    ``ref``'s device, and ``ref`` lies on the CPU or a GPU, where a launch
    takes at most MAX_IMAGES images (``ref``'s first dimension). The
    tensors named in ``channels_last_ok`` may instead be channels-last
    (``channels_last``) or in the ``staged_layout`` (its alignment is
    checked where the memory is read, ``check_aligned``). ``what`` names
    the op in the error. Reads shapes and strides only."""
    tensors = {k: v for k, v in tensors.items() if v[0] is not None}
    for name, (t, shape) in tensors.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
    for name, (t, _) in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, not {ref.device}")
        if name in channels_last_ok and (channels_last(t)
                                         or staged_layout(t)):
            continue
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous" + (
                " or channels-last, or staged (16-byte aligned)"
                if name in channels_last_ok else ""))
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {ref.device}")
    if ref.device.type == "cuda" and ref.shape[0] > MAX_IMAGES:
        raise ValueError(f"at most {MAX_IMAGES} images per launch, got "
                         f"{ref.shape[0]}")


def launch(fn, what: str, dev: torch.device, ptrs, ints) -> None:
    """Call the C entry ``fn`` on ``dev``'s current stream; raise if it
    reports a CUDA error."""
    # the C entry launches on the current GPU: make it the tensors' GPU
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*ptrs, *ints, stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
