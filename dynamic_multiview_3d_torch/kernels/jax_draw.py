"""The device draw of a train step's examples, as ``jax.random`` draws them
(the JAX package's ``ResidentFrames.device_sample``).

``jax_draw(meta, key, batch, device, index_offset)`` -> the row indices
(int64) of ``batch`` examples: per example ``fold_in(key, index_offset +
i)``, split four ways, then the scene (``randint``), the source views
(``permutation(...)[:T]`` or ``randint``), the target views
(``permutation(...)[:K]`` or ``randint``) and t0 (``randint``), as
``csrc/jax_draw.cu``'s header sets out. On the CPU it is the plain
version, ``jax_draw_plain``: torch ops over ``utils/jax_random.py``, each
kind of draw of the B examples in one threefry call. On CUDA it launches
the kernel (one launch, one thread an example, the key and sizes by
value: no host-to-device copy) or raises; launches are counted in
``jax_draw.launches``.
"""

from __future__ import annotations

import torch

from dynamic_multiview_3d_torch.kernels import _build
from dynamic_multiview_3d_torch.utils import jax_random as jr

_NAMES = ("seq_idx", "tgt_idx", "src_pose_idx", "tgt_pose_idx")


def _rows(meta: dict, scene, src, tgt, t0) -> dict:
    v, t_avail, t_len = meta["num_views"], meta["t_avail"], meta["t_len"]
    base = scene[:, None] * v
    ts = t0[:, None] + torch.arange(t_len, device=scene.device)
    return {"seq_idx": (base + src) * t_avail + ts,
            "tgt_idx": (base + tgt) * t_avail + t0[:, None] + t_len - 1,
            "src_pose_idx": base + src, "tgt_pose_idx": base + tgt}


def jax_draw_plain(meta: dict, key: tuple, batch: int, device,
                   index_offset: int = 0) -> dict:
    """The kernel's plain version: the same draws in torch ops."""
    s, v = meta["num_scenes"], meta["num_views"]
    t_avail, t_len, k = meta["t_avail"], meta["t_len"], meta["num_targets"]
    kk = jr.fold_in(key, torch.arange(index_offset, index_offset + batch,
                                      device=device))
    k1, k2, k3, k4 = jr.split(kk, 4)
    scene = jr.randint(k1, (), 0, s)
    if not meta.get("orbit", False):          # one camera films all T
        src = jr.randint(k2, (), 0, v)[:, None].expand(batch, t_len)
    elif v >= t_len:
        src = jr.permutation(k2, v)[:, :t_len]
    else:
        src = jr.randint(k2, (t_len,), 0, v)
    tgt = jr.permutation(k3, v)[:, :k] if v >= k \
        else jr.randint(k3, (k,), 0, v)
    t0 = jr.randint(k4, (), 0, t_avail - t_len + 1)
    return _rows(meta, scene, src, tgt, t0)


def jax_draw(meta: dict, key: tuple, batch: int, device,
             index_offset: int = 0) -> dict:
    """The rows of ``batch`` examples drawn from the sampling ``key`` (a
    pair of Python ints) at global indices ``index_offset + i``: dict of
    int64 tensors ``seq_idx`` [B, T], ``tgt_idx`` [B, K],
    ``src_pose_idx`` [B, T], ``tgt_pose_idx`` [B, K] on ``device``."""
    device = torch.device(device)
    if device.type == "cpu":
        return jax_draw_plain(meta, key, batch, device, index_offset)
    if device.type != "cuda":
        raise ValueError(f"jax_draw runs on cpu or cuda, not {device}")
    t_len, k, v = meta["t_len"], meta["num_targets"], meta["num_views"]
    if not (0 <= index_offset and index_offset + batch <= jr.INT32_MAX):
        raise ValueError(f"example indices [{index_offset}, "
                         f"{index_offset + batch}) are not int32")
    out = {name: torch.empty((batch, n), dtype=torch.int64, device=device)
           for name, n in zip(_NAMES, (t_len, k, t_len, k))}
    ws_keys = torch.empty((v, batch), dtype=torch.int32, device=device)
    ws_vals = torch.empty((v, batch), dtype=torch.int32, device=device)
    signed = [x - 2 ** 32 if x > jr.INT32_MAX else x for x in key]
    fn = _build.entry("jax_draw", "dmv3d_jax_draw", 6, 11)
    _build.launch(fn, "jax_draw", device,
                  [_build.ptr(x) for x in (*out.values(), ws_keys, ws_vals)],
                  (*signed, index_offset, batch, meta["num_scenes"], v,
                   meta["t_avail"], t_len, k, int(meta.get("orbit", False)),
                   jr.shuffle_rounds(v)))
    jax_draw.launches += 1
    return out


jax_draw.launches = 0
