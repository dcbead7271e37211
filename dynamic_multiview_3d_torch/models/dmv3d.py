"""DMV3D — pose-conditioned encoder-decoder (port of models/dmv3d.py).

This slice ports the flow-synthesis path: Encoder -> ConvGRU/ConvLSTM over T
-> PoseBottleneck -> Decoder (subpixel up-convs, split or concat skip fusion,
FastGroupNorm) -> 6-channel flow/mask/rgb heads -> fused flow warp + mask
composite + validity. Submodule and parameter names follow the flax tree
(``recurrent/encoder/down1/conv/kernel`` -> ``recurrent.encoder.down1.conv.
weight``) so ``weights.from_flax`` maps one onto the other.

Public layout is the JAX package's NHWC (``image_seq [B,T,H,W,3]``, outputs
``[B,K,H,W,C]``); inside, the convolutions run NCHW. K target poses fold into
the decoder batch (B*K); params are f32, convs compute in ``cfg.dtype``, the
head nonlinearities, the warp and the composite in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dynamic_multiview_3d_torch.config import ModelConfig
from dynamic_multiview_3d_torch.kernels import grid_sample
from dynamic_multiview_3d_torch.models.layers import (
    Conv,
    ConvBlock,
    ConvGRUCell,
    ConvLSTMCell,
    Dense,
    FastGroupNorm,
    _num_groups,
    depth_to_space2,
)
from dynamic_multiview_3d_torch.ops import pose as pose_ops

_POSE_DIMS = {"sincos": 8, "mat": 12}


def _features(cfg: ModelConfig, level: int) -> int:
    return min(cfg.base_features * (2 ** level), cfg.max_features)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)          # "float32" / "bfloat16" names match


class Encoder(nn.Module):
    """Stride-2 conv stack image -> (bottleneck, per-resolution skips)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        dt = _dtype(cfg.dtype)
        self.stem = ConvBlock(3, _features(cfg, 0), 1, norm=cfg.norm, dtype=dt)
        for i in range(1, cfg.num_levels + 1):
            f_in, f = _features(cfg, i - 1), _features(cfg, i)
            setattr(self, f"down{i}",
                    ConvBlock(f_in, f, 2, norm=cfg.norm, dtype=dt))
            setattr(self, f"res{i}", ConvBlock(f, f, 1, norm=cfg.norm, dtype=dt))

    def forward(self, x: torch.Tensor):
        cfg = self.cfg
        x = self.stem(x.to(_dtype(cfg.dtype)))
        skips = [x]
        for i in range(1, cfg.num_levels + 1):
            x = getattr(self, f"res{i}")(getattr(self, f"down{i}")(x))
            if i < cfg.num_levels:
                skips.append(x)
        return x, skips


class PoseBottleneck(nn.Module):
    """Inject the target-pose code at the bottleneck: MLP-embed the pose,
    tile it over the bottleneck's spatial extent, concat, mix with 1x1 and
    3x3 ConvBlocks."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        dt = _dtype(cfg.dtype)
        e = cfg.pose_embed_dim
        self.pose_fc1 = Dense(_POSE_DIMS[cfg.pose_mode], e, dtype=dt)
        self.pose_fc2 = Dense(e, e, dtype=dt)
        self.mix1 = ConvBlock(cfg.gru_features + e, cfg.gru_features,
                              kernel=1, norm=cfg.norm, dtype=dt)
        self.mix2 = ConvBlock(cfg.gru_features, cfg.gru_features, kernel=3,
                              norm=cfg.norm, dtype=dt)

    def forward(self, bottleneck: torch.Tensor, pose_code: torch.Tensor):
        dt = _dtype(self.cfg.dtype)
        emb = self.pose_fc2(F.relu(self.pose_fc1(pose_code.to(dt))))
        n, _, h, w = bottleneck.shape
        tiled = emb[:, :, None, None].expand(n, emb.shape[1], h, w)
        x = torch.cat([bottleneck.to(dt), tiled], dim=1)
        return self.mix2(self.mix1(x))


class Decoder(nn.Module):
    """Subpixel up-conv stack with U-Net skips -> flow/mask/rgb heads.

    ``x`` is per-target [B*K, ...]; ``skips`` are per-example [B, ...];
    ``k`` is the number of targets folded into x's batch axis.
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        dt = _dtype(cfg.dtype)
        ku = cfg.up_kernel
        f_in = cfg.gru_features
        for i in range(cfg.num_levels - 1, -1, -1):
            f = _features(cfg, i)
            setattr(self, f"up{i}_conv", Conv(f_in, 4 * f, ku, dtype=dt))
            if cfg.norm == "group":
                groups = (4 * _num_groups(f) if cfg.up_order == "norm_first"
                          else _num_groups(f))
                width = 4 * f if cfg.up_order == "norm_first" else f
                setattr(self, f"up{i}_norm", FastGroupNorm(groups, width, dt))
            if cfg.skip_fusion == "concat":
                setattr(self, f"fuse{i}_x", Conv(2 * f, f, 3, dtype=dt))
            else:
                setattr(self, f"fuse{i}_x", Conv(f, f, 3, dtype=dt))
                setattr(self, f"fuse{i}_skip",
                        Conv(f, f, 3, use_bias=False, dtype=dt))
            if cfg.norm == "group":
                setattr(self, f"fuse{i}_norm",
                        FastGroupNorm(_num_groups(f), f, dt))
            f_in = f
        self.heads = Conv(f_in, 6, 3, dtype=_dtype(cfg.heads_compute_dtype))

    def forward(self, x: torch.Tensor, skips, k: int = 1) -> dict:
        cfg = self.cfg
        dt = _dtype(cfg.dtype)
        group = cfg.norm == "group"
        x = x.to(dt)
        for i in range(cfg.num_levels - 1, -1, -1):
            f = _features(cfg, i)
            x = getattr(self, f"up{i}_conv")(x)
            if cfg.up_order == "norm_first":
                # per-phase groups at low resolution, then shuffle
                if group:
                    x = getattr(self, f"up{i}_norm")(x)
                x = depth_to_space2(F.relu(x))
            else:
                x = depth_to_space2(x)
                if group:
                    x = getattr(self, f"up{i}_norm")(x)
                x = F.relu(x)
            b = skips[i].shape[0]
            hh, ww = x.shape[2:]
            if cfg.skip_fusion == "concat":
                sk = skips[i].to(dt).repeat_interleave(k, dim=0)
                x = getattr(self, f"fuse{i}_x")(torch.cat([x, sk], dim=1))
            else:
                # conv_x(x) + conv_s(skip): the skip branch runs once per
                # example [B] and broadcasts over the K targets.
                hx = getattr(self, f"fuse{i}_x")(x)
                hs = getattr(self, f"fuse{i}_skip")(skips[i].to(dt))
                x = (hx.reshape(b, k, f, hh, ww)
                     + hs[:, None]).reshape(b * k, f, hh, ww)
            if group:
                x = getattr(self, f"fuse{i}_norm")(x)
            x = F.relu(x)

        # one conv in heads_compute_dtype, nonlinearities in f32
        h3 = self.heads(x).to(torch.float32)
        flow = torch.tanh(h3[:, 0:2]) * (cfg.max_flow * cfg.image_size)
        mask = torch.sigmoid(h3[:, 2:3])
        rgb = torch.tanh(h3[:, 3:6])
        return {"flow": flow, "mask": mask, "rgb": rgb}


class _RecurrentStep(nn.Module):
    """One recurrence step: encode frame, advance the cell, refresh skips."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        dt = _dtype(cfg.dtype)
        self.encoder = Encoder(cfg)
        bott = _features(cfg, cfg.num_levels)
        if cfg.rnn == "lstm":
            self.lstm = ConvLSTMCell(bott, cfg.gru_features, dtype=dt)
        else:
            self.gru = ConvGRUCell(bott, cfg.gru_features, dtype=dt)

    def forward(self, h: torch.Tensor, frame: torch.Tensor):
        bottleneck, skips = self.encoder(frame)
        cell = self.lstm if self.cfg.rnn == "lstm" else self.gru
        return cell(h.to(_dtype(self.cfg.dtype)), bottleneck), skips


class DMV3D(nn.Module):
    """Full model: ``(image_seq, src_poses, tgt_poses) -> novel views``.

    image_seq [B,T,H,W,3] in [-1,1]; src_poses [B,T,3]; tgt_poses [B,K,3]
    (az, el, radius). Returns a dict with "view" [B,K,H,W,3] plus the aux
    heads "warped", "flow", "flow_valid", "mask", "rgb", NHWC as in JAX.

    Only ``synthesis="flow"`` without ``predict_depth`` is ported; the other
    paths raise at construction. The warp picks its implementation from the
    tensors' device (kernels on CUDA, plain versions on CPU), forward and
    backward; the config's ``use_pallas`` is a JAX-only switch the port
    does not read.
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.synthesis in ("multiflow", "multidepth"):
            raise NotImplementedError(
                f"synthesis={cfg.synthesis!r} is not ported yet: ROADMAP.md "
                "queue 1 item 7 (multi-source slice)")
        if cfg.synthesis == "depth" or cfg.predict_depth:
            raise NotImplementedError(
                "synthesis='depth' / predict_depth=True are not ported yet: "
                "ROADMAP.md queue 1 item 8 (depth slice)")
        if cfg.synthesis != "flow":
            raise ValueError(f"unknown synthesis: {cfg.synthesis!r}")
        if cfg.pose_mode not in _POSE_DIMS:
            raise ValueError(f"unknown pose mode: {cfg.pose_mode}")
        self.cfg = cfg
        self.recurrent = _RecurrentStep(cfg)
        self.bottleneck = PoseBottleneck(cfg)
        self.decoder = Decoder(cfg)

    def forward(self, image_seq: torch.Tensor, src_poses: torch.Tensor,
                tgt_poses: torch.Tensor) -> dict:
        cfg = self.cfg
        b, t, h, w, _ = image_seq.shape
        k = tgt_poses.shape[1]
        dt = _dtype(cfg.dtype)
        dev = image_seq.device

        # --- temporal encode: a Python loop over frames replaces nn.scan.
        # remat_scan recomputes each step's activations in the backward
        # pass instead of keeping them (nn.remat on the scan body); it only
        # applies where autograd records. Frames go NCHW-contiguous whatever
        # the caller's strides, so the convolutions always see one memory
        # format (and one result).
        frames = image_seq.permute(1, 0, 4, 2, 3).contiguous()   # [T,B,3,H,W]
        cell = ConvLSTMCell if cfg.rnn == "lstm" else ConvGRUCell
        state = cell.init_state(b, cfg.bottleneck_size, cfg.bottleneck_size,
                                cfg.gru_features, dt, dev)
        remat = cfg.remat_scan and torch.is_grad_enabled()
        for ti in range(t):
            if remat:
                state, skips = checkpoint(self.recurrent, state, frames[ti],
                                          use_reentrant=False)
            else:
                state, skips = self.recurrent(state, frames[ti])
        if cfg.rnn == "lstm":
            state = ConvLSTMCell.hidden(state, cfg.gru_features)

        # --- pose conditioning: last-source code per target; K folds into
        # the batch (each example's rows repeated K times, in order).
        pose_code = pose_ops.encode_pose(
            src_poses[:, -1].repeat_interleave(k, dim=0),
            tgt_poses.reshape(b * k, -1), mode=cfg.pose_mode)    # [B*K, P]
        z = self.bottleneck(state.repeat_interleave(k, dim=0), pose_code)
        heads = self.decoder(z, skips, k)

        # --- synthesis: fused warp of the last frame + composite + validity
        last_frame = image_seq[:, -1].to(torch.float32).permute(0, 3, 1, 2) \
            .repeat_interleave(k, dim=0).contiguous()           # [B*K,3,H,W]
        flow, mask, rgb = heads["flow"], heads["mask"], heads["rgb"]
        n = b * k
        xs = torch.arange(w, dtype=torch.float32, device=dev)
        ys = torch.arange(h, dtype=torch.float32, device=dev)
        ix = (xs + flow[:, 0]).reshape(n, h * w)
        iy = (ys[:, None] + flow[:, 1]).reshape(n, h * w)
        view, warped, valid = grid_sample.warp_composite_pix(
            last_frame, ix, iy, mask.reshape(n, h * w),
            rgb.reshape(n, 3, h * w), "border", cfg.warp_precision)

        def nhwc(x, c):                          # [B*K, C, ...] -> [B,K,H,W,C]
            return x.reshape(b, k, c, h, w).permute(0, 1, 3, 4, 2)
        return {
            "warped": nhwc(warped, 3),
            "flow": nhwc(flow, 2),
            "flow_valid": valid.reshape(b, k, h, w),
            "mask": nhwc(mask, 1),
            "rgb": nhwc(rgb, 3),
            "view": nhwc(view, 3),
        }
