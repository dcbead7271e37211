"""DMV3D — pose-conditioned encoder-decoder (port of models/dmv3d.py).

Ported: Encoder -> ConvGRU/ConvLSTM over T -> PoseBottleneck -> Decoder
(subpixel up-convs, split or concat skip fusion, FastGroupNorm) -> heads ->
synthesis, for every synthesis mode: ``"flow"`` (6-channel flow/mask/rgb
heads, fused flow warp + mask composite + validity; with ``predict_depth``
the depth head and the fused depth reprojection of ``kernels/reproject.py``
as a geometric side view), ``"depth"`` (the same heads; the flow warp
through the plain sampler, the view from the fused reprojection +
composite), and the multi-source modes ``"multiflow"`` and ``"multidepth"``
(per-source heads, baked or shared, then the fused multi-source warp +
confidence blend + composite of ``kernels/multiflow.py``). Submodule and parameter names follow the flax tree
(``recurrent/encoder/down1/conv/kernel`` -> ``recurrent.encoder.down1.conv.
weight``) so ``weights.from_flax`` maps one onto the other.

Public layout is the JAX package's NHWC (``image_seq [B,T,H,W,3]``, outputs
``[B,K,H,W,C]``); inside, the convolutions run NCHW. K target poses fold into
the decoder batch (B*K); params are f32, convs compute in ``cfg.dtype``, the
head nonlinearities, the warp and the composite in f32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dynamic_multiview_3d_torch.config import ModelConfig
from dynamic_multiview_3d_torch.kernels import (
    _build,
    grid_sample,
    multiflow,
    reproject,
)
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
from dynamic_multiview_3d_torch.ops import reproject as reproject_ops
from dynamic_multiview_3d_torch.utils import profiling

_POSE_DIMS = {"sincos": 8, "mat": 12}
_MULTI = ("multiflow", "multidepth")
# The bf16 convolutions whose result cuDNN makes depend on the batch size
# on an H100: given the same input, the c2 model's 16 rows and their two
# halves of 8 differ in these layers alone (by one bf16 ulp), and by up
# to 0.78 in the views downstream (chip_smoke.py [batch-gap]). They
# compute in f32 with TF32 off (``Conv.compute_exact``), which keeps each
# row's result independent of its batch, at no measured cost to a c2
# request. The JAX package computes them in bf16.
_F32_CONVS = ("recurrent.encoder.res2.conv", "decoder.fuse4_x",
              "decoder.fuse2_skip")


def _last_frame(image_seq: torch.Tensor, stage: bool | None = None
                ) -> torch.Tensor:
    """The last frame of ``image_seq`` [B, T, H, W, 3] as [B, 3, H, W] f32,
    in the layout every single-source kernel reads, one frame per example
    for its K targets. Where ``stage`` (by default: on CUDA, and while
    ``torch.export`` traces the model for the card, ``serving``) it is
    staged once (``_build.stage``: [B, H, W, 4], one ``dmv3d::stage``
    copy), and the kernels of the forward and their backward all read that
    view, so no wrapper copies it again. Otherwise (the CPU's plain
    versions) it is the NHWC frame as a channels-last view, a copy only
    where T > 1 leaves it strided."""
    last = image_seq[:, -1].to(torch.float32)
    if stage is None:
        stage = last.is_cuda or torch.compiler.is_exporting()
    if stage:
        return _build.stage(last.permute(0, 3, 1, 2))
    return last.contiguous().permute(0, 3, 1, 2)


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
    3x3 ConvBlocks.

    A 3-D ``pose_code`` [N, T, P] (multi-source, shared heads) goes through
    the same MLP per source and is mean-pooled over T; baked heads pass the
    T codes flattened, [N, T*P] (``code_dim`` = T*P)."""

    def __init__(self, cfg: ModelConfig, code_dim: int):
        super().__init__()
        self.cfg = cfg
        dt = _dtype(cfg.dtype)
        e = cfg.pose_embed_dim
        self.pose_fc1 = Dense(code_dim, e, dtype=dt)
        self.pose_fc2 = Dense(e, e, dtype=dt)
        self.mix1 = ConvBlock(cfg.gru_features + e, cfg.gru_features,
                              kernel=1, norm=cfg.norm, dtype=dt)
        self.mix2 = ConvBlock(cfg.gru_features, cfg.gru_features, kernel=3,
                              norm=cfg.norm, dtype=dt)

    def forward(self, bottleneck: torch.Tensor, pose_code: torch.Tensor):
        dt = _dtype(self.cfg.dtype)
        emb = self.pose_fc2(F.relu(self.pose_fc1(pose_code.to(dt))))
        if emb.dim() == 3:                      # [N, T, E] -> pooled [N, E]
            emb = emb.mean(1)
        n, _, h, w = bottleneck.shape
        tiled = emb[:, :, None, None].expand(n, emb.shape[1], h, w)
        x = torch.cat([bottleneck.to(dt), tiled], dim=1)
        return self.mix2(self.mix1(x))


class Decoder(nn.Module):
    """Subpixel up-conv stack with U-Net skips -> heads.

    ``x`` is per-target [B*K, ...]; ``skips`` are per-example [B, ...];
    ``k`` is the number of targets folded into x's batch axis. The heads:
    flow/mask/rgb for "flow"; for the multi-source modes either the shared
    per-source head (``num_sources`` None: parameter shapes carry no T, the
    pose codes ``src_codes`` [B*K, T, P] pick each source's output) or the
    baked conv of 3T+4 (multiflow) / T+4 (multidepth) channels for
    ``num_sources`` = T; multidepth, and flow or depth synthesis with
    ``predict_depth``, add the depth head. Outputs are NCHW:
    flow [N,2,H,W] or [N,T,2,H,W], conf [N,T,H,W], mask [N,1,H,W],
    rgb [N,3,H,W], depth [N,H,W].
    """

    def __init__(self, cfg: ModelConfig, num_sources: int | None = None):
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
        dth = _dtype(cfg.heads_compute_dtype)
        self.num_sources = num_sources
        if cfg.synthesis in _MULTI and num_sources is None:
            # shared heads: one per-source head over the source axis
            fs = cfg.src_head_features
            self.heads_base = Conv(f_in, 4, 3, dtype=dth)
            self.srchead_trunk = Conv(f_in, fs, 3, dtype=dth)
            self.srchead_emb = Dense(_POSE_DIMS[cfg.pose_mode], fs, dtype=dth)
            self.srchead_pose = Dense(fs, fs, dtype=dth)
            self.srchead_mix = Conv(fs, fs, 1, dtype=dth)
            self.srchead_out = Conv(
                fs, 3 if cfg.synthesis == "multiflow" else 1, 1, dtype=dth)
        elif cfg.synthesis == "multiflow":
            self.heads_multi = Conv(f_in, 3 * num_sources + 4, 3, dtype=dth)
        elif cfg.synthesis == "multidepth":
            self.heads_multi = Conv(f_in, num_sources + 4, 3, dtype=dth)
        else:
            self.heads = Conv(f_in, 6, 3, dtype=dth)
        if cfg.synthesis == "multidepth" or cfg.predict_depth:
            self.depth_head = Conv(f_in, 1, 3, dtype=dth)

    def forward(self, x: torch.Tensor, skips, k: int = 1,
                src_codes: torch.Tensor | None = None) -> dict:
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

        # convs in heads_compute_dtype, nonlinearities in f32
        if cfg.synthesis in _MULTI:
            out = (self._baked_multi_heads(x) if self.num_sources
                   else self._shared_multi_heads(x, src_codes))
        else:
            h3 = self.heads(x).to(torch.float32)
            out = {"flow": torch.tanh(h3[:, 0:2]) * (cfg.max_flow
                                                     * cfg.image_size),
                   "mask": torch.sigmoid(h3[:, 2:3]),
                   "rgb": torch.tanh(h3[:, 3:6])}
        if hasattr(self, "depth_head"):
            raw = self.depth_head(x).to(torch.float32)
            out["depth"] = F.softplus(raw)[:, 0] + 0.1
        return out

    def _baked_multi_heads(self, x: torch.Tensor) -> dict:
        """One conv with T baked into its channels: [2T flow ((t, xy)
        interleaved) | T conf | mask | 3 rgb] for multiflow, [T conf | mask |
        3 rgb] for multidepth."""
        cfg = self.cfg
        s = self.num_sources
        hm = self.heads_multi(x).to(torch.float32)
        n, _, hh, ww = hm.shape
        out = {}
        if cfg.synthesis == "multiflow":
            out["flow"] = (torch.tanh(hm[:, :2 * s]).reshape(n, s, 2, hh, ww)
                           * (cfg.max_flow * cfg.image_size))
            hm = hm[:, 2 * s:]
        out.update(conf=hm[:, :s], mask=torch.sigmoid(hm[:, s:s + 1]),
                   rgb=torch.tanh(hm[:, s + 1:s + 4]))
        return out

    def _shared_multi_heads(self, x: torch.Tensor,
                            src_codes: torch.Tensor) -> dict:
        """T-agnostic heads: mask/rgb from ``heads_base``; a spatial trunk
        conv once per target, each source's pose code added as a FiLM-style
        bias, then two 1x1 convs with the T sources folded into the batch
        (n-major) emit that source's flow and conf (multiflow) or conf
        (multidepth)."""
        cfg = self.cfg
        base = self.heads_base(x).to(torch.float32)
        out = {"mask": torch.sigmoid(base[:, 0:1]),
               "rgb": torch.tanh(base[:, 1:4])}
        hf = self.srchead_trunk(x)                              # [N, F, H, W]
        emb = self.srchead_pose(F.relu(self.srchead_emb(src_codes)))
        n, f, hh, ww = hf.shape
        s = emb.shape[1]
        u = F.relu(hf[:, None] + emb[:, :, :, None, None])  # [N, S, F, H, W]
        u = F.relu(self.srchead_mix(u.reshape(n * s, f, hh, ww)))
        y = self.srchead_out(u).to(torch.float32).reshape(n, s, -1, hh, ww)
        if cfg.synthesis == "multiflow":
            out["flow"] = (torch.tanh(y[:, :, :2])
                           * (cfg.max_flow * cfg.image_size))  # [N,S,2,H,W]
            out["conf"] = y[:, :, 2]                            # [N,S,H,W]
        else:
            out["conf"] = y[:, :, 0]
        return out


@contextlib.contextmanager
def _recomputed():
    """The recomputation of one frame's recurrent step in the backward
    (``remat_scan``): the span ``dmv3d.encode.recompute`` and one
    ``dmv3d.encode.recomputed_frames``, decided as it starts."""
    with profiling.span("dmv3d.encode.recompute"):
        profiling.count("dmv3d.encode.recomputed_frames")
        yield


def _recompute_context():
    """``checkpoint``'s contexts: none around the forward, ``_recomputed``
    around the recomputation."""
    return contextlib.nullcontext(), _recomputed()


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
    (az, el, radius). Returns a dict with "view" [B,K,H,W,3] plus aux
    outputs, NHWC as in JAX: "warped", "flow", "flow_valid", "mask", "rgb"
    for flow and depth synthesis, with ``predict_depth`` also "depth"
    [B,K,H,W], "geo_view" [B,K,H,W,3] and "geo_valid" [B,K,H,W] (the last
    source frame reprojected into each target through the predicted depth;
    depth synthesis composites the view from it, flow synthesis from the
    flow warp); "warped", "flow" [B,K,T,H,W,2], "flow_valid", "mask",
    "rgb", "conf_weights" [B,K,H,W,T] for multiflow; "mask", "rgb",
    "depth", "geo_valid", "warped" (= "geo_view"), "conf_weights" for
    multidepth.

    Multi-source heads in ``multi_head_mode="baked"`` bake the source count
    into their parameter shapes (flax infers it lazily from the first call;
    here it is ``num_sources``, required in that mode, and a call with
    another T raises). Shared heads and flow synthesis ignore it.

    ``synthesis="depth"`` without ``predict_depth`` raises at construction
    (the JAX model raises at its first call). The warps pick their
    implementation from the tensors' device (kernels on CUDA, plain
    versions on CPU), forward and backward; the config's ``use_pallas`` is
    a JAX-only switch the port does not read.
    """

    def __init__(self, cfg: ModelConfig, num_sources: int | None = None):
        super().__init__()
        if cfg.synthesis in _MULTI:
            if cfg.predict_depth:
                raise ValueError(
                    f"synthesis={cfg.synthesis!r} does not combine with "
                    "predict_depth (the geometric side-path belongs to "
                    "'flow' synthesis; 'multidepth' predicts depth already)")
            if cfg.multi_head_mode not in ("shared", "baked"):
                raise ValueError(
                    f"unknown multi_head_mode: {cfg.multi_head_mode!r}")
            if cfg.multi_head_mode == "baked" and not num_sources:
                raise ValueError(
                    "multi_head_mode='baked' heads need the source count "
                    "they were made for: DMV3D(cfg, num_sources=T)")
        elif cfg.synthesis == "depth" and not cfg.predict_depth:
            raise ValueError("synthesis='depth' requires predict_depth=True")
        elif cfg.synthesis not in ("flow", "depth"):
            raise ValueError(f"unknown synthesis: {cfg.synthesis!r}")
        if cfg.pose_mode not in _POSE_DIMS:
            raise ValueError(f"unknown pose mode: {cfg.pose_mode}")
        self.cfg = cfg
        baked = cfg.synthesis in _MULTI and cfg.multi_head_mode == "baked"
        self.num_sources = num_sources if baked else None
        self.recurrent = _RecurrentStep(cfg)
        self.bottleneck = PoseBottleneck(
            cfg, _POSE_DIMS[cfg.pose_mode] * (self.num_sources or 1))
        self.decoder = Decoder(cfg, self.num_sources)
        if cfg.dtype == "bfloat16":
            names = dict(self.named_modules())
            for name in _F32_CONVS:
                if name in names:
                    names[name].compute_exact()

    def forward(self, image_seq: torch.Tensor, src_poses: torch.Tensor,
                tgt_poses: torch.Tensor) -> dict:
        t = image_seq.shape[1]
        if self.num_sources is not None and t != self.num_sources:
            raise ValueError(
                f"these baked multi-source heads were made for "
                f"{self.num_sources} sources, not {t}")
        with profiling.span("dmv3d.encode"):
            state, skips = self._encode(image_seq)
        with profiling.span("dmv3d.decode"):
            heads = self._decode(state, skips, src_poses, tgt_poses)
        with profiling.span("dmv3d.synthesis"):
            if self.cfg.synthesis == "multiflow":
                return self._multiflow_composite(heads, image_seq,
                                                 tgt_poses.shape[1])
            if self.cfg.synthesis == "multidepth":
                return self._multidepth_composite(heads, image_seq,
                                                  src_poses, tgt_poses)
            return self._composite(heads, image_seq, src_poses, tgt_poses)

    def _encode(self, image_seq: torch.Tensor):
        """The recurrent encoder over the T frames -> (state, the last
        frame's skips)."""
        cfg = self.cfg
        b, t = image_seq.shape[:2]
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
                                          use_reentrant=False,
                                          context_fn=_recompute_context)
            else:
                state, skips = self.recurrent(state, frames[ti])
        if cfg.rnn == "lstm":
            state = ConvLSTMCell.hidden(state, cfg.gru_features)
        return state, skips

    def _decode(self, state: torch.Tensor, skips, src_poses: torch.Tensor,
                tgt_poses: torch.Tensor) -> dict:
        """The pose codes, the bottleneck and the decoder -> its heads, K
        targets folded into the batch."""
        cfg = self.cfg
        b, k = tgt_poses.shape[:2]
        # --- pose conditioning; K folds into the batch (each example's rows
        # repeated K times, in order). Multi-source modes code EVERY source
        # against each target ([B*K, T, P]): shared heads pool the codes at
        # the bottleneck and get them raw at the per-source head, baked
        # heads take them flattened. Flow synthesis codes the last source.
        src_codes = None
        if cfg.synthesis in _MULTI:
            src_rep = src_poses.repeat_interleave(k, dim=0)       # [B*K,T,3]
            tgt_rep = tgt_poses.reshape(b * k, 1, -1).expand_as(src_rep)
            pose_code = pose_ops.encode_pose(src_rep, tgt_rep,
                                             mode=cfg.pose_mode)
            if self.num_sources is None:
                src_codes = pose_code
            else:
                pose_code = pose_code.reshape(b * k, -1)          # [B*K,T*P]
        else:
            pose_code = pose_ops.encode_pose(
                src_poses[:, -1].repeat_interleave(k, dim=0),
                tgt_poses.reshape(b * k, -1), mode=cfg.pose_mode)  # [B*K,P]
        z = self.bottleneck(state.repeat_interleave(k, dim=0), pose_code)
        return self.decoder(z, skips, k, src_codes)

    def _composite(self, heads: dict, image_seq: torch.Tensor,
                   src_poses: torch.Tensor, tgt_poses: torch.Tensor) -> dict:
        """Flow and depth synthesis from the heads -> the outputs."""
        cfg = self.cfg
        b, _, h, w, _ = image_seq.shape
        k = tgt_poses.shape[1]
        dev = image_seq.device
        # --- synthesis from the last frame, one per example, shared by its
        # K targets and never copied per target (``_last_frame``). Flow:
        # the fused warp + composite + validity, target n reading frame
        # n // K. Depth: the flow warp through the plain sampler (an aux
        # output no loss reads), each frame sampled at its K targets'
        # pixels, and the view from the fused depth reprojection +
        # composite below.
        frame = _last_frame(image_seq)                          # [B,3,H,W]
        flow, mask, rgb = heads["flow"], heads["mask"], heads["rgb"]
        n = b * k
        xs = torch.arange(w, dtype=torch.float32, device=dev)
        ys = torch.arange(h, dtype=torch.float32, device=dev)
        ix = (xs + flow[:, 0]).reshape(n, h * w)
        iy = (ys[:, None] + flow[:, 1]).reshape(n, h * w)
        mask_p, rgb_p = mask.reshape(n, h * w), rgb.reshape(n, 3, h * w)

        def nhwc(x, c):                          # [B*K, C, ...] -> [B,K,H,W,C]
            return x.reshape(b, k, c, h, w).permute(0, 1, 3, 4, 2)
        if cfg.synthesis == "flow":
            view, warped, valid = grid_sample.warp_composite_pix(
                frame, ix, iy, mask_p, rgb_p, "border", cfg.warp_precision)
            warped = nhwc(warped, 3)
        else:
            warped = grid_sample.sample_pixel_coords(
                frame, ix.reshape(b, k * h * w), iy.reshape(b, k * h * w),
                "border", cfg.warp_precision)                   # [B,3,K*H*W]
            warped = warped.reshape(b, 3, k, h, w).permute(0, 2, 3, 4, 1)
            valid = grid_sample.in_bounds(ix, iy, h, w)
        out = {
            "warped": warped,
            "flow": nhwc(flow, 2),
            "flow_valid": valid.reshape(b, k, h, w),
            "mask": nhwc(mask, 1),
            "rgb": nhwc(rgb, 3),
        }
        if cfg.predict_depth:
            # the last source frame reprojected into each target through the
            # predicted target depth: correspondences in the kernel from 12
            # camera scalars per image (focal max(H, W), centred principal
            # point, last source camera -> target camera)
            depth = heads["depth"]                               # [B*K,H,W]
            intr = pose_ops.intrinsics_matrix(
                torch.full((n,), float(max(h, w)), device=dev),
                (w - 1) / 2.0, (h - 1) / 2.0)
            rel = pose_ops.relative_transform(
                pose_ops.look_at_extrinsics(
                    src_poses[:, -1].repeat_interleave(k, dim=0)),
                pose_ops.look_at_extrinsics(tgt_poses.reshape(n, -1)))
            params = reproject.host_params(intr, rel)
            depth_p = depth.reshape(n, h * w)
            if cfg.synthesis == "depth":
                view, geo, geo_valid = reproject.reproject_composite_pix(
                    frame, depth_p, params, mask_p, rgb_p,
                    cfg.warp_precision)
            else:
                geo, geo_valid = reproject.reproject_sample_pix(
                    frame, depth_p, params, cfg.warp_precision)
            out.update(depth=depth.reshape(b, k, h, w),
                       geo_view=nhwc(geo, 3),
                       geo_valid=geo_valid.reshape(b, k, h, w))
        out["view"] = nhwc(view, 3)
        return out

    def _blend_sources(self, heads: dict, image_seq: torch.Tensor, ix, iy,
                       conf, k: int) -> dict:
        """The fused multi-source kernel over all T frames: every frame is
        sampled at its K*H*W target pixels (ix, iy, conf [B, T, K*H*W]), so
        the frames are never copied K times, nor transposed: the kernel
        takes the NHWC frames as a channels-last [B,T,3,H,W] view. -> view,
        multi [B,K,H,W,3], any_valid [B,K,H,W], wts [B,K,H,W,T], mask, rgb,
        NHWC."""
        b, t, h, w, _ = image_seq.shape
        imgs = image_seq.to(torch.float32).contiguous() \
            .permute(0, 1, 4, 2, 3)                             # [B,T,3,H,W]
        mask, rgb = heads["mask"], heads["rgb"]                 # [B*K,C,H,W]

        def pixels(x):                           # [B*K,C,H,W] -> [B,C,K*H*W]
            return x.reshape(b, k, -1, h * w).transpose(1, 2) \
                .reshape(b, -1, k * h * w).contiguous()

        def nhwc(x):                             # [B,C,K*H*W] -> [B,K,H,W,C]
            return x.reshape(b, -1, k, h, w).permute(0, 2, 3, 4, 1)
        view, multi, any_valid, wts = multiflow.multiflow_composite_pix(
            imgs, ix, iy, conf, pixels(mask)[:, 0], pixels(rgb), "border",
            self.cfg.warp_precision)
        return {"view": nhwc(view), "multi": nhwc(multi),
                "any_valid": any_valid.reshape(b, k, h, w), "wts": nhwc(wts),
                "mask": mask.reshape(b, k, 1, h, w).permute(0, 1, 3, 4, 2),
                "rgb": rgb.reshape(b, k, 3, h, w).permute(0, 1, 3, 4, 2)}

    def _multiflow_composite(self, heads: dict, image_seq: torch.Tensor,
                             k: int) -> dict:
        """True-multiview synthesis: warp EVERY source frame into the
        target view with its own predicted flow, blend by the per-source
        confidence (softmax over sources, out-of-bounds sources excluded by
        a -30 logit bias inside the kernel), mask-gate against the rgb."""
        b, t, h, w, _ = image_seq.shape
        flow = heads["flow"]                                  # [B*K,T,2,H,W]
        dev = flow.device

        def per_source(x):                       # [B*K,T,H,W] -> [B,T,KHW]
            # contiguous: at K = 1 the reshape is a view of the strided x
            return x.reshape(b, k, t, h, w).transpose(1, 2) \
                .reshape(b, t, k * h * w).contiguous()
        xs = torch.arange(w, dtype=torch.float32, device=dev)
        ys = torch.arange(h, dtype=torch.float32, device=dev)
        out = self._blend_sources(
            heads, image_seq, per_source(xs + flow[:, :, 0]),
            per_source(ys[:, None] + flow[:, :, 1]),
            per_source(heads["conf"]), k)
        return {
            "view": out["view"],
            "warped": out["multi"],
            "mask": out["mask"],
            "rgb": out["rgb"],
            "flow": flow.reshape(b, k, t, 2, h, w).permute(0, 1, 2, 4, 5, 3),
            "flow_valid": out["any_valid"],
            "conf_weights": out["wts"],
        }

    def _multidepth_composite(self, heads: dict, image_seq: torch.Tensor,
                              src_poses: torch.Tensor,
                              tgt_poses: torch.Tensor) -> dict:
        """Multiview geometric synthesis: ONE predicted depth map per target
        reprojects into every source through that source's relative camera
        transform; the samples are blended by per-source confidence as in
        multiflow. Behind-camera reprojections (z <= eps) are excluded by a
        -30 logit bias folded into the confidence before the kernel, which
        adds the same bias for out-of-bounds coordinates. The mask head's
        target is ``geo_valid`` = any source in front AND in bounds, not the
        kernel's any_valid (which ignores z)."""
        b, t, h, w, _ = image_seq.shape
        k = tgt_poses.shape[1]
        depth = heads["depth"]                                 # [B*K, H, W]
        dev = depth.device
        # rel[b,k,t]: target camera (b,k) -> source camera (b,t), flattened
        # (B, K, T) row-major
        t_tgt = pose_ops.look_at_extrinsics(
            tgt_poses.reshape(b * k, -1)).reshape(b, k, 1, 4, 4)
        t_src = pose_ops.look_at_extrinsics(
            src_poses.reshape(b * t, -1)).reshape(b, 1, t, 4, 4)
        rel = pose_ops.relative_transform(
            t_src.expand(b, k, t, 4, 4),
            t_tgt.expand(b, k, t, 4, 4)).reshape(-1, 4, 4)
        focal = torch.full((b * k * t,), float(max(h, w)), device=dev)
        intr = pose_ops.intrinsics_matrix(focal, (w - 1) / 2.0,
                                          (h - 1) / 2.0)
        coords, z_ok = reproject_ops.reproject_coords(
            depth.to(torch.float32).repeat_interleave(t, dim=0), intr, rel)
        coords = coords.reshape(b, k, t, h, w, 2)
        z_ok = z_ok.reshape(b, k, t, h, w)
        inb = grid_sample.in_bounds(coords[..., 0], coords[..., 1], h, w)
        conf_z = heads["conf"].reshape(b, k, t, h, w) + (z_ok - 1.0) * 30.0

        def per_source(x):                       # [B,K,T,H,W] -> [B,T,KHW]
            # contiguous: at K = 1 the reshape is a view of the strided x
            return x.transpose(1, 2).reshape(b, t, k * h * w).contiguous()
        out = self._blend_sources(
            heads, image_seq, per_source(coords[..., 0]),
            per_source(coords[..., 1]), per_source(conf_z), k)
        return {"mask": out["mask"], "rgb": out["rgb"],
                "depth": depth.reshape(b, k, h, w),
                "geo_valid": (z_ok * inb).amax(2),
                "view": out["view"], "warped": out["multi"],
                "geo_view": out["multi"], "conf_weights": out["wts"]}
