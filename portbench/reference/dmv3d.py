"""Plain reference of the DMV3D model, in float32 with TF32 off.

A frozen copy of the architecture, written from its description and kept
apart from the program under test: it imports nothing of the program. The
weights are a ``{name: tensor}`` dict under the program's own parameter
names (``recurrent.encoder.down1.conv.weight``, OIHW convolutions, [out,
in] dense weights), so the benchmark hands the same tensors to both.

The trunk (encoder, ConvGRU, pose bottleneck, decoder) is here; the heads,
the view and the training loss of a synthesis mode are a module of their
own, ``synthesis/<name>.py``, found by the model config:
``synthesis_name`` gives ``<synthesis>``, with ``.predict_depth`` where
the config predicts depth and ``.<multi_head_mode>`` where its heads are
not shared. A new mode is a new file.

Layout NCHW inside; inputs and outputs as the public API has them:
``image_seq`` [B, T, H, W, 3] in [-1, 1], poses [B, T, 3] / [B, K, 3]
(azimuth, elevation, radius), views [B, K, H, W, 3].

Sampling is ``F.grid_sample`` (bilinear, border padding, corners aligned)
at the pixel coordinates the heads give; "fast" warp precision, bf16
convolutions and batch-invariant layers are the program's business: the
reference computes every operation in float32.

``quant``, where given, rounds what the configuration computes in
bfloat16: the input, the weight and the output of every convolution and
dense layer, and the source frames the warp samples (which the "fast"
warp rounds to bfloat16). The benchmark's control passes an fp8 round
trip here, to compute the reference one precision below the
configuration's; a bfloat16 round trip gives the reference at the
configuration's own precision, which a train step's check reads its
gradient error against.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from portbench import byname

POSE_DIMS = {"sincos": 8}


@contextlib.contextmanager
def exact_f32():
    """float32 matmuls and convolutions without TF32 while the block runs."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def features(m: dict, level: int) -> int:
    return min(m["base_features"] * 2 ** level, m["max_features"])


def num_groups(f: int) -> int:
    g = min(8, f)
    while f % g:
        g -= 1
    return g


def _same(kernel: int, stride: int, size: int) -> tuple[int, int]:
    """flax ``padding="SAME"``: the total split (total // 2, the rest)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def param_shapes(m: dict) -> dict:
    """Every parameter's name and shape for the model config ``m`` (the
    ``model`` section of a configuration), in a fixed order."""
    shapes = {}

    def conv(name, fin, fout, k, bias=True):
        shapes[f"{name}.weight"] = (fout, fin, k, k)
        if bias:
            shapes[f"{name}.bias"] = (fout,)

    def dense(name, fin, fout):
        shapes[f"{name}.weight"] = (fout, fin)
        shapes[f"{name}.bias"] = (fout,)

    def norm(name, f):
        shapes[f"{name}.scale"] = (f,)
        shapes[f"{name}.bias"] = (f,)

    def block(name, fin, fout, k=3):
        conv(f"{name}.conv", fin, fout, k)
        norm(f"{name}.norm", fout)

    levels, g = m["num_levels"], m["gru_features"]
    enc = "recurrent.encoder"
    block(f"{enc}.stem", 3, features(m, 0))
    for i in range(1, levels + 1):
        block(f"{enc}.down{i}", features(m, i - 1), features(m, i))
        block(f"{enc}.res{i}", features(m, i), features(m, i))
    bott = features(m, levels)
    conv("recurrent.gru.gates", g + bott, 2 * g, 3)
    conv("recurrent.gru.cand", g + bott, g, 3)
    e = m["pose_embed_dim"]
    dense("bottleneck.pose_fc1", POSE_DIMS[m["pose_mode"]], e)
    dense("bottleneck.pose_fc2", e, e)
    block("bottleneck.mix1", g + e, g, k=1)
    block("bottleneck.mix2", g, g)
    f_in = g
    for i in range(levels - 1, -1, -1):
        f = features(m, i)
        conv(f"decoder.up{i}_conv", f_in, 4 * f, m["up_kernel"])
        norm(f"decoder.up{i}_norm", f)
        conv(f"decoder.fuse{i}_x", f, f, 3)
        conv(f"decoder.fuse{i}_skip", f, f, 3, bias=False)
        norm(f"decoder.fuse{i}_norm", f)
        f_in = f
    synthesis(m).add_params(m, f_in, conv, dense)
    return shapes


def synthesis_name(m: dict) -> str:
    """The file name of the model config ``m``'s synthesis mode."""
    parts = [m["synthesis"]]
    if m["predict_depth"]:
        parts.append("predict_depth")
    if m["multi_head_mode"] != "shared":
        parts.append(m["multi_head_mode"])
    return ".".join(parts)


def synthesis(m: dict):
    """``synthesis/<synthesis_name(m)>.py``: the heads' parameters
    (``add_params``), the pose code the bottleneck and heads take
    (``pose_code``), the view (``view``) and the training loss
    (``loss``)."""
    return byname.load("reference/synthesis", synthesis_name(m))


def check_config(m: dict) -> None:
    """Raise on a trunk this reference does not implement (every preset
    of the port has this one)."""
    want = {"rnn": "gru", "pose_mode": "sincos", "norm": "group",
            "up_order": "d2s_first", "skip_fusion": "split"}
    bad = {k: m[k] for k, v in want.items() if m[k] != v}
    if bad:
        raise ValueError(f"the reference implements one trunk, not {bad}")


class Net:
    """The forward pass over a weight dict ``p`` for model config ``m``."""

    def __init__(self, m: dict, p: dict, quant=None):
        check_config(m)
        self.m, self.p = m, p
        self.q = quant or (lambda x: x)
        self.synth = synthesis(m)

    # -- layers ---------------------------------------------------------------
    def conv(self, name, x, stride=1):
        w = self.p[f"{name}.weight"]
        k = w.shape[-1]
        (t, b), (l, r) = (_same(k, stride, s) for s in x.shape[-2:])
        x = F.pad(self.q(x), (l, r, t, b))
        return self.q(F.conv2d(x, self.q(w), self.p.get(f"{name}.bias"),
                               stride))

    def dense(self, name, x):
        return self.q(F.linear(self.q(x), self.q(self.p[f"{name}.weight"]),
                               self.p[f"{name}.bias"]))

    def norm(self, name, x):
        return F.group_norm(x, num_groups(x.shape[1]), self.p[f"{name}.scale"],
                            self.p[f"{name}.bias"], eps=1e-5)

    def block(self, name, x, stride=1):
        return F.relu(self.norm(f"{name}.norm",
                                self.conv(f"{name}.conv", x, stride)))

    # -- model ----------------------------------------------------------------
    def encode(self, frame):
        enc, levels = "recurrent.encoder", self.m["num_levels"]
        x = self.block(f"{enc}.stem", frame)
        skips = [x]
        for i in range(1, levels + 1):
            x = self.block(f"{enc}.res{i}", self.block(f"{enc}.down{i}", x, 2))
            if i < levels:
                skips.append(x)
        return x, skips

    def gru(self, h, x):
        z, r = torch.sigmoid(self.conv("recurrent.gru.gates",
                                       torch.cat([h, x], 1))).chunk(2, 1)
        cand = torch.tanh(self.conv("recurrent.gru.cand",
                                    torch.cat([r * h, x], 1)))
        return (1.0 - z) * h + z * cand

    def bottleneck(self, h, code):
        emb = self.dense("bottleneck.pose_fc2",
                         F.relu(self.dense("bottleneck.pose_fc1", code)))
        if emb.dim() == 3:
            emb = emb.mean(1)
        n, _, hh, ww = h.shape
        x = torch.cat([h, emb[:, :, None, None].expand(n, emb.shape[1], hh, ww)],
                      1)
        return self.block("bottleneck.mix2", self.block("bottleneck.mix1", x))

    def decode(self, x, skips, k):
        for i in range(self.m["num_levels"] - 1, -1, -1):
            x = F.relu(self.norm(f"decoder.up{i}_norm", depth_to_space2(
                self.conv(f"decoder.up{i}_conv", x))))
            b = skips[i].shape[0]
            hx = self.conv(f"decoder.fuse{i}_x", x)
            hs = self.conv(f"decoder.fuse{i}_skip", skips[i])
            x = (hx.reshape(b, k, *hx.shape[1:]) + hs[:, None]).flatten(0, 1)
            x = F.relu(self.norm(f"decoder.fuse{i}_norm", x))
        return x

    def forward(self, image_seq, src_poses, tgt_poses) -> dict:
        """-> {"view" [B,K,H,W,3], "valid" [B,K,H,W] (the mask's
        target), "mask" [B,K,H,W], and what the synthesis mode's loss
        reads besides}."""
        m = self.m
        b, t, hh, ww, _ = image_seq.shape
        k = tgt_poses.shape[1]
        frames = image_seq.permute(1, 0, 4, 2, 3)             # [T,B,3,H,W]
        s = m["image_size"] // 2 ** m["num_levels"]
        h = image_seq.new_zeros(b, m["gru_features"], s, s)
        for ti in range(t):
            bott, skips = self.encode(frames[ti])
            h = self.gru(h, bott)
        code = self.synth.pose_code(src_poses, tgt_poses)
        z = self.bottleneck(h.repeat_interleave(k, 0), code)
        x = self.decode(z, skips, k)
        return self.synth.view(self, x, code, image_seq, src_poses, tgt_poses)


def nhwc(x, b, k):
    """[B*K, C, H, W] -> [B, K, H, W, C]."""
    return x.reshape(b, k, *x.shape[1:]).permute(0, 1, 3, 4, 2)


def depth_to_space2(x):
    """[N, 4C, H, W] -> [N, C, 2H, 2W], channels read as (dy, dx, c)."""
    n, c4, h, w = x.shape
    x = x.reshape(n, 2, 2, c4 // 4, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c4 // 4, 2 * h, 2 * w)


def in_bounds(ix, iy, h: int, w: int):
    return ((ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)).to(ix.dtype)


def bilinear_border(img, ix, iy):
    """``img`` [N, C, H, W] sampled bilinearly at pixel coordinates ix, iy
    [N, H', W'] with border padding -> [N, C, H', W']."""
    h, w = img.shape[-2:]
    grid = torch.stack([ix * (2.0 / (w - 1)) - 1.0,
                        iy * (2.0 / (h - 1)) - 1.0], -1)
    return F.grid_sample(img, grid, mode="bilinear", padding_mode="border",
                         align_corners=True)


def encode_view_pair(src, tgt):
    """(az, el, r) pairs -> sin/cos of the azimuth change, sin/cos of both
    elevations, both radii: [..., 8]."""
    d = tgt[..., 0] - src[..., 0]
    return torch.stack([torch.sin(d), torch.cos(d),
                        torch.sin(src[..., 1]), torch.cos(src[..., 1]),
                        torch.sin(tgt[..., 1]), torch.cos(tgt[..., 1]),
                        src[..., 2], tgt[..., 2]], -1)


def look_at(pose):
    """World -> camera [..., 4, 4] of a camera at (az, el, r) on a sphere
    looking at the origin: +z forward, +x right, +y down, world up +z."""
    az, el, r = pose[..., 0], pose[..., 1], pose[..., 2]
    eye = torch.stack([r * torch.cos(el) * torch.cos(az),
                       r * torch.cos(el) * torch.sin(az), r * torch.sin(el)], -1)
    fwd = -eye / (torch.linalg.vector_norm(eye, dim=-1, keepdim=True) + 1e-9)
    up = torch.zeros_like(fwd)
    up[..., 2] = 1.0
    right = torch.linalg.cross(fwd, up, dim=-1)
    right = right / (torch.linalg.vector_norm(right, dim=-1, keepdim=True)
                     + 1e-9)
    down = torch.linalg.cross(fwd, right, dim=-1)
    rot = torch.stack([right, down, fwd], -2)
    out = torch.zeros(*pose.shape[:-1], 4, 4, dtype=pose.dtype,
                      device=pose.device)
    out[..., :3, :3] = rot
    out[..., :3, 3] = -(rot @ eye[..., None])[..., 0]
    out[..., 3, 3] = 1.0
    return out


def relative_transform(src_w2c, tgt_w2c):
    """Target camera -> source camera: src_w2c @ inverse(tgt_w2c)."""
    return src_w2c @ torch.linalg.inv(tgt_w2c)


def reproject(depth, rel, focal: float, cx: float, cy: float):
    """Each target pixel, at its depth, seen from each source camera:
    depth [B, K, 1, H, W], rel [B, K, T, 4, 4] -> source pixel coordinates
    ix, iy and 1.0 where the point lies in front of the source (z > 1e-6),
    each [B, K, T, H, W]. A point behind divides by 1 instead of its z."""
    h, w = depth.shape[-2:]
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=depth.dtype, device=depth.device),
        torch.arange(w, dtype=depth.dtype, device=depth.device), indexing="ij")
    pts = torch.stack([(xs - cx) / focal * depth, (ys - cy) / focal * depth,
                       depth.expand(*depth.shape)], -1)       # [B,K,1,H,W,3]
    rot = rel[..., None, None, :3, :3]                        # [B,K,T,1,1,3,3]
    src = (rot @ pts[..., None])[..., 0] + rel[..., None, None, :3, 3]
    z = src[..., 2]
    ok = (z > 1e-6).to(depth.dtype)
    z = torch.where(z > 1e-6, z, torch.ones_like(z))
    return (focal * src[..., 0] / z + cx, focal * src[..., 1] / z + cy, ok)


def _fp8(x, dtype, largest: float):
    """``x`` rounded to the fp8 format ``dtype`` with one scale per tensor,
    its largest magnitude to the format's ``largest``."""
    amax = x.abs().amax()
    scale = torch.where(amax > 0, largest / amax, torch.ones_like(amax))
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8RoundTrip(torch.autograd.Function):
    """Forward in float8 e4m3, the gradient in float8 e5m2: the formats of
    fp8 training."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, grad):
        return _fp8(grad, torch.float8_e5m2, 57344.0)


def fp8_round_trip(x):
    """``x`` as an fp8 path holds it: the precision one below bfloat16
    that the control computes in, forward and backward."""
    return _Fp8RoundTrip.apply(x)


class _Bf16RoundTrip(torch.autograd.Function):
    """Forward and gradient rounded to bfloat16."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(torch.bfloat16).to(grad.dtype)


def bf16_round_trip(x):
    """``x`` as a bfloat16 path holds it, forward and backward: the
    configuration's own precision, the yardstick a train step's gradient
    error is read against."""
    return _Bf16RoundTrip.apply(x)


def fan_in(shape) -> int:
    return math.prod(shape[1:]) if len(shape) > 1 else 1
