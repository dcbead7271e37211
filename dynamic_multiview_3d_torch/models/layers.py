"""Building-block layers (port of models/layers.py).

NCHW inside (PyTorch's convolution layout); parameters stay float32 and each
layer computes in its ``dtype`` (bf16 by default in the model), the way flax's
``dtype=`` does: inputs, weights and bias are cast to it, and on the GPU cuDNN
accumulates in f32.

Two traps of the flax original are reproduced exactly:
- ``padding="SAME"`` pads ``total = max((out-1)*stride + k - size, 0)`` as
  ``(total // 2, total - total // 2)``: a 3x3 stride-2 conv on an even size
  pads (0, 1), the 2x2 up-conv pads (0, 1), a 3x3 stride-1 conv (1, 1).
  torch's symmetric ``padding=1`` differs at stride 2.
- ``depth_to_space2`` reads channels as (dy, dx, c); ``F.pixel_shuffle``
  reads (c, dy, dx).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _num_groups(features: int) -> int:
    g = min(8, features)
    while features % g:
        g -= 1
    return g


def _same_pads(kernel: int, stride: int, size: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), strides, padding="SAME")`` in NCHW.

    ``weight`` is OIHW (flax's HWIO kernel transposed), ``bias`` optional.
    """

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int = 1, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        self.weight = nn.Parameter(
            torch.zeros(features, in_features, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv(x, self.bias)

    def _conv(self, x: torch.Tensor, bias) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        (t, b), (l, r) = (_same_pads(self.kernel, self.stride, s)
                          for s in x.shape[-2:])
        bias = None if bias is None else bias.to(dt)
        if t == b and l == r:
            return F.conv2d(x, self.weight.to(dt), bias, self.stride, (t, l))
        return F.conv2d(F.pad(x, (l, r, t, b)), self.weight.to(dt), bias,
                        self.stride)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``weight`` is [out, in] (flax's kernel transposed)."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class FastGroupNorm(nn.Module):
    """GroupNorm with the JAX package's recipe: statistics in f32, eps 1e-5
    (torch's default, not flax's 1e-6), and the group stats folded with the
    channel affine into one scale/shift per (n, c), cast to the compute
    dtype. The variance is the JAX package's ``E[x²] - E[x]²`` computed in
    two passes (``var_mean``): the same function, without the one-pass
    cancellation where a group's mean is large beside its spread, which
    in f32 put the ConvLSTM model's outputs up to 1.4e-4 from the exact
    (f64) answer (tests/test_torch_model.py)."""

    def __init__(self, num_groups: int, features: int,
                 dtype: torch.dtype = torch.float32, epsilon: float = 1e-5):
        super().__init__()
        self.num_groups, self.dtype, self.epsilon = num_groups, dtype, epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[:2]
        g = self.num_groups
        xf = x.reshape(n, g, -1).to(torch.float32)   # channel groups, NCHW
        var, mean = torch.var_mean(xf, -1, correction=0)        # [n, g]
        inv = torch.rsqrt(var + self.epsilon)
        s = inv[:, :, None] * self.scale.reshape(g, -1)[None]   # [n, g, c/g]
        b = self.bias.reshape(g, -1)[None] - mean[:, :, None] * s
        shape = (n, c) + (1,) * (x.dim() - 2)
        s = s.reshape(shape).to(self.dtype)
        b = b.reshape(shape).to(self.dtype)
        return x.to(self.dtype) * s + b


class ConvBlock(nn.Module):
    """Conv -> GroupNorm -> relu, the encoder/decoder workhorse."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 kernel: int = 3, norm: str = "group",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv(in_features, features, kernel, stride, dtype=dtype)
        self.norm = (FastGroupNorm(_num_groups(features), features, dtype)
                     if norm == "group" else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return F.relu(x)


class ConvGRUCell(nn.Module):
    """Convolutional GRU: gates over ``[h, x]``; ``r * h`` enters the
    candidate conv."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.gates = Conv(features + in_features, 2 * features, kernel,
                          dtype=dtype)
        self.cand = Conv(features + in_features, features, kernel,
                         dtype=dtype)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        gates = self.gates(torch.cat([h, x], dim=1))
        z, r = gates.chunk(2, dim=1)
        z = torch.sigmoid(z)
        r = torch.sigmoid(r)
        cand = torch.tanh(self.cand(torch.cat([r * h, x], dim=1)))
        return (1.0 - z) * h + z * cand

    @staticmethod
    def init_state(batch: int, height: int, width: int, features: int,
                   dtype: torch.dtype = torch.float32, device=None):
        return torch.zeros((batch, features, height, width), dtype=dtype,
                           device=device)


class ConvLSTMCell(nn.Module):
    """Convolutional LSTM; state is (h, c) packed along channels; the forget
    gate gets a +1 bias."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.gates = Conv(features + in_features, 4 * features, kernel,
                          dtype=dtype)

    def forward(self, state: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        h, c = state.chunk(2, dim=1)
        gates = self.gates(torch.cat([h, x], dim=1))
        i, f, g, o = gates.chunk(4, dim=1)
        i = torch.sigmoid(i)
        f = torch.sigmoid(f + 1.0)
        g = torch.tanh(g)
        o = torch.sigmoid(o)
        c = f * c + i * g
        h = o * torch.tanh(c)
        return torch.cat([h, c], dim=1)

    @staticmethod
    def init_state(batch: int, height: int, width: int, features: int,
                   dtype: torch.dtype = torch.float32, device=None):
        return torch.zeros((batch, 2 * features, height, width), dtype=dtype,
                           device=device)

    @staticmethod
    def hidden(state: torch.Tensor, features: int) -> torch.Tensor:
        return state[:, :features]


def depth_to_space2(x: torch.Tensor) -> torch.Tensor:
    """[N, 4C, H, W] -> [N, C, 2H, 2W] with channel phase order (dy, dx, c)."""
    n, c4, h, w = x.shape
    c = c4 // 4
    x = x.reshape(n, 2, 2, c, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c, 2 * h, 2 * w)
