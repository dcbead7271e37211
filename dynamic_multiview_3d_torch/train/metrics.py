"""Quality metrics and the metric log (port of train/metrics.py).

PSNR and SSIM are the parity metrics. SSIM is Wang et al.'s with an 11x11
Gaussian window (sigma 1.5), K1 = 0.01, K2 = 0.03, as a depthwise VALID
convolution. ``MetricsWriter`` writes JSONL always, and TensorBoard
scalars and image grids when ``torch.utils.tensorboard`` imports (the JAX
package writes them when ``tensorflow`` does).
"""

from __future__ import annotations

import importlib.util
import json
import os
import time

import numpy as np
import torch
import torch.nn.functional as F


def psnr(pred: torch.Tensor, target: torch.Tensor,
         data_range: float = 2.0) -> torch.Tensor:
    """Peak SNR in dB; images in [-1, 1] have data_range 2."""
    mse = torch.mean((pred.to(torch.float32)
                      - target.to(torch.float32)) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5,
                     device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(pred: torch.Tensor, target: torch.Tensor,
         data_range: float = 2.0) -> torch.Tensor:
    """Mean SSIM over NHWC images ([N,H,W,C] or [B,K,H,W,C])."""
    if pred.dim() == 5:                                  # fold K
        pred = pred.reshape((-1,) + tuple(pred.shape[2:]))
        target = target.reshape((-1,) + tuple(target.shape[2:]))
    pred = pred.to(torch.float32).permute(0, 3, 1, 2)
    target = target.to(torch.float32).permute(0, 3, 1, 2)
    c = pred.shape[1]
    kern = _gaussian_kernel(device=pred.device)[None, None] \
        .expand(c, 1, 11, 11).contiguous()

    def filt(x):                                         # depthwise, VALID
        return F.conv2d(x, kern, groups=c)

    mu_p, mu_t = filt(pred), filt(target)
    mu_pp, mu_tt, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    sig_p = filt(pred * pred) - mu_pp
    sig_t = filt(target * target) - mu_tt
    sig_pt = filt(pred * target) - mu_pt
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    num = (2 * mu_pt + c1) * (2 * sig_pt + c2)
    den = (mu_pp + mu_tt + c1) * (sig_p + sig_t + c2)
    return torch.mean(num / den)


class MetricsWriter:
    """Append-only JSONL metric log, ``<logdir>/metrics.jsonl``, one
    ``{"step", "time", name: value, ...}`` record per ``write``; the same
    scalars, and image grids, as TensorBoard events in ``logdir`` when
    ``use_tensorboard`` and ``torch.utils.tensorboard`` imports."""

    def __init__(self, logdir: str, use_tensorboard: bool = True):
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:        # no tensorboard: JSONL alone
                pass
            else:
                self._tb = SummaryWriter(logdir)

    def write(self, step: int, metrics: dict) -> None:
        record = {"step": int(step), "time": time.time()}
        record.update({k: float(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), int(step))

    @property
    def has_tensorboard(self) -> bool:
        return self._tb is not None

    @property
    def has_images(self) -> bool:
        """TensorBoard is on and can encode images (torch's encoder needs
        PIL)."""
        return (self._tb is not None
                and importlib.util.find_spec("PIL") is not None)

    def write_images(self, step: int, tag: str, images: np.ndarray) -> None:
        """images uint8 [N,H,W,3]: pred-vs-target grids."""
        if self._tb is not None:
            self._tb.add_images(tag, images, int(step), dataformats="NHWC")

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
