#!/usr/bin/env python3
"""Smoke test of the PyTorch port (dynamic_multiview_3d_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repo root; needs one CUDA card

Phases, each fatal (nothing is caught; any failure exits non-zero):
  1. build the port's CUDA kernel from its source and print the build time
     and ptxas resource use;
  2. print the card's name and power limit (nvidia-smi);
  3. at the c2 serving shape (N = 128 images of 3 x 128 x 128), hold the
     warp + composite kernel against its plain PyTorch version in both
     precisions (1e-5), and time kernel, plain version and
     F.grid_sample(border, align_corners=True) — the library yardstick,
     which does the warp only — with CUDA events, beside the memory bound;
  4. hold the port's CUDA path against its CPU path on the tiny f32 config
     (TF32 off; 1e-4, the tolerance the CPU tests hold the port to JAX with);
  5. serve: a c2 Model.init_random (bf16) on the card answers 3 predict
     requests of B = 16, T = 1, K = 8 from the port's SyntheticScenes; the
     kernel's launch counter must rise by exactly 3; the third request's
     aux outputs are recomposited with the plain version (1e-5); then a
     window of 100 requests is timed: latency p50, p90 and views/s;
  6. print the kernels line, then the result line last.

Exits 1 with no result when no CUDA device is present, and fails at import
when run outside a checkout of the repo.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM data-sheet peaks (dense): HBM bandwidth and f32 (non-tensor-core)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def _timed_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def phase_build(build, name="warp_composite"):
    t0 = time.perf_counter()
    log = build.build(name)
    secs = time.perf_counter() - t0
    print(f"[build] {name} in {secs:.2f} s (nvcc {' '.join(build.NVCC_FLAGS)})")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {name}: {line.strip()}")
    build.load(name)


def phase_card() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print("[card] name, power limit (nvidia-smi):")
    print(line)
    return line


def phase_kernel(gs) -> dict:
    n, c, h, w = 128, 3, 128, 128
    p = h * w
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    img = uniform((n, c, h, w), -1.0, 1.0)
    # flows of up to 80 px: reach past every border, most pixels stay inside
    flow = uniform((n, 2, h, w), -80.0, 80.0)
    ix = (torch.arange(w, device=dev, dtype=torch.float32) + flow[:, 0]) \
        .reshape(n, p).contiguous()
    iy = (torch.arange(h, device=dev, dtype=torch.float32)[:, None]
          + flow[:, 1]).reshape(n, p).contiguous()
    mask = uniform((n, p), 0.0, 1.0)
    rgb = uniform((n, c, p), -1.0, 1.0)
    args = (img, ix, iy, mask, rgb, "border")

    errs = {}
    for precision in ("exact", "fast"):
        ours = gs.warp_composite_pix(*args, precision)
        torch.cuda.synchronize()
        ref = gs.warp_composite_pix_plain(*args, precision)
        err = max(float((o - r).abs().max()) for o, r in zip(ours, ref))
        print(f"[kernel] {precision}: max |kernel - plain| = {err!r} "
              f"(valid share {float(ours[2].mean()):.3f})")
        if not err <= 1e-5:
            raise AssertionError(f"kernel disagrees with plain ({precision}): "
                                 f"{err} > 1e-5")
        errs[precision] = err

    times = {}
    for precision in ("fast", "exact"):
        times[precision] = _timed_ms(
            lambda: gs.warp_composite_pix(*args, precision), 50)
    plain_ms = _timed_ms(lambda: gs.warp_composite_pix_plain(*args, "fast"), 10)
    grid = torch.stack([ix.reshape(n, h, w) * (2.0 / (w - 1)) - 1.0,
                        iy.reshape(n, h, w) * (2.0 / (h - 1)) - 1.0], dim=-1)
    library_ms = _timed_ms(lambda: F.grid_sample(
        img, grid, mode="bilinear", padding_mode="border",
        align_corners=True), 50)
    # each input read once, each output written once: img, ix, iy, mask,
    # rgb in; view, warped, valid out (f32)
    nbytes = 4 * (n * c * h * w + 3 * n * p + n * c * p + 2 * n * c * p + n * p)
    # per pixel ~20 flops of coordinates and weights, ~12 per channel
    flops = n * p * (20 + 12 * c)
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS \
        else "operations"
    print(f"[kernel] c2 shape N={n} C={c} {h}x{w}: kernel fast "
          f"{times['fast']!r} ms, exact {times['exact']!r} ms; plain (fast) "
          f"{plain_ms!r} ms; F.grid_sample (warp only) {library_ms!r} ms; "
          f"bound {bound_ms!r} ms ({nbytes} B at 3.35 TB/s)")
    return {"max_abs_err": max(errs.values()), "ms": times["fast"],
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_reference(config, Model, DMV3D, synthetic):
    cfg = config.override(config.Config(), [
        "model.image_size=32", "model.num_levels=3", "model.base_features=8",
        "model.max_features=16", "model.gru_features=16",
        "model.pose_embed_dim=8", "model.dtype=float32",
        "model.warp_precision=exact", "data.image_size=32"])
    cpu = Model.init_random(cfg, seed=123, device="cpu")
    module = DMV3D(cfg.model)
    module.load_state_dict(cpu.module.state_dict())
    gpu = Model(cfg, module.to("cuda").eval())
    rng = np.random.default_rng(0)
    seq = synthetic.smooth_images(rng, 2, 2, 32)
    poses = synthetic.random_poses(rng, 2, 5)
    ref = cpu.predict(seq, poses[:, 2:], source_poses=poses[:, :2],
                      return_aux=True)
    out = gpu.predict(seq, poses[:, 2:], source_poses=poses[:, :2],
                      return_aux=True)
    scale = {"flow": cfg.model.max_flow * cfg.model.image_size}
    errs = {k: float((out[k].cpu() - ref[k]).abs().max()) / scale.get(k, 1.0)
            for k in ref}
    print(f"[reference] tiny f32 config, CUDA vs CPU path (flow in units of "
          f"its range): {errs}")
    bad = {k: e for k, e in errs.items() if not e <= 1e-4}
    if bad:
        raise AssertionError(f"CUDA path disagrees with the CPU path: {bad}")


def phase_serve(config, Model, SyntheticScenes, gs) -> int:
    cfg = config.get_config("c2")
    b, k, hw = cfg.data.batch_size, cfg.data.num_targets, cfg.model.image_size
    t0 = time.perf_counter()
    model = Model.init_random(cfg, seed=0, device="cuda")
    scenes = SyntheticScenes(num_scenes=64, image_size=hw,
                             seq_len=cfg.data.seq_len, num_targets=k, seed=0)
    batches = [scenes.batch(range(i * b, (i + 1) * b)) for i in range(4)]
    print(f"[serve] c2 model ({sum(p.numel() for p in model.module.parameters())}"
          f" params, {cfg.model.dtype}, warp {cfg.model.warp_precision}) and "
          f"4 batches of B={b} K={k} in {time.perf_counter() - t0:.2f} s")

    def request(batch, aux=False):
        return model.predict(batch["image_seq"], batch["tgt_poses"],
                             source_poses=batch["src_poses"], return_aux=aux)

    request(batches[0])                       # warm-up (cuDNN plans, build)
    torch.cuda.synchronize()
    gs.warp_composite_pix.launches = 0
    outs = [request(batch, aux=(i == 2))
            for i, batch in enumerate(batches[1:])]
    torch.cuda.synchronize()
    launches = gs.warp_composite_pix.launches
    print(f"[serve] warp_composite launches over 3 requests: {launches}")
    if launches != 3:
        raise AssertionError(f"expected 3 kernel launches, saw {launches}")

    for view in outs[:2] + [outs[2]["view"]]:
        if tuple(view.shape) != (b, k, hw, hw, 3) or \
                not bool(torch.isfinite(view).all()):
            raise AssertionError(f"bad view: shape {tuple(view.shape)}")
    aux, batch = outs[2], batches[3]
    last = torch.as_tensor(batch["image_seq"][:, -1], device="cuda") \
        .repeat_interleave(k, dim=0)
    n = b * k
    view, warped, valid = gs.flow_warp_composite_plain(
        last, aux["flow"].reshape(n, hw, hw, 2),
        aux["mask"].reshape(n, hw, hw, 1), aux["rgb"].reshape(n, hw, hw, 3),
        precision=cfg.model.warp_precision)
    err = float((view.reshape(b, k, hw, hw, 3) - aux["view"]).abs().max())
    valid_same = bool(torch.equal(valid.reshape(b, k, hw, hw),
                                  aux["flow_valid"]))
    print(f"[serve] view vs plain recomposite from aux: max err {err!r}; "
          f"flow_valid identical: {valid_same}")
    if not (err <= 1e-5 and valid_same):
        raise AssertionError("served view disagrees with the plain version")

    requests = 100
    latencies = []
    t_window = time.perf_counter()
    for i in range(requests):
        t0 = time.perf_counter()
        request(batches[i % len(batches)])
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
    window = time.perf_counter() - t_window
    p50, p90, lo, hi = (float(x) for x in np.percentile(
        np.asarray(latencies) * 1e3, [50, 90, 0, 100]))
    print(f"[serve] {requests} requests in {window!r} s: latency p50 {p50!r} "
          f"ms, p90 {p90!r} ms, min {lo!r} ms, max {hi!r} ms; "
          f"{requests * b * k / window!r} views/s")
    phase_profile(lambda: request(batches[1]))
    return launches


def phase_profile(run):
    """Device time of one request by kernel (torch.profiler), and the
    device's busy share of the request's wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    timed = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    # kernels are events of their own; an operator's self device time
    # repeats theirs, so count operators only where no kernel event shows
    kernels = [e for e in timed
               if e.device_type == torch.autograd.DeviceType.CUDA] or timed
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"[profile] one c2 request: wall {wall_us:.1f} us (profiled), device "
          f"busy {busy_us:.1f} us ({100 * busy_us / wall_us:.1f}%), "
          f"{len(kernels)} kernel names")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"[profile] {e.self_device_time_total:10.1f} us "
              f"{100 * e.self_device_time_total / max(busy_us, 1e-9):5.1f}% "
              f"x{e.count:<4d} {e.key[:110]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this script needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dynamic_multiview_3d_torch import config
    from dynamic_multiview_3d_torch.data import synthetic
    from dynamic_multiview_3d_torch.api import Model
    from dynamic_multiview_3d_torch.kernels import _build
    from dynamic_multiview_3d_torch.kernels import grid_sample as gs
    from dynamic_multiview_3d_torch.models import DMV3D

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build(_build)
    phase_card()
    stats = phase_kernel(gs)
    phase_reference(config, Model, DMV3D, synthetic)
    launches = phase_serve(config, Model, synthetic.SyntheticScenes, gs)
    kernels = [dict(
        name="warp_composite_fwd", route="cuda",
        source="dynamic_multiview_3d_torch/csrc/warp_composite.cu",
        replaces="dynamic_multiview_3d_tpu/kernels/grid_sample_pallas.py:263",
        launches=launches, **stats)]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
