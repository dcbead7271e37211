#!/usr/bin/env python3
"""Smoke test of the PyTorch port (dynamic_multiview_3d_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repo root; needs one CUDA card

Phases, each fatal (nothing is caught; any failure exits non-zero):
  1. build the port's CUDA kernels from their sources (one nvcc per source,
     all started together) and print the build times and ptxas resource use;
  2. print the card's name and power limit (nvidia-smi);
  3. [kernel] at the c2 shape (N = 128 images of 3 x 128 x 128), hold the
     forward warp + composite kernel against its plain PyTorch version in
     both precisions (1e-5), and time kernel, plain version and
     F.grid_sample(border, align_corners=True) — the library yardstick,
     which does the warp only — with CUDA events, beside the memory bound;
  4. [reference] hold the port's CUDA path against its CPU path on the tiny
     f32 config (TF32 off; 1e-4, the tolerance the CPU tests hold the port
     to JAX with);
  5. [serve] a c2 Model.init_random (bf16) on the card answers 3 predict
     requests of B = 16, T = 1, K = 8 from the port's SyntheticScenes; the
     forward kernel's launch counter must rise by exactly 3 (the backward's
     by 0); the third request's aux outputs are recomposited with the plain
     version (1e-5); then a window of 100 requests is timed: latency p50,
     p90 and views/s; one request is profiled;
  6. [kernel-bwd] on the inputs of phase 3, hold the backward kernel against
     the plain backward in both precisions: with d_img, with and without the
     warped cotangent, and without d_img or the warped cotangent (the
     training path's launch): d_ix, d_iy, d_mask, d_rgb to 1e-5 (bitwise
     expected), d_img (atomics, run-dependent order) to 1e-5 of its largest
     magnitude; time
     it with d_img off (the training path) and on, the plain backward and
     the backward of F.grid_sample beside the memory bound;
  7. [train-reference] one train step of the tiny f32 config on CUDA and on
     the CPU from the same weights and batch: loss 1e-5 relative, every
     gradient 1e-4 in relative L2 (the two zero-gradient biases: 1e-6 of
     the global gradient norm), as the CPU tests hold the port to JAX;
  8. [train] c2 init_state (bf16, Adam 2e-4) takes 3 steps on uint8 batches
     of B = 16, K = 8: both kernels' launch counters must rise by exactly 3,
     with no d_img; then a window of 60 steps on one batch is timed (step
     p50, p90, steps/s, target views/s) and its loss must fall; one step is
     profiled;
  9. print the kernels line, then the result line last.

Exits 1 with no result when no CUDA device is present, and fails at import
when run outside a checkout of the repo.
"""

from __future__ import annotations

import concurrent.futures
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


KERNEL_SOURCES = ("warp_composite", "warp_composite_bwd")


def phase_build(build):
    def one(name):
        t0 = time.perf_counter()
        log = build.build(name)
        return name, time.perf_counter() - t0, log

    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        results = list(pool.map(one, KERNEL_SOURCES))
    for name, secs, log in results:
        print(f"[build] {name} in {secs:.2f} s (nvcc "
              f"{' '.join(build.NVCC_FLAGS)})")
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


def _kernel_inputs():
    """The warp's inputs at the c2 shape, from seed 0: image, coordinates,
    mask, rgb."""
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
    return img, ix, iy, mask, rgb


def _grid(ix, iy, h, w):
    """Pixel coordinates as F.grid_sample's normalized grid (align_corners)."""
    n = ix.shape[0]
    return torch.stack([ix.reshape(n, h, w) * (2.0 / (w - 1)) - 1.0,
                        iy.reshape(n, h, w) * (2.0 / (h - 1)) - 1.0], dim=-1)


def _bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def phase_kernel(gs) -> dict:
    img, ix, iy, mask, rgb = _kernel_inputs()
    n, c, h, w = img.shape
    p = h * w
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
    grid = _grid(ix, iy, h, w)
    library_ms = _timed_ms(lambda: F.grid_sample(
        img, grid, mode="bilinear", padding_mode="border",
        align_corners=True), 50)
    # each input read once, each output written once: img, ix, iy, mask,
    # rgb in; view, warped, valid out (f32)
    nbytes = 4 * (n * c * h * w + 3 * n * p + n * c * p + 2 * n * c * p + n * p)
    # per pixel ~20 flops of coordinates and weights, ~12 per channel
    bound_ms, bound_by = _bound(nbytes, n * p * (20 + 12 * c))
    print(f"[kernel] c2 shape N={n} C={c} {h}x{w}: kernel fast "
          f"{times['fast']!r} ms, exact {times['exact']!r} ms; plain (fast) "
          f"{plain_ms!r} ms; F.grid_sample (warp only) {library_ms!r} ms; "
          f"bound {bound_ms!r} ms ({nbytes} B at 3.35 TB/s)")
    return {"max_abs_err": max(errs.values()), "ms": times["fast"],
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def _tiny_config(config):
    """The tiny f32 config the CPU tests hold the port to JAX with."""
    return config.override(config.Config(), [
        "model.image_size=32", "model.num_levels=3", "model.base_features=8",
        "model.max_features=16", "model.gru_features=16",
        "model.pose_embed_dim=8", "model.dtype=float32",
        "model.warp_precision=exact", "data.image_size=32"])


def phase_reference(config, Model, DMV3D, synthetic):
    cfg = _tiny_config(config)
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


def c2_batches(config, synthetic):
    """4 c2 batches (B = 16, T = 1, K = 8) of uint8 images from the port's
    SyntheticScenes, seed 0."""
    cfg = config.get_config("c2")
    b = cfg.data.batch_size
    t0 = time.perf_counter()
    scenes = synthetic.SyntheticScenes(
        num_scenes=64, image_size=cfg.model.image_size,
        seq_len=cfg.data.seq_len, num_targets=cfg.data.num_targets, seed=0)
    batches = [scenes.batch(range(i * b, (i + 1) * b), raw=True)
               for i in range(4)]
    print(f"[data] 4 c2 batches of B={b} K={cfg.data.num_targets} rendered "
          f"in {time.perf_counter() - t0:.2f} s")
    return batches


def phase_serve(config, Model, synthetic, gs, raw_batches) -> tuple:
    cfg = config.get_config("c2")
    b, k, hw = cfg.data.batch_size, cfg.data.num_targets, cfg.model.image_size
    t0 = time.perf_counter()
    model = Model.init_random(cfg, seed=0, device="cuda")
    batches = [dict(raw, image_seq=synthetic.to_model(raw["image_seq"]),
                    tgt_images=synthetic.to_model(raw["tgt_images"]))
               for raw in raw_batches]
    print(f"[serve] c2 model ({sum(p.numel() for p in model.module.parameters())}"
          f" params, {cfg.model.dtype}, warp {cfg.model.warp_precision}) in "
          f"{time.perf_counter() - t0:.2f} s")

    def request(batch, aux=False):
        return model.predict(batch["image_seq"], batch["tgt_poses"],
                             source_poses=batch["src_poses"], return_aux=aux)

    request(batches[0])                       # warm-up (cuDNN plans, build)
    torch.cuda.synchronize()
    gs.warp_composite_pix.launches = 0
    gs.warp_composite_pix_bwd.launches = 0
    outs = [request(batch, aux=(i == 2))
            for i, batch in enumerate(batches[1:])]
    torch.cuda.synchronize()
    launches = gs.warp_composite_pix.launches
    bwd_launches = gs.warp_composite_pix_bwd.launches
    print(f"[serve] launches over 3 requests: warp_composite {launches}, "
          f"warp_composite_bwd {bwd_launches}")
    if (launches, bwd_launches) != (3, 0):
        raise AssertionError(f"expected 3 forward and 0 backward kernel "
                             f"launches, saw {launches} and {bwd_launches}")

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
    phase_profile(lambda: request(batches[1]), "one c2 request")
    return launches, bwd_launches


def phase_kernel_bwd(gs) -> dict:
    img, ix, iy, mask, rgb = _kernel_inputs()
    n, c, h, w = img.shape
    p = h * w
    g = torch.Generator(device="cuda").manual_seed(1)
    d_view = torch.randn(rgb.shape, generator=g, device="cuda")
    d_warped = torch.randn(rgb.shape, generator=g, device="cuda")
    args = (img, ix, iy, mask, rgb)

    errs = []
    # (need_img, d_warped): the last is the training path's launch
    variants = ((True, None), (True, d_warped), (False, None))
    for precision in ("exact", "fast"):
        for need_img, dw in variants:
            ours = gs.warp_composite_pix_bwd(*args, d_view, dw, "border",
                                             precision, need_img=need_img)
            torch.cuda.synchronize()
            ref = gs.warp_composite_pix_bwd_plain(*args, d_view, dw,
                                                  "border", precision,
                                                  need_img=need_img)
            err = max(float((o - r).abs().max())
                      for o, r in zip(ours[1:], ref[1:]))
            if need_img:
                img_scale = max(1.0, float(ref[0].abs().max()))
                img_err = float((ours[0] - ref[0]).abs().max()) / img_scale
                img_note = f"d_img {img_err!r} of its largest |value| " \
                    f"{img_scale!r}"
            else:
                img_err = 0.0 if ours[0] is None else float("inf")
                img_note = f"d_img {'None' if ours[0] is None else 'returned'}"
            print(f"[kernel-bwd] {precision}, d_img "
                  f"{'on' if need_img else 'off'}, d_warped "
                  f"{'given' if dw is not None else 'None'}: max |kernel - "
                  f"plain| over d_ix, d_iy, d_mask, d_rgb = {err!r}; "
                  f"{img_note}")
            if not (err <= 1e-5 and img_err <= 1e-5):
                raise AssertionError(
                    f"backward kernel disagrees with plain ({precision}, "
                    f"need_img {need_img}): {err}, d_img {img_err}")
            errs.append(err)

    def kernel(precision, need_img):
        return lambda: gs.warp_composite_pix_bwd(
            *args, d_view, None, "border", precision, need_img=need_img)
    times = {(prec, img_on): _timed_ms(kernel(prec, img_on), 50)
             for prec in ("fast", "exact") for img_on in (False, True)}
    plain_ms = _timed_ms(lambda: gs.warp_composite_pix_bwd_plain(
        *args, d_view, None, "border", "fast", need_img=False), 10)
    grid = _grid(ix, iy, h, w).requires_grad_(True)
    out = F.grid_sample(img, grid, mode="bilinear", padding_mode="border",
                        align_corners=True)
    d_out = d_view.reshape(n, c, h, w)
    library_ms = _timed_ms(lambda: torch.autograd.grad(
        out, grid, d_out, retain_graph=True), 50)
    # each input read once, each output written once: img, ix, iy, mask,
    # rgb, d_view in; d_ix, d_iy, d_mask, d_rgb out (f32); d_img adds its
    # own [N, C, H, W] output
    nbytes = 4 * (n * c * h * w + 3 * n * p + 2 * n * c * p + 3 * n * p
                  + n * c * p)
    # per pixel ~30 flops of coordinates, weights and subgradients, ~35
    # per channel
    bound_ms, bound_by = _bound(nbytes, n * p * (30 + 35 * c))
    bound_img_ms, _ = _bound(nbytes + 4 * n * c * h * w, n * p * (30 + 43 * c))
    print(f"[kernel-bwd] c2 shape N={n} C={c} {h}x{w}, no d_warped: kernel "
          f"without d_img fast {times['fast', False]!r} ms, exact "
          f"{times['exact', False]!r} ms; with d_img fast "
          f"{times['fast', True]!r} ms, exact {times['exact', True]!r} ms; "
          f"plain (fast, no d_img) {plain_ms!r} ms; F.grid_sample backward "
          f"(grid only) {library_ms!r} ms; bound {bound_ms!r} ms ({nbytes} "
          f"B at 3.35 TB/s), with d_img {bound_img_ms!r} ms")
    return {"max_abs_err": max(errs), "ms": times["fast", False],
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


# the tiny config's biases whose true gradient is zero: each feeds a
# GroupNorm with one channel per group, which subtracts it again
ZERO_GRAD = ("recurrent.encoder.stem.conv.bias", "decoder.fuse0_x.bias")


def phase_train_reference(config, synthetic, tstep):
    cfg = config.override(_tiny_config(config), ["data.batch_size=2"])
    rng = np.random.default_rng(0)
    batch = {"image_seq": synthetic.smooth_images(rng, 2, 1, 32),
             "src_poses": synthetic.random_poses(rng, 2, 1),
             "tgt_poses": synthetic.random_poses(rng, 2, 3),
             "tgt_images": synthetic.smooth_images(rng, 2, 3, 32)}
    runs = {}
    for dev in ("cpu", "cuda"):
        state = tstep.init_state(cfg, seed=123, device=dev)
        _, metrics = tstep.make_train_step(cfg, device=dev)(state, batch)
        runs[dev] = (metrics["loss/total"],
                     {n: q.grad.detach().cpu().double()
                      for n, q in state.module.named_parameters()})
    (loss_ref, ref), (loss, ours) = runs["cpu"], runs["cuda"]
    norm = float(torch.sqrt(sum((g * g).sum() for g in ref.values())))
    loss_err = abs(loss - loss_ref) / abs(loss_ref)
    rel, zero, bad = {}, {}, {}
    for name, r in ref.items():
        err = float((ours[name] - r).norm())
        if name in ZERO_GRAD:
            zero[name] = err / norm
            ok = err <= 1e-6 * norm
        else:
            rel[name] = err / float(r.norm())
            ok = rel[name] <= 1e-4
        if not ok:
            bad[name] = err
    worst = max(rel, key=rel.get)
    print(f"[train-reference] tiny f32 config, one train step, CUDA vs CPU: "
          f"loss {loss!r} vs {loss_ref!r} ({loss_err!r} relative); "
          f"{len(rel)} gradients, max relative L2 {rel[worst]!r} ({worst}); "
          f"zero-gradient biases / global norm {zero}")
    if not (loss_err <= 1e-5 and not bad):
        raise AssertionError(f"CUDA train step disagrees with the CPU one: "
                             f"loss {loss_err}, gradients {bad}")


def phase_train(config, tstep, gs, raw_batches) -> dict:
    cfg = config.get_config("c2")
    b, k = cfg.data.batch_size, cfg.data.num_targets
    t0 = time.perf_counter()
    state = tstep.init_state(cfg, seed=0, device="cuda")
    step = tstep.make_train_step(cfg, device="cuda")
    t = cfg.train
    print(f"[train] c2 state ({sum(q.numel() for q in state.module.parameters())}"
          f" params, {cfg.model.dtype}, warp {cfg.model.warp_precision}, "
          f"{t.optimizer} lr {t.lr} {t.lr_schedule}, targets_per_step "
          f"{cfg.data.targets_per_step}) in {time.perf_counter() - t0:.2f} s")
    step(state, raw_batches[0])               # warm-up (cuDNN plans)
    torch.cuda.synchronize()

    fwd, bwd = gs.warp_composite_pix, gs.warp_composite_pix_bwd
    fwd.launches = bwd.launches = bwd.img_launches = 0
    losses = [step(state, batch)[1]["loss/total"] for batch in raw_batches[1:]]
    torch.cuda.synchronize()
    counts = {"fwd": fwd.launches, "bwd": bwd.launches,
              "bwd_img": bwd.img_launches}
    print(f"[train] launches over 3 steps: warp_composite {counts['fwd']}, "
          f"warp_composite_bwd {counts['bwd']} (with d_img "
          f"{counts['bwd_img']}); losses {losses}")
    if (counts["fwd"], counts["bwd"], counts["bwd_img"]) != (3, 3, 0):
        raise AssertionError(f"expected 3 forward and 3 backward launches "
                             f"without d_img, saw {counts}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")

    steps = 60
    torch.cuda.reset_peak_memory_stats()
    times, window_losses = [], []
    t_window = time.perf_counter()
    for _ in range(steps):
        t0 = time.perf_counter()
        _, metrics = step(state, raw_batches[0])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        window_losses.append(metrics["loss/total"])
    window = time.perf_counter() - t_window
    p50, p90, lo, hi = (float(x) for x in np.percentile(
        np.asarray(times) * 1e3, [50, 90, 0, 100]))
    print(f"[train] {steps} steps on one batch in {window!r} s: step p50 "
          f"{p50!r} ms, p90 {p90!r} ms, min {lo!r} ms, max {hi!r} ms; "
          f"{steps / window!r} steps/s, {steps * b * k / window!r} target "
          f"views/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    print(f"[train] loss over the window: first {window_losses[0]!r}, last "
          f"{window_losses[-1]!r}")
    if not window_losses[-1] < window_losses[0]:
        raise AssertionError("the loss did not fall over the window")
    phase_profile(lambda: step(state, raw_batches[0]), "one c2 train step")
    return counts


def phase_profile(run, what):
    """Device time of one call by kernel (torch.profiler), and the device's
    busy share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    timed = [e for e in prof.key_averages() if e.self_device_time_total > 0
             and not getattr(e, "is_user_annotation", False)]
    # kernels are events of their own; an operator's self device time
    # repeats theirs, and so does a user annotation's range on the device
    # timeline (Optimizer.step): count operators only where no kernel
    # event shows, and annotations never
    kernels = [e for e in timed
               if e.device_type == torch.autograd.DeviceType.CUDA] or timed
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"[profile] {what}: wall {wall_us:.1f} us (profiled), device "
          f"busy {busy_us:.1f} us ({100 * busy_us / wall_us:.1f}%), "
          f"{len(kernels)} kernel names")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    # the top 15, then the port's own kernels wherever they rank
    for e in ranked[:15] + [e for e in ranked[15:]
                            if "warp_composite" in e.key]:
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
    from dynamic_multiview_3d_torch.train import step as tstep

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build(_build)
    phase_card()
    stats = phase_kernel(gs)
    phase_reference(config, Model, DMV3D, synthetic)
    raw_batches = c2_batches(config, synthetic)
    served = phase_serve(config, Model, synthetic, gs, raw_batches)
    stats_bwd = phase_kernel_bwd(gs)
    phase_train_reference(config, synthetic, tstep)
    trained = phase_train(config, tstep, gs, raw_batches)
    # launches: the train step's count (this slice's main path); the serve
    # path's count beside it
    kernels = [
        dict(name="warp_composite_fwd", route="cuda",
             source="dynamic_multiview_3d_torch/csrc/warp_composite.cu",
             replaces="dynamic_multiview_3d_tpu/kernels/"
                      "grid_sample_pallas.py:263",
             launches=trained["fwd"],
             launches_by_path={"serve": served[0], "train": trained["fwd"]},
             **stats),
        dict(name="warp_composite_bwd", route="cuda",
             source="dynamic_multiview_3d_torch/csrc/warp_composite_bwd.cu",
             replaces="dynamic_multiview_3d_tpu/kernels/"
                      "grid_sample_pallas.py:281",
             launches=trained["bwd"],
             launches_by_path={"serve": served[1], "train": trained["bwd"]},
             **stats_bwd)]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
