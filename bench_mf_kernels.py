#!/usr/bin/env python3
"""Time the port's redesigned gather kernels of this checkout against those
of another checkout of the repo, on one NVIDIA GPU.

    python3 bench_mf_kernels.py [--parent DIR]
                                [--cases warp,mf,sample,reproject,
                                         reproject_bwd,c2,c2d,draw]
                                [--repeats N] [--out FILE]

Cases (all by default):
  warp           the flow warp + composite #1 (forward) and #3's training
                 launch (d_view, no d_warped, no d_img) at the c2 shape
                 (chip_smoke.py's [kernel] inputs: 128 targets of 3 x 128 x
                 128, 80 px flows): on 16 shared channels-last frames, each
                 read by its K = 8 targets (flow synthesis's layout since
                 the frames are shared), where the checkout takes them, and
                 on one contiguous copy of the frame per target (128
                 images); the backward on the image as the checkout's
                 autograd op keeps it (staged, where the checkout stages);
                 and the model's per-target copy of the frames itself
                 (repeat_interleave);
  mf             the multi-source kernels #4 (forward) and #5 (backward,
                 the multidepth launch: d_multi, no d_wts, no d_imgs) at
                 the c3md shape (chip_smoke.py's [kernel-mf] inputs: N = 8,
                 T = 8 sources of 3 x 128 x 128, K = 2; flows of up to 80 px
                 and of up to 2 px), on channels-last frames (NHWC frames
                 permuted, as the model passes them) where the checkout
                 takes them, and on contiguous frames;
  sample         the plain sampler #2 at the c2d shape (chip_smoke.py's
                 [kernel-sample] inputs: 16 frames of 3 x 128 x 128, each
                 sampled at the pixels of its K = 8 targets, 80 px flows):
                 on the shared channels-last frames (depth synthesis's
                 layout) where the checkout takes them, and on one
                 contiguous copy of the frame per target (128 images);
  reproject      the depth reprojection kernels #6 (sample) and #7
                 (composite) at the c2 shape on c2 cameras, on the smooth
                 and on the random depth (chip_smoke.py's
                 [kernel-reproject] inputs): on the 16 shared frames
                 channels-last (the NHWC frames, as a checkout's model
                 passes them where it does not stage them: a wrapper that
                 stages copies them first) and staged as [16, H, W, 4]
                 (``_build.stage``, as a model that stages passes them:
                 the copy excluded, since on c2g #1 has paid it);
                 F.grid_sample of the frames (zeros) at the same
                 coordinates beside them;
  reproject_bwd  the fused depth backward's sample launch (d_geo: the c2g
                 step's) and composite launch (d_view, d_geo: the c2d
                 step's), no d_img, at the c2 shape on c2 cameras and the
                 smooth depth (chip_smoke.py's [kernel-reproject-bwd]
                 inputs), on the shared frames and on the per-target copy,
                 each as the checkout's autograd op keeps it for the
                 backward;
  draw           the device draw of one c3md step (``ResidentFrames.
                 device_draw`` at chip_smoke.py's C3MD_DRAW_META, the
                 [loop-c3md] bank: B = 8 examples, T = 8 of V = 8 views,
                 K = 2, step 15's key; a checkout from before
                 ``utils/jax_random.py`` cannot run it): its device time, the kernels it launches (under
                 torch.profiler) and a call's time with CUDA events (the
                 host's issue time shows where it exceeds the device's),
                 each checkout's draw held to its own CPU draw, bitwise;
  c2, c2d        end to end on the c2 preset, and on it with depth
                 synthesis (chip_smoke.py's DEPTH_OVERRIDES["c2d"])
                 (random weights, seed 0; the batches of chip_smoke.py's
                 [serve] and [train]): the p50 host time of a predict
                 request over 50 (B = 16, K = 8) and of a train step over
                 30 on one batch, each ending in a synchronize, and the
                 step window's peak device memory.

Each checkout runs in processes of its own, in the order parent, this
checkout, this checkout, parent (A B B A; this checkout once without
--parent), and is driven through its own public wrappers
(kernels/multiflow.py, kernels/grid_sample.py, kernels/reproject.py), which
build its kernels from its own csrc/ into its own build directory: the two
checkouts may differ in their kernels' C entries and in the layouts they
take. A layout a checkout's wrapper refuses (ValueError) is reported and
skipped: each checkout is timed on the layouts it takes, among them the
one its own model passes. The inputs come from this checkout's
chip_smoke.py. A process holds every launch against the checkout's plain
version (1e-5), then times it with torch.profiler, --repeats sessions of
20 calls: the device time per wrapper call, all its kernels (a copy into
the kernel's layout, where the wrapper makes one, included). F.grid_sample
of the same frames (the warp only: the forward's one-call yardstick) is
timed in each process too. Prints the median and every time per checkout,
case, layout and launch, then one JSON line, which --out also receives.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
CASES = ("warp", "mf", "sample", "reproject", "reproject_bwd", "c2", "c2d",
         "draw")


def _chip_smoke():
    """This checkout's chip_smoke.py (inputs, profiler timing, card), loaded
    by path: a worker's import path leads to the checkout it measures."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Run:
    """One worker's results: times, errors, refused layouts and peak
    memory by key."""

    def __init__(self, cs, repeats):
        self.cs, self.repeats = cs, repeats
        self.out = {"times_ms": {}, "max_abs_err": {}, "refused": {},
                    "peak_mib": {}, "kernels_per_call": {}}

    def time(self, key, fn):
        self.out["times_ms"][key] = [self.cs._device_ms(fn)[0]
                                     for _ in range(self.repeats)]

    def check(self, key, fn, plain) -> bool:
        """Run fn and its plain version (lists of tensors, None skipped);
        False where the checkout refuses the inputs."""
        try:
            ours = fn()
        except ValueError as e:           # a layout this checkout refuses
            self.out["refused"][key] = str(e)
            return False
        err = max(float((o - r).abs().max()) for o, r in zip(ours, plain())
                  if r is not None)
        self.out["max_abs_err"][key] = err
        if not err <= 1e-5:
            raise AssertionError(f"{key}: max |kernel - plain| {err} > 1e-5")
        return True


def _warp(run, gs):
    cs = run.cs
    layouts = cs._warp_layouts()
    frames, ix, iy, mask, rgb = layouts[cs.MODEL_LAYOUT]
    b, _, h, w = frames.shape
    k = ix.shape[0] // b
    g = torch.Generator(device="cuda").manual_seed(1)
    d_view = torch.randn(rgb.shape, generator=g, device="cuda")
    grid = cs._grid(ix.reshape(b, -1), iy.reshape(b, -1), h, w)
    run.time("warp|F.grid_sample", lambda: F.grid_sample(
        frames, grid, mode="bilinear", padding_mode="border",
        align_corners=True))
    run.time("warp|per_target_copy", lambda: cs._per_target_copy(frames, k))
    for layout, key in (("shared", cs.MODEL_LAYOUT),
                        ("per_target", cs.COPY_LAYOUT)):
        img, *rest = layouts[key]
        stage = getattr(gs._build, "stage", None)  # older checkouts: none
        saved = img if stage is None else stage(img)

        def fwd(img=img, rest=rest):
            return gs.warp_composite_pix(img, *rest, "border", "fast")

        def bwd(saved=saved, rest=rest):
            return gs.warp_composite_pix_bwd(saved, *rest, d_view, None,
                                             "border", "fast",
                                             need_img=False)

        def plain(img=img, rest=rest):
            return list(gs.warp_composite_pix_plain(
                img, *rest, "border", "fast")) + list(
                gs.warp_composite_pix_bwd_plain(
                    img, *rest, d_view, None, "border", "fast",
                    need_img=False)[1:])
        if run.check(f"warp|{layout}", lambda: list(fwd()) + list(bwd()[1:]),
                     plain):
            run.time(f"warp|{layout}|fwd", fwd)
            run.time(f"warp|{layout}|bwd_train", bwd)


def _mf(run, mf):
    cs = run.cs
    g = torch.Generator(device="cuda").manual_seed(1)
    cases = {"80px": cs._mf_inputs(), "2px": cs._mf_inputs(2.0)}
    d_view, d_multi = (torch.randn(cases["80px"][5].shape, generator=g,
                                   device="cuda") for _ in range(2))
    for case, flat in cases.items():
        frames, grid = cs._mf_grid(*flat[:3])
        run.time(f"F.grid_sample|{case}", lambda: F.grid_sample(
            frames, grid, mode="bilinear", padding_mode="border",
            align_corners=True))
        for layout, args in (("channels_last", cs._channels_last(flat)),
                             ("contiguous", flat)):
            def fwd(args=args):
                return mf.multiflow_composite_pix(*args, precision="fast")

            def bwd(args=args):
                return mf.multiflow_composite_pix_bwd(
                    *args, d_view, d_multi, None, precision="fast",
                    need_imgs=False)

            def plain(args=args):
                return list(mf.multiflow_composite_pix_plain(
                    *args, precision="fast")) + list(
                    mf.multiflow_composite_pix_bwd_plain(
                        *args, d_view, d_multi, None, precision="fast",
                        need_imgs=False)[1:])
            if run.check(f"{case}|{layout}",
                         lambda: list(fwd()) + list(bwd()[1:]), plain):
                run.time(f"{case}|{layout}|fwd", fwd)
                run.time(f"{case}|{layout}|bwd_multidepth", bwd)


def _sample(run, gs):
    cs = run.cs
    frames, sx, sy = cs._shared_sample_inputs()
    b, _, h, w = frames.shape
    k = sx.shape[1] // (h * w)
    grid = cs._grid(sx, sy, h, w)
    run.time("sample|F.grid_sample", lambda: F.grid_sample(
        frames, grid, mode="bilinear", padding_mode="border",
        align_corners=True))
    layouts = {"shared": (frames, sx, sy),
               "per_target": (cs._per_target_copy(frames, k),
                              sx.reshape(b * k, -1), sy.reshape(b * k, -1))}
    for layout, args in layouts.items():
        def fwd(args=args):
            return gs.sample_pixel_coords(*args, "border", "fast")
        if run.check(f"sample|{layout}", lambda: [fwd()],
                     lambda args=args: [gs.sample_pixel_coords_plain(
                         *args, "border", "fast")]):
            run.time(f"sample|{layout}|fwd", fwd)


def _reproject_inputs(cs):
    """The checkout's reproject module, and the smooth and the random
    depth's [kernel-reproject] inputs."""
    from dynamic_multiview_3d_torch import config
    from dynamic_multiview_3d_torch.data import synthetic
    from dynamic_multiview_3d_torch.kernels import reproject as rp
    from dynamic_multiview_3d_torch.ops import pose as pose_ops
    raw = cs.c2_batches(config, synthetic, count=1)[0]
    return rp, {kind: cs._reproject_inputs(rp, pose_ops, synthetic, raw,
                                           kind)
                for kind in ("smooth", "random")}


def _reproject(run):
    cs = run.cs
    rp, inputs = _reproject_inputs(cs)
    for kind, inp in inputs.items():
        img, depth, params = inp[:3]
        h, w = img.shape[2:]
        cr = rp.correspondence_plain(depth, params, h, w)
        grid = cs._frames_grid(img, cr["x"], cr["y"])
        run.time(f"reproject|{kind}|F.grid_sample", lambda: F.grid_sample(
            img, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True))
        layouts = {"channels_last": inp,
                   "staged": (rp._build.stage(img),) + tuple(inp[1:])}
        for layout, args in layouts.items():
            for what, fn, plain, n_args in (
                    ("sample", rp.reproject_sample_pix,
                     rp.reproject_sample_pix_plain, 3),
                    ("composite", rp.reproject_composite_pix,
                     rp.reproject_composite_pix_plain, 5)):
                def fwd(fn=fn, args=args[:n_args]):
                    return fn(*args, "fast")

                def ref(plain=plain, args=args[:n_args]):
                    return list(plain(*args, "fast"))
                if run.check(f"reproject|{kind}|{layout}|{what}",
                             lambda: list(fwd()), ref):
                    run.time(f"reproject|{kind}|{layout}|{what}", fwd)


def _kept_frame(rp, inp):
    """The frame the checkout's composite autograd op keeps for its
    backward (a checkout that stages keeps the staged frame)."""
    depth = inp[1].clone().requires_grad_(True)
    view = rp.reproject_composite_pix(inp[0], depth, *inp[2:], "fast")[0]
    return view.grad_fn.saved_tensors[0]


def _reproject_bwd(run):
    cs = run.cs
    rp, inputs = _reproject_inputs(cs)
    inp = inputs["smooth"]
    g = torch.Generator(device="cuda").manual_seed(4)
    d_view, d_geo = (torch.randn(inp[4].shape, generator=g, device="cuda")
                     for _ in range(2))
    k = inp[1].shape[0] // inp[0].shape[0]
    copy = (cs._per_target_copy(inp[0], k),) + tuple(inp[1:])
    for layout, (img, depth, params, mask, rgb) in (
            ("shared", inp), ("per_target", copy)):
        img = _kept_frame(rp, (img, depth, params, mask, rgb))
        launches = {"sample": (img, depth, params, None, None, None, d_geo),
                    "composite": (img, depth, params, mask, rgb, d_view,
                                  d_geo)}
        for what, args in launches.items():
            def bwd(args=args):
                return rp.reproject_pix_bwd(*args, "fast", False)

            def plain(args=args):
                return rp.reproject_pix_bwd_plain(*args, "fast", False)
            if run.check(f"reproject_bwd|{layout}|{what}",
                         lambda: list(bwd()), lambda: list(plain())):
                run.time(f"reproject_bwd|{layout}|{what}", bwd)


def _draw(run):
    """The c3md step's device draw: device time, kernels a call, and a
    call's time with CUDA events."""
    from dynamic_multiview_3d_torch.data import resident
    from dynamic_multiview_3d_torch.utils import jax_random
    meta, draw = run.cs.C3MD_DRAW_META, resident.ResidentFrames.device_draw
    key = jax_random.step_keys(0, 15, True)[1]

    def call(device="cuda"):
        return [v.cpu() for v in draw(meta, key, 8, device).values()]
    if run.check("draw|c3md", call, lambda: call("cpu")):
        run.time("draw|c3md", lambda: draw(meta, key, 8, "cuda"))
        run.out["times_ms"]["draw|c3md|call"] = [
            run.cs._timed_ms(lambda: draw(meta, key, 8, "cuda"), 50)
            for _ in range(run.repeats)]
        events = run.cs._profiled(lambda: draw(meta, 0, 15, 8, "cuda"), 20)
        run.out["kernels_per_call"]["draw|c3md"] = \
            sum(e.count for e in events) / 20


def _end_to_end(run, variant):
    """``variant`` "c2": the c2 preset; "c2d": with depth synthesis."""
    from dynamic_multiview_3d_torch import config
    from dynamic_multiview_3d_torch.api import Model
    from dynamic_multiview_3d_torch.data import synthetic
    from dynamic_multiview_3d_torch.train import step as tstep
    cfg = config.get_config("c2", run.cs.DEPTH_OVERRIDES.get(variant, ()))
    raw = run.cs.c2_batches(config, synthetic)
    batches = [dict(r, image_seq=synthetic.to_model(r["image_seq"]))
               for r in raw]
    model = Model.init_random(cfg, seed=0, device="cuda")

    def p50(fn, count):
        fn(0)                                   # warm-up (cuDNN plans)
        torch.cuda.synchronize()
        times = []
        for i in range(count):
            t0 = time.perf_counter()
            fn(i)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return [statistics.median(times)]
    run.out["times_ms"][f"{variant}|request_p50"] = p50(
        lambda i: model.predict(batches[i % 4]["image_seq"],
                                batches[i % 4]["tgt_poses"],
                                source_poses=batches[i % 4]["src_poses"]),
        50)
    del model
    state = tstep.init_state(cfg, seed=0, device="cuda")
    step = tstep.make_train_step(cfg, device="cuda")
    step(state, raw[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run.out["times_ms"][f"{variant}|step_p50"] = p50(
        lambda i: step(state, raw[0]), 30)
    run.out["peak_mib"][f"{variant}|step"] = \
        torch.cuda.max_memory_allocated() / 2 ** 20


def worker(checkout: Path, repeats: int, cases) -> dict:
    """Check and time one checkout's kernels of ``cases`` in this
    process."""
    sys.path.insert(0, str(checkout))
    from dynamic_multiview_3d_torch.kernels import grid_sample as gs
    from dynamic_multiview_3d_torch.kernels import multiflow as mf
    if not Path(mf.__file__).resolve().is_relative_to(checkout.resolve()):
        raise RuntimeError(f"imported {mf.__file__}, not from {checkout}")
    torch.backends.cudnn.allow_tf32 = False
    run = _Run(_chip_smoke(), repeats)
    if "warp" in cases:
        _warp(run, gs)
    if "mf" in cases:
        _mf(run, mf)
    if "sample" in cases:
        _sample(run, gs)
    if "reproject" in cases:
        _reproject(run)
    if "reproject_bwd" in cases:
        _reproject_bwd(run)
    for variant in ("c2", "c2d"):
        if variant in cases:
            _end_to_end(run, variant)
    if "draw" in cases:
        _draw(run)
    return run.out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path,
                    help="another checkout of the repo to time against")
    ap.add_argument("--cases", default=",".join(CASES),
                    help=f"comma-separated, of {', '.join(CASES)}")
    ap.add_argument("--repeats", type=int, default=3,
                    help="profiler sessions per time and process")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    cases = args.cases.split(",")
    if not set(cases) <= set(CASES):
        ap.error(f"unknown case in {args.cases!r}")
    if not torch.cuda.is_available():
        print("bench_mf_kernels: no CUDA device", file=sys.stderr)
        return 1
    if args.worker:
        print(json.dumps(worker(args.worker, args.repeats, cases)))
        return 0
    card = _chip_smoke().phase_card()
    order = [("this", ROOT)]
    if args.parent:
        order = [("parent", args.parent.resolve())] + order * 2 \
            + [("parent", args.parent.resolve())]
    times, errs, peaks, kernels = {}, {}, {}, {}
    for name, checkout in order:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             str(checkout), "--repeats", str(args.repeats), "--cases",
             ",".join(cases)],
            cwd=checkout, stdout=subprocess.PIPE, text=True, check=True)
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        for key, ts in result["times_ms"].items():
            times.setdefault(f"{name}|{key}", []).extend(ts)
        for key, err in result["max_abs_err"].items():
            errs[f"{name}|{key}"] = max(err, errs.get(f"{name}|{key}", 0.0))
            print(f"[check] {name} {key}: max |kernel - plain| {err!r}")
        for key, why in result["refused"].items():
            print(f"[check] {name} {key}: refused ({why})")
        for key, mib in result["peak_mib"].items():
            peaks.setdefault(f"{name}|{key}", []).append(mib)
        for key, n in result["kernels_per_call"].items():
            kernels.setdefault(f"{name}|{key}", []).append(n)
    for key, ts in sorted(times.items()):
        print(f"[time] {key}: median {statistics.median(ts)!r} ms, all {ts}")
    for key, mibs in sorted(peaks.items()):
        print(f"[memory] {key}: peak {mibs} MiB")
    for key, ns in sorted(kernels.items()):
        print(f"[kernels] {key}: {ns} device ops a call (torch.profiler)")
    line = json.dumps({"card": card, "order": [n for n, _ in order],
                       "cases": cases, "max_abs_err": errs,
                       "times_ms": times, "peak_mib": peaks,
                       "kernels_per_call": kernels})
    print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
