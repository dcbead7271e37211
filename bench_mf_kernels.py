#!/usr/bin/env python3
"""Time the multi-source kernels (#4 forward, #5 backward) of this checkout
against those of another checkout of the repo, on one NVIDIA GPU.

    python3 bench_mf_kernels.py [--parent DIR] [--repeats N] [--out FILE]

Each checkout runs in processes of its own, in the order parent, this
checkout, this checkout, parent (A B B A; this checkout once without
--parent), and is driven through its own public wrappers
(kernels/multiflow.py: multiflow_composite_pix, multiflow_composite_pix_bwd),
which build its kernels from its own csrc/ into its own build directory:
the two checkouts may differ in their kernels' C entries and in the frame
layouts they take. On the c3md shape (chip_smoke.py's [kernel-mf] inputs:
N = 8, T = 8 sources of 3 x 128 x 128, K = 2; flows of up to 80 px and of
up to 2 px) a process holds the forward (fast) and the multidepth backward
launch (fast; d_multi, no d_wts, no d_imgs) against the checkout's plain
versions (1e-5) on channels-last frames (NHWC frames permuted, as the
model passes them), where the checkout takes them, and on contiguous
frames; then it times each with torch.profiler, --repeats sessions of 20
calls: the device time per wrapper call, all its kernels (a copy of the
frames, where the wrapper makes one, included). F.grid_sample of the 64
frames (border, the warp only: the forward's one-call yardstick) is timed
in each process too. Prints the median and every time per checkout, case,
layout and launch, then one JSON line, which --out also receives.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent


def _chip_smoke():
    """This checkout's chip_smoke.py (inputs, profiler timing, card), loaded
    by path: a worker's import path leads to the checkout it measures."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def worker(checkout: Path, repeats: int) -> dict:
    """Check and time one checkout's #4 and #5 in this process."""
    sys.path.insert(0, str(checkout))
    from dynamic_multiview_3d_torch.kernels import multiflow as mf
    if not Path(mf.__file__).resolve().is_relative_to(checkout.resolve()):
        raise RuntimeError(f"imported {mf.__file__}, not from {checkout}")
    cs = _chip_smoke()
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(1)
    cases = {"80px": cs._mf_inputs(), "2px": cs._mf_inputs(2.0)}
    d_view, d_multi = (torch.randn(cases["80px"][5].shape, generator=g,
                                   device="cuda") for _ in range(2))
    out = {"times_ms": {}, "max_abs_err": {}, "refused": {}}

    def timed(fn):
        return [cs._device_ms(fn)[0] for _ in range(repeats)]

    for case, flat in cases.items():
        frames, grid = cs._mf_grid(*flat[:3])
        out["times_ms"][f"F.grid_sample|{case}"] = timed(
            lambda: F.grid_sample(frames, grid, mode="bilinear",
                                  padding_mode="border", align_corners=True))
        for layout, args in (("channels_last", cs._channels_last(flat)),
                             ("contiguous", flat)):
            def fwd(args=args):
                return mf.multiflow_composite_pix(*args, "fast")

            def bwd(args=args):
                return mf.multiflow_composite_pix_bwd(
                    *args, d_view, d_multi, None, "fast", need_imgs=False)
            try:
                ours = list(fwd())
            except ValueError as e:       # a layout this checkout refuses
                out["refused"][f"{case}|{layout}"] = str(e)
                continue
            ours += bwd()[1:]
            ref = list(mf.multiflow_composite_pix_plain(*args, "fast")) \
                + list(mf.multiflow_composite_pix_bwd_plain(
                    *args, d_view, d_multi, None, "fast",
                    need_imgs=False)[1:])
            err = max(float((o - r).abs().max()) for o, r in zip(ours, ref))
            out["max_abs_err"][f"{case}|{layout}"] = err
            if not err <= 1e-5:
                raise AssertionError(f"{checkout} {case} {layout}: max "
                                     f"|kernel - plain| {err} > 1e-5")
            out["times_ms"][f"{case}|{layout}|fwd"] = timed(fwd)
            out["times_ms"][f"{case}|{layout}|bwd_multidepth"] = timed(bwd)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path,
                    help="another checkout of the repo to time against")
    ap.add_argument("--repeats", type=int, default=3,
                    help="profiler sessions per time and process")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_mf_kernels: no CUDA device", file=sys.stderr)
        return 1
    if args.worker:
        print(json.dumps(worker(args.worker, args.repeats)))
        return 0
    card = _chip_smoke().phase_card()
    order = [("this", ROOT)]
    if args.parent:
        order = [("parent", args.parent.resolve())] + order * 2 \
            + [("parent", args.parent.resolve())]
    times, errs = {}, {}
    for name, checkout in order:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             str(checkout), "--repeats", str(args.repeats)],
            cwd=checkout, stdout=subprocess.PIPE, text=True, check=True)
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        for key, ts in result["times_ms"].items():
            times.setdefault(f"{name}|{key}", []).extend(ts)
        for key, err in result["max_abs_err"].items():
            errs[f"{name}|{key}"] = max(err, errs.get(f"{name}|{key}", 0.0))
            print(f"[check] {name} {key}: max |kernel - plain| {err!r}")
        for key, why in result["refused"].items():
            print(f"[check] {name} {key}: refused ({why})")
    for key, ts in sorted(times.items()):
        print(f"[time] {key}: median {statistics.median(ts)!r} ms, all {ts}")
    line = json.dumps({"card": card, "order": [n for n, _ in order],
                       "max_abs_err": errs, "times_ms": times})
    print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
