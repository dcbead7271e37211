"""Evaluate a checkpoint: PSNR/SSIM over held-out synthetic views.

    python -m dynamic_multiview_3d_torch.cli.eval --ckpt /runs/c2/model \
        --num-batches 8 [--device cpu]

Renders novel views from a checkpoint and prints one JSON line: the
quality metrics, the protocol, the resolved data config and the
checkpoint's provenance (path and step).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--num-batches", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--eval-seed", type=int, default=10_000,
                   help="offset into the index space, past training data")
    p.add_argument("--holdout-scenes", type=int, default=0,
                   help="evaluate on N procedural scenes DISJOINT from the "
                        "training bank (scene ids offset past "
                        "data.num_scenes) — the scene-held-out protocol. "
                        "0 keeps the held-out-pose-index protocol.")
    p.add_argument("--seq-len", type=int, default=0,
                   help="evaluate with T source frames instead of the "
                        "trained data.seq_len (variable-T inference — "
                        "multi_head_mode='shared' checkpoints accept any "
                        "source count; 'baked' ones fail loudly on a "
                        "param-shape mismatch)")
    p.add_argument("--data-root", default=None,
                   help="override data.root (eval a frames dataset, e.g. "
                        "one exported with --scene-offset)")
    p.add_argument("--protocol", default=None,
                   choices=("pose-holdout", "scene-holdout"),
                   help="label for the reported protocol — set "
                        "scene-holdout when --data-root points at a "
                        "scene-disjoint export (the label cannot be "
                        "inferred from the root alone)")
    p.add_argument("--grid", default=None,
                   help="also write a source|prediction|target PNG grid of "
                        "the first 4 eval examples to this path")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch

    from dynamic_multiview_3d_torch.api import Model
    from dynamic_multiview_3d_torch.data import pipeline
    from dynamic_multiview_3d_torch.train import metrics as metrics_lib
    from dynamic_multiview_3d_torch.utils.png import write_png

    model = Model.from_checkpoint(args.ckpt, device=args.device)
    with open(os.path.join(args.ckpt, "config.json")) as f:
        ckpt_step = json.load(f)["step"]
    dcfg = model.cfg.data
    if args.data_root:
        if dcfg.source != "frames":
            p.error("--data-root applies only to frames-source checkpoints "
                    f"(this one has data.source={dcfg.source!r})")
        dcfg = dataclasses.replace(dcfg, root=args.data_root)
    if args.seq_len:
        dcfg = dataclasses.replace(dcfg, seq_len=args.seq_len)
    if args.holdout_scenes:
        if dcfg.source != "synthetic":
            # a frames source globs whatever is on disk; offsetting ids
            # would re-evaluate the training scenes while claiming
            # scene-holdout. Frames checkpoints point at a disjoint export.
            p.error("--holdout-scenes applies only to synthetic-source "
                    "checkpoints; for frames datasets pass --data-root "
                    "with a scene-disjoint export (make_dataset "
                    "--scene-offset) and --protocol scene-holdout")
        # unseen scene geometry: ids start past the training scene bank
        dcfg = dataclasses.replace(
            dcfg, scene_offset=dcfg.scene_offset + dcfg.num_scenes,
            num_scenes=args.holdout_scenes)
    src = pipeline.make_source(dcfg)

    def fwd(batch):
        return model.predict(batch["image_seq"], batch["tgt_poses"],
                             source_poses=batch["src_poses"])

    psnrs, ssims = [], []
    for i in range(args.num_batches):
        lo = args.eval_seed + i * args.batch_size
        batch = src.batch(range(lo, lo + args.batch_size))
        views = fwd(batch)
        tgt = torch.as_tensor(batch["tgt_images"], device=views.device)
        psnrs.append(float(metrics_lib.psnr(views, tgt)))
        ssims.append(float(metrics_lib.ssim(views, tgt)))
    result = {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims)),
              "num_views": args.num_batches * args.batch_size
              * model.cfg.data.num_targets,
              "protocol": args.protocol or ("scene-holdout"
                                            if args.holdout_scenes
                                            else "pose-holdout"),
              # the resolved data config, so that the protocol claim is
              # auditable (which root / scene ids were evaluated)
              "data_source": dcfg.source,
              "data_root": dcfg.root,
              "scene_offset": dcfg.scene_offset,
              "num_scenes": dcfg.num_scenes,
              "seq_len": dcfg.seq_len,
              # which weights produced these numbers
              "ckpt": os.path.abspath(args.ckpt),
              "ckpt_step": ckpt_step}
    if args.grid:
        gb = src.batch(range(args.eval_seed, args.eval_seed + 4))
        gv = fwd(gb).cpu().numpy()

        def u8(x):
            return np.clip((np.asarray(x, np.float32) + 1) * 127.5,
                           0, 255).astype(np.uint8)

        rows = [np.concatenate([u8(gb["image_seq"][i, -1]), u8(gv[i, 0]),
                                u8(gb["tgt_images"][i, 0])], axis=1)
                for i in range(4)]
        write_png(args.grid, np.concatenate(rows, axis=0))
        result["grid"] = args.grid
    print(json.dumps(result))


if __name__ == "__main__":
    main()
