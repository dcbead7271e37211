"""Render novel views from a checkpoint and write PNGs.

    python -m dynamic_multiview_3d_torch.cli.predict --ckpt CKPT \
        --scene 3 --azimuths 0,45,90,135 --out views/ [--device cpu]

Writes ``source.png`` (the last source frame) and one ``view_NN.png`` per
azimuth.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--scene", type=int, default=0)
    p.add_argument("--azimuths", default="0,90,180,270",
                   help="comma-separated degrees")
    p.add_argument("--elevation", type=float, default=0.3)
    p.add_argument("--out",
                   default=os.path.join(tempfile.gettempdir(), "dmv3d_views"))
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)

    from dynamic_multiview_3d_torch.api import Model
    from dynamic_multiview_3d_torch.data import pipeline
    from dynamic_multiview_3d_torch.data.synthetic import to_uint8
    from dynamic_multiview_3d_torch.utils.png import write_png

    model = Model.from_checkpoint(args.ckpt, device=args.device)
    src = pipeline.make_source(model.cfg.data)
    ex = src.example(args.scene)

    az = np.deg2rad([float(a) for a in args.azimuths.split(",")])
    tgt = np.stack([az, np.full_like(az, args.elevation),
                    np.full_like(az, ex["src_poses"][0, 2])], -1)
    views = model.predict(ex["image_seq"], tgt.astype(np.float32),
                          source_poses=ex["src_poses"]).cpu().numpy()

    os.makedirs(args.out, exist_ok=True)
    write_png(os.path.join(args.out, "source.png"),
              to_uint8(ex["image_seq"][-1]))
    for i, v in enumerate(views):
        write_png(os.path.join(args.out, f"view_{i:02d}.png"), to_uint8(v))
    print(f"wrote {len(views) + 1} images to {args.out}")


if __name__ == "__main__":
    main()
