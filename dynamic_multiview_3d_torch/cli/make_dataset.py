"""Materialize a synthetic dataset on disk with the port's exporters.

    python -m dynamic_multiview_3d_torch.cli.make_dataset --root /data/dmv3d \
        --scenes 32 --image-size 256 --views 12 --seq-len 4 --dynamic \
        [--fmt png|packed|tfrecord]

``png`` and ``packed`` write the frame-folder layout (``data.source=
frames``), ``tfrecord`` tf.train.Example shards (``data.source=
tfrecords``). Needs none of imageio, OpenCV or TensorFlow.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", required=True)
    p.add_argument("--scenes", type=int, default=8)
    p.add_argument("--image-size", type=int, default=128)
    p.add_argument("--views", type=int, default=12)
    p.add_argument("--seq-len", type=int, default=4)
    p.add_argument("--dynamic", action=argparse.BooleanOptionalAction,
                   default=True, help="objects move over the sequence")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fmt", choices=("png", "packed", "tfrecord"),
                   default="png",
                   help="png: per-frame files (real decode work); packed: "
                        "memory-mapped uint8 banks (decode-free); tfrecord: "
                        "tf.train.Example shards (data.source=tfrecords)")
    p.add_argument("--scene-offset", type=int, default=0,
                   help="shift procedural scene ids (disjoint offsets give "
                        "held-out-scene eval splits)")
    args = p.parse_args(argv)

    if args.fmt == "tfrecord":
        from dynamic_multiview_3d_torch.data import tfrecords
        root = tfrecords.export_tfrecords(
            args.root, num_scenes=args.scenes, image_size=args.image_size,
            num_views=args.views, seq_len=args.seq_len,
            dynamic=args.dynamic, seed=args.seed,
            scene_offset=args.scene_offset)
    else:
        from dynamic_multiview_3d_torch.data import frames
        root = frames.export_synthetic(
            args.root, num_scenes=args.scenes, image_size=args.image_size,
            num_views=args.views, seq_len=args.seq_len, dynamic=args.dynamic,
            seed=args.seed, fmt=args.fmt, scene_offset=args.scene_offset)
    total = args.scenes * args.views * args.seq_len
    print(f"wrote {total} frames across {args.scenes} scenes to {root}")


if __name__ == "__main__":
    main()
