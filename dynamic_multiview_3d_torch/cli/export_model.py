"""Export a checkpoint as a self-contained serving artifact.

    python -m dynamic_multiview_3d_torch.cli.export_model \
        --ckpt /runs/model --out /serve/model.dmv3d \
        --batch 1 --num-targets 8 [--seq-len 8 3] [--device cpu]

The artifact (``torch.export`` programs + weights + config, see
``serving.py``) is served with torch, numpy and the port's kernel modules:
no model code, no checkpoint machinery. ``--ckpt`` is a model directory the
port wrote (``cli.snapshot``), or one the JAX package wrote (Orbax, read by
the port's own reader on any machine, the card's included).

The programs are traced on the CPU and run on either device, so both
platforms are always written (``--platforms`` is checked, not chosen).
Then the artifact is loaded on ``--device`` (the card unless ``cpu`` is
asked for; without a GPU that raises) and serves one seeded request per
source count beside the live model, which must agree within 1e-5: the
line before the last gives the largest difference, and the last line is
the JAX CLI's, the output path and the manifest.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--seq-len", type=int, nargs="+", default=None,
                   help="source frame count(s) T (default: the checkpoint's "
                        "data.seq_len). Several values export one program "
                        "per T into the same artifact: the loader dispatches "
                        "on image_seq.shape[1] (shared-head checkpoints "
                        "only; baked heads fail at trace time for any T but "
                        "the trained one)")
    p.add_argument("--num-targets", type=int, default=1)
    p.add_argument("--platforms", nargs="*", default=(),
                   choices=("cpu", "cuda"),
                   help="platforms the artifact must serve on; both are "
                        "always written")
    p.add_argument("--device", default="cuda",
                   help="torch device that loads the checkpoint and serves "
                        "the check request: cuda (default) or cpu")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from dynamic_multiview_3d_torch import serving
    from dynamic_multiview_3d_torch.api import Model
    from dynamic_multiview_3d_torch.data.synthetic import random_poses

    model = Model.from_checkpoint(args.ckpt, device=args.device)
    seq_len = args.seq_len
    if seq_len is not None:
        seq_len = seq_len[0] if len(seq_len) == 1 else tuple(seq_len)
    manifest = serving.export_predict(
        model, args.out, batch=args.batch, seq_len=seq_len,
        num_targets=args.num_targets)
    served = serving.ServedModel.load(args.out, device=args.device)
    rng = np.random.default_rng(0)
    errs = {}
    for t in served.seq_lens:
        seq = rng.uniform(-1, 1, served.manifest["signatures"][str(t)][
            "image_seq"]).astype(np.float32)
        src = random_poses(rng, args.batch, t)
        tgt = random_poses(rng, args.batch, args.num_targets)
        got = served.predict(seq, tgt, source_poses=src)
        want = model.predict(seq, tgt, source_poses=src)
        errs[str(t)] = float((got - want).abs().max())
        if not bool(torch.isfinite(got).all()) or errs[str(t)] > 1e-5:
            raise RuntimeError(f"the artifact's views at T={t} are not the "
                               f"live model's (max err {errs[str(t)]})")
    print(json.dumps({"check": {"device": str(served.device),
                                "max_abs_err_by_T": errs}}))
    print(json.dumps({"out": args.out, **manifest}))


if __name__ == "__main__":
    main()
