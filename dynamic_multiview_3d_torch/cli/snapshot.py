"""Export an eval-ready model dir from an intermediate training checkpoint.

    python -m dynamic_multiview_3d_torch.cli.snapshot \
        --ckpt-dir /runs/c2 --out /runs/c2_model [--step 12000]

The training loop writes the ``Model.from_checkpoint`` dir
(``<ckpt_dir>/model``) only when it reaches ``train.num_steps``; a run cut
short leaves only the manager's steps. This tool exports any of them with
the ``train_config.json`` the loop writes at startup, for evaluating the
survivor rather than resuming it. Like the end-of-run export, it exports
the EMA params when the step holds them (train.ema_decay > 0), else the
params. It moves tensors to no device.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt-dir", required=True,
                   help="a train.ckpt_dir with manager steps")
    p.add_argument("--out", required=True,
                   help="destination model dir (Model.from_checkpoint format)")
    p.add_argument("--step", type=int, default=None,
                   help="manager step to export (default: latest)")
    args = p.parse_args(argv)

    from dynamic_multiview_3d_torch import config as config_lib
    from dynamic_multiview_3d_torch.train import checkpoint as ckpt_lib

    ckpt_dir = os.path.abspath(args.ckpt_dir)
    cfg_path = os.path.join(ckpt_dir, "train_config.json")
    if not os.path.exists(cfg_path):
        p.error(f"{cfg_path} not found: not a training checkpoint dir")
    with open(cfg_path) as f:
        cfg = config_lib.from_dict(json.load(f))

    step = args.step
    if step is None:
        steps = ckpt_lib.manager_steps(ckpt_dir)
        if not steps:
            p.error(f"no manager steps under {ckpt_dir}")
        step = steps[-1]
    saved = ckpt_lib.read_step(ckpt_dir, step)
    ema = saved["ema"]
    params = saved["module"] if ema is None else {**saved["module"], **ema}
    ckpt_lib.save_model(args.out, params, cfg, int(step))
    print(json.dumps({"out": os.path.abspath(args.out), "step": int(step),
                      "ema": ema is not None}))


if __name__ == "__main__":
    main()
