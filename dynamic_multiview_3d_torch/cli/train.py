"""Train a DMV3D model.

    python -m dynamic_multiview_3d_torch.cli.train --preset c2 \
        --set train.num_steps=1000 --set train.ckpt_dir=/runs/c2 \
        --logdir /runs/c2_logs [--device cpu]

Writes the manager's steps and, at the end, the model dir
``<ckpt_dir>/model``; a rerun with the same ckpt_dir resumes from the
latest step. Runs on the card unless ``--device cpu``. Data-parallel, one
process per rank (NCCL with a card per rank; gloo on the CPU or where
ranks share a card):

    python -m torch.distributed.run --nproc-per-node 2 \
        -m dynamic_multiview_3d_torch.cli.train --preset c4 \
        --set mesh.data=2 --set train.ckpt_dir=/runs/c4

A 'model' axis (``mesh.model`` > 1) splits the output channels of the
wide convs over the model peers (``parallel/tensor.py``), one process
per device of the (data, model) mesh, data x model in all:

    python -m torch.distributed.run --nproc-per-node 4 \
        -m dynamic_multiview_3d_torch.cli.train --preset c4 \
        --set mesh.data=2 --set mesh.model=2 --set train.ckpt_dir=/runs/c4

A JAX run moves to the card by copying its run dir (``train_config.json``
and the manager steps ``<step>/default/``) and training on in it with the
same preset and overrides: the port resumes the JAX step (params, optax
state, step, EMA) and writes its next steps in the JAX layout, which the
JAX loop resumes in turn. ``--ckpt-format orbax`` writes that layout in a
fresh dir too.

Only rank 0 writes the logs, checkpoints (in the one-process layout) and
model dir. ``--parallel-mode`` takes the JAX CLI's choices and default,
so that a JAX command line runs as it is; the mesh still decides how the
step runs, and "auto" refuses ``data.resident_sharding='scenes'`` as the
JAX loop does.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import tempfile

from dynamic_multiview_3d_torch import config as config_lib


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", default="default",
                   choices=sorted(config_lib.PRESETS))
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="a.b=v", help="config override, repeatable")
    p.add_argument("--logdir",
                   default=os.path.join(tempfile.gettempdir(), "dmv3d_logs"))
    p.add_argument("--parallel-mode", default="shard_map",
                   choices=["shard_map", "auto"],
                   help="the JAX CLI's flag: the mesh decides how the step "
                        "runs; auto refuses a scene-sharded resident bank")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of a few steps here")
    p.add_argument("--profile-steps", nargs=2, type=int, default=(10, 15),
                   metavar=("START", "STOP"),
                   help="step window traced into --profile-dir (snaps to "
                        "dispatch boundaries when steps_per_dispatch > 1)")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise at the first operator that produces a NaN "
                        "(utils.debugging.debug_mode)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--ckpt-format", choices=("pt", "orbax"), default=None,
                   help="the manager steps' layout: pt (the port's), orbax "
                        "(the JAX package's); default: that of the latest "
                        "step in train.ckpt_dir, pt in a fresh one")
    return p


def main(argv=None):
    """-> (final train state, last logged metrics)."""
    args = build_parser().parse_args(argv)
    cfg = config_lib.get_config(args.preset, args.overrides)

    import torch.distributed

    from dynamic_multiview_3d_torch.parallel import mesh as mesh_lib
    from dynamic_multiview_3d_torch.train import loop as loop_lib
    from dynamic_multiview_3d_torch.train import metrics as metrics_lib
    from dynamic_multiview_3d_torch.utils import debugging

    joined = torch.distributed.is_initialized()
    mesh = mesh_lib.make_mesh(cfg.mesh, device=args.device)
    writer = (metrics_lib.MetricsWriter(args.logdir) if mesh.rank == 0
              else None)
    guard = (debugging.debug_mode() if args.debug_nans
             else contextlib.nullcontext())
    try:
        with guard:
            state, metrics = loop_lib.train(
                cfg, writer=writer, profile_dir=args.profile_dir,
                profile_steps=tuple(args.profile_steps), device=args.device,
                ckpt_format=args.ckpt_format,
                parallel_mode=args.parallel_mode)
        if mesh.rank == 0:
            print({k: round(v, 5) for k, v in metrics.items()})
    finally:
        if writer is not None:
            writer.close()
        if not joined:           # leave the group this call joined
            mesh_lib.shutdown()
    return state, metrics


if __name__ == "__main__":
    main()
