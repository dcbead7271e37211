"""Rank functions of tests/test_torch_parallel.py, run by
``parallel.dryrun.spawn`` in spawned processes: they import torch and the
port only (no JAX), and return numpy arrays and plain values."""

import os

import numpy as np
import torch

from dynamic_multiview_3d_torch import config as tconfig
from dynamic_multiview_3d_torch import serving
from dynamic_multiview_3d_torch.data import pipeline
from dynamic_multiview_3d_torch.parallel import mesh as tmesh
from dynamic_multiview_3d_torch.train import loop as tloop
from dynamic_multiview_3d_torch.train import metrics as tmetrics
from dynamic_multiview_3d_torch.train import step as tstep


def _numpy(named) -> dict:
    return {n: t.detach().numpy().copy() for n, t in named}


def step_rank(mesh, cfg_dict, state_dict, batches, steps):
    """``steps`` train steps from ``state_dict`` on this rank's rows of
    each global batch (None: device sampling from the loop's bank) ->
    the first step's metrics and reduced gradients, and the params after
    the last step."""
    cfg = tconfig.from_dict(cfg_dict)
    state = tstep.init_state(cfg, device=mesh.device)
    state.module.load_state_dict(
        {k: torch.as_tensor(v) for k, v in state_dict.items()})
    tmesh.replicate(mesh, state)
    resident = None
    if cfg.data.device_sampling:
        resident = tloop._maybe_resident(
            cfg, pipeline.make_source(cfg.data), mesh)
    step = tstep.make_train_step(cfg, mesh=mesh, resident=resident)
    first = None
    for i in range(steps):
        batch = None if batches is None else tmesh.shard_batch(mesh,
                                                               batches[i])
        state, metrics = step(state, batch)
        if first is None:
            first = (metrics, _numpy(
                (n, p.grad) for n, p in state.module.named_parameters()))
    return {"metrics": first[0], "grads": first[1],
            "params": _numpy(state.module.named_parameters())}


def bank_rank(mesh, cfg_dict):
    """The loop's bank on this rank, the scenes its source materialized,
    and a device draw's rows."""
    cfg = tconfig.from_dict(cfg_dict)
    src = pipeline.make_source(cfg.data)
    res = tloop._maybe_resident(cfg, src, mesh)
    lo, hi = tmesh.local_rows(mesh, cfg.data.batch_size)
    rows = res.device_draw(res.sample_meta(), cfg.data.seed, 3, hi - lo,
                           mesh.device, index_offset=lo)
    return {"frames": res.frames.numpy(), "poses": res.poses.numpy(),
            "num_scenes": res.num_scenes, "scene_offset": res.scene_offset,
            "nbytes": res.nbytes, "materialized": sorted(src._pack_cache),
            "rows": {k: v.numpy() for k, v in rows.items()}}


def loop_rank(mesh, cfg_dict, logdir):
    """``loop.train`` on this rank with its own metrics log; -> the final
    params, or "killed" after an injected failure."""
    cfg = tconfig.from_dict(cfg_dict)
    writer = tmetrics.MetricsWriter(os.path.join(logdir, f"r{mesh.rank}"),
                                    use_tensorboard=False)
    try:
        state, _ = tloop.train(cfg, writer=writer, device="cpu")
    except tloop.FaultInjected:
        return "killed"
    finally:
        writer.close()
    return _numpy(state.module.named_parameters())


def serve_rank(mesh, path, seq, src, tgt):
    """The artifact ``path`` served over the mesh: the gathered views."""
    served = serving.ServedModel.load(path, device="cpu")
    views = served.predict(seq, tgt, source_poses=src, mesh=mesh)
    return np.asarray(views.numpy())
