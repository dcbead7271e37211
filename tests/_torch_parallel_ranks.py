"""Rank functions of tests/test_torch_parallel.py and
tests/test_torch_tensor_parallel.py, run by
``parallel.dryrun.spawn`` in spawned processes: they import torch and the
port only (no JAX), and return numpy arrays and plain values."""

import os

import numpy as np
import torch

from dynamic_multiview_3d_torch import config as tconfig
from dynamic_multiview_3d_torch import serving
from dynamic_multiview_3d_torch.data import pipeline
from dynamic_multiview_3d_torch.parallel import mesh as tmesh
from dynamic_multiview_3d_torch.parallel import tensor as ttensor
from dynamic_multiview_3d_torch.train import loop as tloop
from dynamic_multiview_3d_torch.train import metrics as tmetrics
from dynamic_multiview_3d_torch.train import step as tstep
from dynamic_multiview_3d_torch.utils import jax_random


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
    rows = res.device_draw(res.sample_meta(),
                           jax_random.step_keys(cfg.data.seed, 3, True)[1],
                           hi - lo, mesh.device, index_offset=lo)
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


# ------------------------------------------------- the 'model' mesh axis
def _full_numpy(module, mesh, named) -> dict:
    return {n: t.detach().numpy().copy() for n, t in
            ttensor.full_tensors(module, mesh, dict(named)).items()}


def layers_rank(mesh, cases):
    """For each (weight, stride, bias, x, cotangent) of ``cases``: a
    ``layers.Conv`` (an OIHW ``weight``) or ``layers.Dense`` (an [out, in]
    one) split over the model peers; -> its output, the input's gradient,
    the gathered weight and bias gradients and the block names."""
    from torch import nn
    from dynamic_multiview_3d_torch.models import layers
    out = []
    for weight, stride, bias, x, cotangent in cases:
        if weight.ndim == 4:
            layer = layers.Conv(weight.shape[1], weight.shape[0],
                                weight.shape[2], stride,
                                use_bias=bias is not None)
        else:
            layer = layers.Dense(weight.shape[1], weight.shape[0])
        layer.weight.data.copy_(torch.as_tensor(weight))
        if bias is not None:
            layer.bias.data.copy_(torch.as_tensor(bias))
        holder = nn.Module()
        holder.layer = layer
        ttensor.shard_module_(holder, mesh, {"layer.weight"})
        x = torch.as_tensor(x).requires_grad_(True)
        y = holder.layer(x)
        y.backward(torch.as_tensor(cotangent))
        out.append({"out": y.detach().numpy(), "dx": x.grad.numpy(),
                    "grads": _full_numpy(holder, mesh, (
                        (n, p.grad) for n, p in holder.named_parameters())),
                    "blocks": sorted(ttensor.block_names(holder))})
    return out


def tp_step_rank(mesh, cfg_dict, state_dict, batches, steps, min_size):
    """``steps`` train steps on a (data, model) mesh from ``state_dict``
    (the wide convs of ``model_axis_rules(min_size)`` split): the first
    step's metrics and gathered gradients, and after the last the rank's
    own params and EMA (blocks and replicated) and the block names."""
    cfg = tconfig.from_dict(cfg_dict)
    state = tstep.init_state(cfg, device=mesh.device)
    state.module.load_state_dict(
        {k: torch.as_tensor(v) for k, v in state_dict.items()})
    tmesh.replicate(mesh, state)
    state = ttensor.shard_state(state, mesh, tmesh.model_axis_rules(
        state.module, mesh, min_size))
    step = tstep.make_train_step(cfg, mesh=mesh)
    first = None
    for i in range(steps):
        state, metrics = step(state, tmesh.shard_batch(mesh, batches[i]))
        if first is None:
            first = (metrics, _full_numpy(state.module, mesh, (
                (n, p.grad) for n, p in state.module.named_parameters())))
    return {"metrics": first[0], "grads": first[1],
            "params": _numpy(state.module.named_parameters()),
            "ema": _numpy((state.ema or {}).items()),
            "blocks": sorted(ttensor.block_names(state.module))}


def mesh_rank(mesh):
    """This rank's place on the mesh, its groups' ranks, and the meshes
    ``make_mesh`` refuses on this world."""
    import torch.distributed as dist
    refused = []
    for data, model in ((3, 2), (-1, 3), (1, 1)):
        try:
            tmesh.make_mesh(tconfig.MeshConfig(data=data, model=model),
                            device="cpu")
        except ValueError as e:
            refused.append(str(e))
    return {"rank": mesh.rank, "data_rank": mesh.data_rank,
            "model_rank": mesh.model_rank, "data_size": mesh.data_size,
            "model_size": mesh.model_size,
            "data_group": dist.get_process_group_ranks(mesh.data_group),
            "model_group": dist.get_process_group_ranks(mesh.model_group),
            "rows": tmesh.local_rows(mesh, 8), "refused": refused}


def tp_loop_rank(mesh, cfg_dict, logdir):
    """``loop_rank`` on a mesh with a model axis: -> the gathered
    (one-process layout) params and moments, the step and the block
    names, or "killed"."""
    cfg = tconfig.from_dict(cfg_dict)
    writer = tmetrics.MetricsWriter(os.path.join(logdir, f"r{mesh.rank}"),
                                    use_tensorboard=False)
    try:
        state, _ = tloop.train(cfg, writer=writer, device="cpu")
    except tloop.FaultInjected:
        return "killed"
    finally:
        writer.close()
    blocks = sorted(ttensor.block_names(state.module))
    full = ttensor.full_state(state, mesh)
    return {"params": _numpy(full.module.named_parameters()),
            "moments": {n: {k: v.numpy().copy() for k, v in
                            full.optimizer.state[p].items()}
                        for n, p in full.module.named_parameters()},
            "step": full.step, "blocks": blocks}
