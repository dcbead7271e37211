"""A data-parallel dry run on the CPU (counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``), and ``spawn``, which runs a
function on every rank of a group of spawned processes.

    python -m dynamic_multiview_3d_torch.parallel.dryrun 2

``dryrun_multichip(n)`` spawns n processes joined over gloo and runs, at
tiny shapes, the JAX dry run's modes: 1, the data-parallel step on a
global batch; 3, a scene-sharded bank with device sampling, 4 steps a
dispatch; 4 and 4b, one multiflow and one multidepth step on a replicated
bank; and, where n >= 4 is even, 2: one step on an (n / 2, 2) mesh whose
wide convs (``model_axis_rules`` with min_size 16) are split over the
'model' axis.
"""

from __future__ import annotations

import math
import multiprocessing
import os
import queue
import socket
import sys
import tempfile
import traceback

import torch

from dynamic_multiview_3d_torch import config as config_lib
from dynamic_multiview_3d_torch.parallel import mesh as mesh_lib
from dynamic_multiview_3d_torch.parallel import tensor as tensor_lib


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, model, port, device, args, timeout_s,
               results):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    # one thread a rank: ranks that share the cores do not wait on one
    # another's thread pools
    torch.set_num_threads(1)
    try:
        # multihost: join the group even as the one rank of one
        mesh = mesh_lib.make_mesh(
            config_lib.MeshConfig(data=world // model, model=model,
                                  multihost=True),
            device=device, timeout_s=timeout_s)
        try:
            results.put((rank, True, fn(mesh, *args)))
        finally:
            mesh_lib.shutdown()
    except BaseException:              # noqa: BLE001: reported to the parent
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, world: int, args=(), device="cpu", timeout_s: float = 60.0,
          model: int = 1) -> list:
    """``fn(mesh, *args)`` on each of ``world`` spawned processes, joined
    by ``make_mesh`` on a (world / model, model) mesh from the launcher
    environment that this sets
    (127.0.0.1, a free port); -> the ranks' return values in rank order.
    ``fn`` and its results must pickle. Raises with a rank's traceback if
    one fails, and if the ranks have not all answered within
    ``timeout_s`` (the group's own timeout too); every process is gone
    when it returns."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, model, port, device, args,
                               timeout_s, results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    out, errors = {}, []
    try:
        for _ in range(world):
            rank, ok, value = results.get(timeout=timeout_s)
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
    except queue.Empty:
        errors.append(f"ranks {sorted(set(range(world)) - set(out))} did "
                      f"not answer within {timeout_s} s")
    finally:
        for p in procs:
            p.join(timeout=5 if errors else timeout_s)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return [out[r] for r in range(world)]


TINY = ["model.image_size=32", "model.num_levels=3", "model.base_features=8",
        "model.max_features=16", "model.gru_features=16",
        "model.pose_embed_dim=8", "model.dtype=float32",
        "model.remat_scan=true", "data.image_size=32", "data.seq_len=2",
        "data.num_targets=2"]


def _dryrun_rank(mesh, n: int, root: str) -> dict:
    from dynamic_multiview_3d_torch.data import pipeline
    from dynamic_multiview_3d_torch.data.synthetic import SyntheticScenes
    from dynamic_multiview_3d_torch.train import loop as loop_lib
    from dynamic_multiview_3d_torch.train import step as step_lib

    cfg = config_lib.override(config_lib.Config(), TINY + [
        f"data.batch_size={2 * n}", f"mesh.data={n}"])
    losses = {}

    def run(name, cfg, resident, batch, steps=1):
        state = step_lib.init_state(cfg, device=mesh.device)
        mesh_lib.replicate(mesh, state)
        step = step_lib.make_train_step(cfg, mesh=mesh, resident=resident)
        state, metrics = step(state, batch)
        assert state.step == steps and metrics["loss/total"] > 0, name
        losses[name] = metrics["loss/total"]
        return metrics

    # mode 1: the data-parallel step, each rank on its rows
    src = SyntheticScenes(num_scenes=2, image_size=32, seq_len=2,
                          num_targets=2, dynamic=True)
    run("1", cfg, None, mesh_lib.shard_batch(
        mesh, src.batch(range(2 * n), raw=True)))

    # mode 3: a scene-sharded bank, device sampling, 4 steps a dispatch
    cfg3 = config_lib.override(cfg, [
        "data.source=frames", f"data.root={root}",
        "data.device_sampling=true", "data.resident_sharding=scenes",
        "train.steps_per_dispatch=4"])
    res = loop_lib._maybe_resident(cfg3, pipeline.make_source(cfg3.data),
                                   mesh)
    assert res is not None and res.num_shards == n and res.num_scenes == 1
    run("3", cfg3, res, None, steps=4)

    # modes 4 and 4b: multiflow and multidepth on orbit sources, one step
    # on a replicated bank
    for name, synthesis in (("4", "multiflow"), ("4b", "multidepth")):
        cfg4 = config_lib.override(cfg3, [
            f"model.synthesis={synthesis}", "data.src_views=orbit",
            "train.steps_per_dispatch=1",
            "data.resident_sharding=replicate"])
        res4 = loop_lib._maybe_resident(
            cfg4, pipeline.make_source(cfg4.data), mesh)
        assert res4 is not None and res4.sample_meta()["orbit"]
        metrics = run(name, cfg4, res4, None)
        assert (synthesis == "multidepth") == ("loss/geo_l1" in metrics)

    # mode 2: an (n / 2, 2) mesh, the wide convs split over 'model'
    if n >= 4 and n % 2 == 0:
        mesh2 = mesh_lib.make_mesh(config_lib.MeshConfig(data=n // 2,
                                                         model=2),
                                   device=mesh.device)
        state = step_lib.init_state(cfg, mesh=mesh2, min_size=16)
        assert len(tensor_lib.block_names(state.module)) > 0
        step = step_lib.make_train_step(cfg, mesh=mesh2)
        state, metrics = step(state, mesh_lib.shard_batch(
            mesh2, src.batch(range(2 * n), raw=True)))
        assert math.isfinite(metrics["loss/total"]), metrics
        losses["2"] = metrics["loss/total"]
    return losses


def dryrun_multichip(n_devices: int, timeout_s: float = 60.0) -> list:
    """Modes 1, 3, 4 and 4b on ``n_devices`` gloo processes (one scene of
    a packed export per rank), and mode 2 where ``n_devices`` >= 4 is
    even; -> each rank's losses by mode, equal across ranks (they are
    averaged over the data axis, and model peers compute the same
    loss)."""
    from dynamic_multiview_3d_torch.data import frames

    with tempfile.TemporaryDirectory() as tmp:
        root = frames.export_synthetic(os.path.join(tmp, "res"),
                                       num_scenes=n_devices, image_size=32,
                                       num_views=3, seq_len=2, fmt="packed")
        out = spawn(_dryrun_rank, n_devices, (n_devices, root),
                    timeout_s=timeout_s)
    assert all(o == out[0] for o in out), out
    return out


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    print(dryrun_multichip(n))
    print(f"dryrun_multichip({n}) OK")
