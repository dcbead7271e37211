"""The training loop (port of train/loop.py).

Each iteration takes one batch and makes one call of the train step
(``train/step.py``: preprocess, forward, backward, Adam, EMA on the
device); with ``train.steps_per_dispatch`` > 1 one call takes that many
optimizer steps. The batch comes from one of three places:
- by default the host assembles it from the source (examples
  ``s * batch_size`` onwards for step s, uint8 images);
- with a device-resident bank (``data.device_resident``, ``auto`` taking
  it where the source is a packed frames dataset within
  ``data.resident_budget_mb``; ``data.materialize_packed`` decodes a
  source into banks first) the host sends the same examples' row indices
  only, and with ``data.device_sampling`` nothing: the step draws on the
  device;
- with ``data.streaming`` the stream iterator's worker processes render
  the batches ahead (``data/pipeline.py`` ``make_stream_iterator``).

Checkpoint and resume are exact: the module, the optimizer's state, the
step and the EMA go into the manager's steps (``train/checkpoint.py``); a
batch is a pure function of the step, or, streaming, the stream's state
is written beside each manager step and restored on resume. The stream
takes the JAX package's Grain order and its state is Grain's iterator
state (``data/grain_order.py``), in the file the JAX loop keeps,
``grain_state_<step>_p<process>.json``; a
``stream_state_<step>_p<rank>.json`` of an earlier version of the port,
whose order was not Grain's, is refused.
``train.fail_after_step`` injects a failure for the resume tests. At the
end the EMA params (else the params) are exported to ``<ckpt_dir>/model``
for ``Model.from_checkpoint``.

A ``ckpt_dir`` whose latest step a JAX run wrote (``<step>/default/``)
resumes from it: its params, optax state, step and EMA
(``train/jax_state.py``), and the next steps are written in that layout,
which the JAX loop resumes (``ckpt_format="orbax"`` writes it from the
start). A streamed run's position carries over both ways: the port
resumes the JAX loop's Grain state at the same ``data.grain_workers`` and
takes the batches the JAX run would have taken, and the JAX loop resumes
the port's. A streamed JAX run of P processes (``grain_state_<step>_p<p>
.json`` for p < P beside the step: one Grain shard each) resumes on D
data ranks when P divides D: each group of D / P ranks takes one
process's shard and the first rank of the group writes its state, so the
JAX loop of P processes resumes the port's steps too (P = 1 for a fresh
run). What the JAX run drew with ``jax.random``, its device draws and
target subsets, the port draws alike (``utils/jax_random.py``).

Data parallelism: launched with one process per rank (``python -m
torch.distributed.run --nproc-per-node N``, ``mesh.data=N``), the loop
joins the process group (``parallel/mesh.py``), takes each step's rank
rows ``[s * B + r * B / N, s * B + (r + 1) * B / N)`` of the global batch
(a stream: the rank's rows of the stream's batch; device sampling: the
rank's rows of the draw), and the step averages the gradients. Rank 0's
params are broadcast at the start; every rank restores the same manager
step and its stream shard's state. Only rank 0 writes the config, the
manager's steps, metrics, image summaries and the model dir, and the
first rank of each stream shard its state (rank 0 alone, but for a
resumed JAX run of several processes), with barriers around them.
``data.resident_sharding="scenes"`` gives each rank a bank of its own
contiguous scenes (with device sampling); otherwise every rank holds the
whole bank.

A 'model' axis (``mesh.model=M``, ``python -m torch.distributed.run
--nproc-per-node data*M``): the loop splits the weights of
``parallel.mesh.model_axis_rules`` (min_size 128) over the model peers
after the restore (``parallel.tensor.shard_state``); model peers take the
same rows, and data ranks index banks and streams. Where the JAX loop
places the params replicated even on such a mesh, the port always splits
them: the layout ``MeshConfig`` describes, and the same function. The
manager's steps, the image summaries and the model dir are written from
the gathered one-process layout (``parallel.tensor.full_state``, every
rank taking part), so a step restores on any mesh.
"""

from __future__ import annotations

import glob
import inspect
import json
import os
import time
import warnings

import numpy as np
import torch

from dynamic_multiview_3d_torch import config as config_lib
from dynamic_multiview_3d_torch.data import pipeline
from dynamic_multiview_3d_torch.data import resident as resident_lib
from dynamic_multiview_3d_torch.data.synthetic import to_uint8
from dynamic_multiview_3d_torch.parallel import mesh as mesh_lib
from dynamic_multiview_3d_torch.parallel import tensor as tensor_lib
from dynamic_multiview_3d_torch.train import checkpoint as ckpt_lib
from dynamic_multiview_3d_torch.train import metrics as metrics_lib
from dynamic_multiview_3d_torch.train import step as step_lib
from dynamic_multiview_3d_torch.utils import profiling


class FaultInjected(RuntimeError):
    pass


def _check_supported(cfg: config_lib.Config) -> None:
    if cfg.data.streaming and (cfg.data.device_resident == "on"
                               or cfg.data.device_sampling):
        # residency needs the whole bank up front, a stream never has it
        raise ValueError(
            "data.streaming is incompatible with data.device_resident="
            "on / data.device_sampling (the device-resident modes need "
            "the full packed bank; use the index-batch path)")


def _check_dispatch_alignment(cfg: config_lib.Config, spd: int) -> None:
    for nm in ("num_steps", "ckpt_every", "log_every"):
        if getattr(cfg.train, nm) % spd:
            raise ValueError(
                f"train.{nm}={getattr(cfg.train, nm)} must be a multiple "
                f"of train.steps_per_dispatch={spd}")
    if cfg.train.fail_after_step >= 0 \
            and (cfg.train.fail_after_step + 1) % spd:
        # failure injection is dispatch-granular: the forced checkpoint
        # lands at a dispatch boundary, so a misaligned threshold would
        # silently run up to spd-1 extra optimizer steps first.
        raise ValueError(
            f"train.fail_after_step={cfg.train.fail_after_step}: "
            f"fail_after_step+1 must be a multiple of "
            f"steps_per_dispatch={spd} (failure fires at dispatch "
            "boundaries)")


# the JAX loop's parallel modes (its shard_map step, or GSPMD's "auto");
# the port's step is the mesh's whichever is named
PARALLEL_MODES = ("shard_map", "auto")
_SCENES_NEED = ("data.resident_sharding='scenes' requires data.device_sampling "
                "and the shard_map parallel mode (a shard can only address "
                "its local scene rows)")


def train(cfg: config_lib.Config, *,
          writer: metrics_lib.MetricsWriter | None = None, data_source=None,
          profile_dir: str | None = None,
          profile_steps: tuple[int, int] = (10, 15), device=None,
          ckpt_format: str | None = None, parallel_mode: str = "shard_map"):
    """Run training per cfg on ``device`` (default "cuda"; raises without
    a GPU). Returns (final_state, last_metrics).

    parallel_mode: the JAX loop's ``parallel_mode`` (``PARALLEL_MODES``).
    The mesh decides how the step runs; as in the JAX loop, "auto" refuses
    a scene-sharded resident bank.

    ckpt_format: the layout of the manager's steps, "pt" or "orbax" (the
    JAX package's); None: that of the latest step in ``train.ckpt_dir``,
    "pt" in a fresh one (``CheckpointManager``'s ``fmt``).

    profile_dir: when set, steps [profile_steps) are traced with
    torch.profiler into that directory (``utils.profiling.TraceWindow``).
    Under a multi-process launch (``cfg.mesh``, see the module docstring)
    ``device`` "cuda" is the rank's card, and ``writer`` is used on rank 0
    only."""
    _check_supported(cfg)
    if parallel_mode not in PARALLEL_MODES:
        raise ValueError(f"parallel_mode={parallel_mode!r}: one of "
                         f"{PARALLEL_MODES}")
    mesh = mesh_lib.make_mesh(cfg.mesh, device=device)
    mesh_lib.local_rows(mesh, cfg.data.batch_size)    # divisible by ranks
    if mesh.rank != 0:
        writer = None
    spd = max(1, cfg.train.steps_per_dispatch)
    if spd > 1:
        _check_dispatch_alignment(cfg, spd)
    stream = resident = None
    if cfg.data.streaming:
        stream = pipeline.make_stream_iterator(
            cfg.data, rank=mesh.data_rank, world_size=mesh.data_size)

        def batch_for_step(step):
            if spd == 1:
                return next(stream)
            return _stack_subbatches([next(stream) for _ in range(spd)])
    else:
        if (cfg.data.device_resident != "off"
                and cfg.data.resident_sharding == "scenes"
                and parallel_mode != "shard_map"):
            raise ValueError(_SCENES_NEED)
        if data_source is None:
            data_source = pipeline.make_source(cfg.data)
        resident = _maybe_resident(cfg, data_source, mesh)
        if cfg.data.device_sampling:
            if resident is None:
                raise ValueError("data.device_sampling requires a "
                                 "device-resident dataset "
                                 "(data.device_resident)")
            batch_for_step = lambda step: None  # noqa: E731: no host input
        else:
            batch_for_step = _make_batch_fn(cfg, data_source,
                                            resident=resident,
                                            steps_per_dispatch=spd,
                                            mesh=mesh)
    try:
        return _run(cfg, mesh, spd, batch_for_step, stream, resident,
                    data_source, writer, profile_dir, profile_steps,
                    ckpt_format)
    finally:
        if stream is not None:
            stream.close()


def _run(cfg, mesh, spd, batch_for_step, stream, resident, data_source,
         writer, profile_dir, profile_steps, ckpt_format):
    dev, lead = mesh.device, mesh.rank == 0
    state = step_lib.init_state(cfg, device=dev)
    mesh_lib.replicate(mesh, state)
    ckpt_dir = os.path.abspath(cfg.train.ckpt_dir)

    def manager():
        return ckpt_lib.make_manager(ckpt_dir, cfg.train.max_to_keep,
                                     cfg.train.ckpt_every, ckpt_format, cfg)
    if lead:      # makes the directory, drops a save cut short
        mgr = manager()
        # the resolved config beside the manager steps, so that an
        # intermediate step can be exported (cli.snapshot) even if the run
        # never reaches num_steps
        with open(os.path.join(ckpt_dir, "train_config.json"), "w") as f:
            json.dump(config_lib.to_dict(cfg), f, indent=2)
    mesh_lib.barrier(mesh)
    if not lead:
        mgr = manager()
    # every rank restores rank 0's latest step
    latest = mesh_lib.broadcast_object(mesh, mgr.latest_step())
    start_step = 0
    if latest is not None:
        mgr.restore(latest, state)
        start_step = state.step
        if start_step % spd:
            raise ValueError(
                f"resume step {start_step} is not aligned to "
                f"steps_per_dispatch={spd} (checkpoint from a different "
                "dispatch granularity — set a compatible value)")
        if stream is not None:
            _restore_stream_state(cfg, ckpt_dir, start_step, stream, mesh)
    state = tensor_lib.shard_state(state, mesh, mesh_lib.model_axis_rules(
        state.module, mesh))

    def whole():      # the one-process layout; every rank calls it
        return tensor_lib.full_state(state, mesh)

    step_fn = step_lib.make_train_step(cfg, mesh=mesh, resident=resident)
    # whether rank 0 writes image summaries, known to every rank: a
    # sharded module renders from the gathered one
    images = mesh_lib.broadcast_object(
        mesh, writer is not None and writer.has_images)
    preview_batch = None      # two examples for the image summaries; never
                              # an extra item taken from a stream

    last_metrics: dict = {}
    t_last = time.perf_counter()
    # one iteration = one call of step_fn = `spd` optimizer steps; `end`
    # is the number of completed optimizer steps after it
    trace = profiling.TraceWindow(profile_dir, profile_steps)
    for step in range(start_step, cfg.train.num_steps, spd):
        end = step + spd
        trace.maybe_start(step, end)
        host_batch = batch_for_step(step)
        if images and lead and preview_batch is None:
            if resident is not None:      # host pixels for summaries only
                pv = data_source.batch(range(2), raw=True)
            elif spd > 1:
                pv = {k: v[0] for k, v in host_batch.items()}
            else:
                pv = host_batch
            preview_batch = {k: np.array(v[:2]) for k, v in pv.items()}
        state, metrics = step_fn(state, host_batch)
        trace.maybe_stop(end)

        if cfg.train.fail_after_step >= 0 and end > cfg.train.fail_after_step:
            # flush a checkpoint exactly as a healthy run would have, then die
            trace.close()
            _save(mesh, mgr, end, whole(), stream, ckpt_dir)
            raise FaultInjected(f"injected failure after step {end - 1}")

        full = None
        if images and end % cfg.train.ckpt_every == 0:
            full = whole()
            if lead:
                _write_image_summaries(writer, full, preview_batch, end, dev)

        if end % cfg.train.log_every == 0 or step == start_step:
            now = time.perf_counter()
            denom = cfg.train.log_every if step != start_step else spd
            metrics = dict(metrics,
                           steps_per_sec=denom / max(now - t_last, 1e-9),
                           host_rss_mb=_host_rss_mb())
            t_last = now
            last_metrics = metrics
            if writer is not None:
                writer.write(end, metrics)
        # the policy on the step that every rank knows (no rank may read
        # the directory while rank 0 writes it)
        if ckpt_lib.save_due(end, latest, cfg.train.ckpt_every):
            _save(mesh, mgr, end, whole() if full is None else full, stream,
                  ckpt_dir)
            latest = end

    trace.close()
    full = whole()
    if lead:
        # the Model.from_checkpoint format, for eval and predict
        export = (full.module if full.ema is None
                  else {**full.module.state_dict(), **full.ema})
        ckpt_lib.save_model(os.path.join(ckpt_dir, "model"), export, cfg,
                            full.step)
    mesh_lib.barrier(mesh)
    return state, last_metrics


def _save(mesh, mgr, step, state, stream, ckpt_dir) -> None:
    """Manager step ``step`` of ``state`` (the one-process layout) by rank
    0, and the stream's state beside it, by the first data rank of each
    stream shard (of a JAX run of several processes; one shard, rank 0's,
    otherwise); returns when all have written."""
    if mesh.rank == 0:
        mgr.save(step, state, force=True)
        mgr.wait_until_finished()
    if stream is not None and mesh.model_rank == 0 and stream.writes_state:
        _save_stream_state(ckpt_dir, step, stream)
    mesh_lib.barrier(mesh)


def _host_rss_mb() -> float:
    """Trainer-process resident memory, logged with every metrics line: a
    linear climb is the tell of a host-side input or transfer leak, which
    device metrics do not show."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def _write_image_summaries(writer, state, batch, step, device) -> None:
    """Pred-vs-target grids (the current params, first target) to
    TensorBoard."""
    small = pipeline.preprocess(batch, device=device)
    with torch.no_grad():
        view = state.module(small["image_seq"], small["src_poses"],
                            small["tgt_poses"])["view"]
    pred = view[:, 0].float().cpu().numpy()
    tgt = small["tgt_images"][:, 0].cpu().numpy()
    grid = np.concatenate([pred, tgt], axis=2)      # side by side
    writer.write_images(step, "pred_vs_target", to_uint8(grid))


def _grain_state_path(ckpt_dir: str, step: int, process: int = 0) -> str:
    """The JAX loop's name for a Grain iterator's state beside a manager
    step (one file per JAX process)."""
    return os.path.join(ckpt_dir, f"grain_state_{step}_p{process}.json")


def _save_stream_state(ckpt_dir: str, step: int, stream) -> None:
    """The stream's state beside the manager step ``step``, as the JAX
    loop writes its Grain iterator's (``get_state()``'s JSON), under its
    shard's process number."""
    path = _grain_state_path(ckpt_dir, step, stream.order.shard_index)
    with open(path, "w") as f:
        f.write(json.dumps(stream.get_state(), indent=4))


def _stream_processes(ckpt_dir: str, step: int) -> int:
    """How many processes streamed the run that wrote manager step
    ``step``: the count of its ``grain_state_<step>_p<p>.json`` files,
    which must be p = 0 .. count - 1."""
    prefix = f"grain_state_{step}_p"
    found = sorted(name for name in os.listdir(ckpt_dir)
                   if name.startswith(prefix) and name.endswith(".json"))
    want = sorted(f"{prefix}{p}.json" for p in range(len(found)))
    if found != want:
        raise ValueError(f"manager step {step}'s Grain states are not "
                         f"those of processes 0 .. {len(found) - 1}: "
                         f"{found}")
    return max(len(found), 1)


def _restore_stream_state(cfg, ckpt_dir: str, step: int, stream,
                          mesh) -> None:
    """The stream at the Grain state beside manager step ``step``. A run
    of P processes (P ``grain_state_<step>_p*.json`` files, as a JAX run
    of P processes writes them) is taken up by P groups of data ranks,
    one a process's shard (``pipeline.stream_shard``; P must divide the
    data ranks). Raises where the step has no Grain state or only an
    earlier version of the port's stream state."""
    processes = _stream_processes(ckpt_dir, step)
    if processes > 1:
        stream.shard(*pipeline.stream_shard(
            cfg.data, stream.dataset.size, mesh.data_rank, mesh.data_size,
            processes))
    path = _grain_state_path(ckpt_dir, step, stream.order.shard_index)
    if not os.path.exists(path):
        old = sorted(glob.glob(os.path.join(
            glob.escape(ckpt_dir), f"stream_state_{step}_p*.json")))
        if old:
            raise ValueError(
                f"manager step {step} has a stream state of an earlier "
                f"version of the port ({old[0]}), whose record order was "
                "not Grain's: the run cannot resume the stream exactly "
                "where it stopped")
        raise FileNotFoundError(
            f"no stream state beside manager step {step} ({path}): the run "
            "cannot resume the stream where it stopped")
    with open(path) as f:
        stream.set_state(json.load(f))


def _maybe_resident(cfg: config_lib.Config, data_source, mesh):
    """The device-resident bank on the mesh's device when configured and
    eligible (``data/resident.py``; auto needs a frames-like source whose
    scenes are all packed, uniform and within data.resident_budget_mb),
    else None. ``data.materialize_packed`` first decodes a non-packed
    source (PNG, tfrecords, shapenet_dir, SyntheticFrames) into banks.
    ``data.resident_sharding="scenes"`` (device sampling only): the data
    rank's contiguous share of the scenes, the only ones it materializes,
    within the budget; otherwise the whole bank on every rank. ``mesh``: a
    ``parallel.mesh.Mesh`` (``Mesh(device=...)`` for one process)."""
    mode = cfg.data.device_resident
    if mode == "off":
        return None
    sharded = cfg.data.resident_sharding == "scenes"
    if sharded and not cfg.data.device_sampling:
        raise ValueError(_SCENES_NEED)
    shards, shard = (mesh.data_size, mesh.data_rank) if sharded else (1, 0)
    resident_src = cfg.data.source in ("frames", "tfrecords",
                                       "shapenet_dir")
    if (cfg.data.materialize_packed and resident_src
            and hasattr(data_source, "materialize_packed")):
        data_source.materialize_packed(
            resident_lib.shard_scenes(data_source, shards, shard))
    eligible = resident_src and resident_lib.fits_budget(
        data_source, cfg.data, shards, shard)
    if mode == "on" and not eligible:
        raise ValueError(
            "data.device_resident=on needs a packed frames dataset within "
            "data.resident_budget_mb (per rank, scene-sharded)")
    if not eligible:
        if mode == "auto" and resident_src:
            # residency was plausible (a frames dataset) but is off: say
            # so, the run ships host pixels every step
            warnings.warn(
                "data.device_resident=auto resolved to OFF (banks not "
                "packed/uniform or over data.resident_budget_mb); training "
                "will send host pixels every step", stacklevel=2)
        return None
    return resident_lib.ResidentFrames(data_source, cfg.data, mesh.device,
                                       num_shards=shards, shard=shard)


def _make_batch_fn(cfg: config_lib.Config, data_source, resident=None,
                   steps_per_dispatch: int = 1,
                   mesh: mesh_lib.Mesh | None = None):
    """Deterministic step -> this rank's batch (resume == replay): step s
    takes the examples [s * B + lo, s * B + hi) of the global batch B,
    [lo, hi) the rank's rows (all of them on one process). With
    device_preprocess the images stay uint8 on the host and are
    normalized on the device (``data.pipeline.preprocess``); with a
    resident bank the host gives only the same examples' int32 row
    indices."""
    bsz = cfg.data.batch_size
    lo, hi = mesh_lib.local_rows(mesh or mesh_lib.Mesh(), bsz)
    raw = cfg.data.device_preprocess
    has_raw = "raw" in inspect.signature(data_source.batch).parameters

    def one(step: int) -> dict:
        idx = range(step * bsz + lo, step * bsz + hi)
        if resident is not None:
            return resident.index_batch(idx)
        if has_raw:
            return data_source.batch(idx, raw=raw)
        return data_source.batch(idx)  # custom sources without a raw path

    if steps_per_dispatch == 1:
        return one

    def stacked(step: int) -> dict:
        return _stack_subbatches(
            [one(step + j) for j in range(steps_per_dispatch)])

    return stacked


def _stack_subbatches(subs: list[dict]) -> dict:
    """[spd] per-step batches -> one dispatch batch with a leading [spd]
    axis (the train step loops over it)."""
    return {k: np.stack([s[k] for s in subs]) for k in subs[0]}
