"""The training loop (port of train/loop.py).

Each step the host renders a batch and makes one call of the train step
(``train/step.py``: preprocess, forward, backward, Adam, EMA on the
device). Checkpoint and resume are exact: the module, the optimizer's
state, the step and the EMA go into the manager's steps
(``train/checkpoint.py``), and the batch of step s is a pure function of s
(examples ``s * batch_size`` onwards), so resuming at step N replays the
batches an uninterrupted run would have drawn. ``train.fail_after_step``
injects a failure for the resume tests. At the end the EMA params (else
the params) are exported to ``<ckpt_dir>/model`` for ``Model.from_checkpoint``.

Not ported, and refused with the ROADMAP.md queue 1 item that brings them:
Grain streaming (``data.streaming``, item 9a), device-resident data
(``data.device_resident="on"``, ``data.device_sampling``, item 10) and
data parallelism (``mesh.multihost`` or a mesh over more than one device,
item 11). ``data.device_resident="auto"`` resolves to off, as the JAX
package resolves it for a synthetic source.
"""

from __future__ import annotations

import inspect
import json
import os
import time

import numpy as np
import torch

from dynamic_multiview_3d_torch import config as config_lib
from dynamic_multiview_3d_torch.api import resolve_device
from dynamic_multiview_3d_torch.data import pipeline
from dynamic_multiview_3d_torch.data.synthetic import to_uint8
from dynamic_multiview_3d_torch.train import checkpoint as ckpt_lib
from dynamic_multiview_3d_torch.train import metrics as metrics_lib
from dynamic_multiview_3d_torch.train import step as step_lib
from dynamic_multiview_3d_torch.utils import profiling


class FaultInjected(RuntimeError):
    pass


def restore_latest(mgr: ckpt_lib.CheckpointManager,
                   template: step_lib.TrainState
                   ) -> step_lib.TrainState | None:
    latest = mgr.latest_step()
    if latest is None:
        return None
    return mgr.restore(latest, template)


def _check_supported(cfg: config_lib.Config) -> None:
    if cfg.mesh.multihost or max(cfg.mesh.data, 1) * cfg.mesh.model > 1:
        raise NotImplementedError(
            "data-parallel training (mesh.multihost, or a mesh over more "
            "than one device) is not ported yet: ROADMAP.md queue 1 item 11")
    if cfg.data.streaming:
        raise NotImplementedError(
            "data.streaming (the Grain iterator) is not ported yet: "
            "ROADMAP.md queue 1 item 9a")
    if cfg.data.device_resident == "on" or cfg.data.device_sampling:
        raise NotImplementedError(
            "device-resident data (data.device_resident=on, "
            "data.device_sampling) is not ported yet: ROADMAP.md queue 1 "
            "item 10")


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


def train(cfg: config_lib.Config, *,
          writer: metrics_lib.MetricsWriter | None = None, data_source=None,
          profile_dir: str | None = None,
          profile_steps: tuple[int, int] = (10, 15), device=None):
    """Run training per cfg on ``device`` (default "cuda"; raises without
    a GPU). Returns (final_state, last_metrics).

    profile_dir: when set, steps [profile_steps) are traced with
    torch.profiler into that directory (``utils.profiling.TraceWindow``)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    spd = max(1, cfg.train.steps_per_dispatch)
    if spd > 1:
        _check_dispatch_alignment(cfg, spd)
    if data_source is None:
        data_source = pipeline.make_source(cfg.data)
    batch_for_step = _make_batch_fn(cfg, data_source, steps_per_dispatch=spd)

    state = step_lib.init_state(cfg, device=dev)
    ckpt_dir = os.path.abspath(cfg.train.ckpt_dir)
    mgr = ckpt_lib.make_manager(ckpt_dir, cfg.train.max_to_keep,
                                cfg.train.ckpt_every)
    # the resolved config beside the manager steps, so that an
    # intermediate step can be exported (cli.snapshot) even if the run
    # never reaches num_steps
    with open(os.path.join(ckpt_dir, "train_config.json"), "w") as f:
        json.dump(config_lib.to_dict(cfg), f, indent=2)
    start_step = 0
    if restore_latest(mgr, state) is not None:
        start_step = state.step
        if start_step % spd:
            raise ValueError(
                f"resume step {start_step} is not aligned to "
                f"steps_per_dispatch={spd} (checkpoint from a different "
                "dispatch granularity — set a compatible value)")

    step_fn = step_lib.make_train_step(cfg, device=dev)
    images = writer is not None and writer.has_images
    preview_batch = None      # the first host batch's first two examples

    last_metrics: dict = {}
    t_last = time.perf_counter()
    # one iteration = one call of step_fn = `spd` optimizer steps; `end`
    # is the number of completed optimizer steps after it
    trace = profiling.TraceWindow(profile_dir, profile_steps)
    for step in range(start_step, cfg.train.num_steps, spd):
        end = step + spd
        trace.maybe_start(step, end)
        host_batch = batch_for_step(step)
        if images and preview_batch is None:
            pv = ({k: v[0] for k, v in host_batch.items()} if spd > 1
                  else host_batch)
            preview_batch = {k: np.array(v[:2]) for k, v in pv.items()}
        state, metrics = step_fn(state, host_batch)
        trace.maybe_stop(end)

        if cfg.train.fail_after_step >= 0 and end > cfg.train.fail_after_step:
            # flush a checkpoint exactly as a healthy run would have, then die
            trace.close()
            mgr.save(end, state, force=True)
            mgr.wait_until_finished()
            raise FaultInjected(f"injected failure after step {end - 1}")

        if images and end % cfg.train.ckpt_every == 0:
            _write_image_summaries(writer, state, preview_batch, end, dev)

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
        mgr.save(end, state)

    trace.close()
    mgr.wait_until_finished()
    # the Model.from_checkpoint format, for eval and predict
    export = (state.module if state.ema is None
              else {**state.module.state_dict(), **state.ema})
    ckpt_lib.save_model(os.path.join(ckpt_dir, "model"), export, cfg,
                        state.step)
    return state, last_metrics


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


def _make_batch_fn(cfg: config_lib.Config, data_source,
                   steps_per_dispatch: int = 1):
    """Deterministic step -> batch (resume == replay): step s takes the
    examples [s * batch_size, (s + 1) * batch_size). With device_preprocess
    the images stay uint8 on the host and are normalized on the device
    (``data.pipeline.preprocess``)."""
    bsz = cfg.data.batch_size
    raw = cfg.data.device_preprocess
    has_raw = "raw" in inspect.signature(data_source.batch).parameters

    def one(step: int) -> dict:
        idx = range(step * bsz, (step + 1) * bsz)
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
