"""Checkpoints (port of train/checkpoint.py).

Two surfaces, as in the JAX package:

- model directories: ``save_model`` / ``load_model``, the format of
  ``Model.from_checkpoint``. A directory holds ``config.json``
  (``{"config": ..., "step": ...}``, the JAX schema) beside its weights.
  The port writes them as ``params_{step}.pt``: ``torch.save`` of a
  ``state_dict`` of CPU tensors, read back with ``weights_only=True``. The
  JAX package writes an Orbax directory ``params_{step}/`` instead;
  ``load_model`` reads that one through ``tensorstore`` (no JAX needed)
  and returns its flat flax tree. A directory is written under a
  temporary name and renamed into place, so a reader never sees half of
  one.
- training checkpoints: ``make_manager`` -> ``CheckpointManager``, whose
  steps hold the module's and the optimizer's ``state_dict``, the step and
  the EMA, one directory ``<ckpt_dir>/<step>/`` each. It decides when to
  save as Orbax's ``CheckpointManager`` does by default.

The JAX package's ``import_tf1_checkpoint`` is not ported: its name map
waits for a reference checkout.
"""

from __future__ import annotations

import json
import os
import shutil
from collections.abc import Mapping

import torch
from torch import nn

from dynamic_multiview_3d_torch import config as config_lib

_STATE_FILE = "state.pt"


def _to_cpu(tree):
    """``tree`` (nested mappings) with every tensor copied, detached, to the
    CPU; other leaves as they are."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, Mapping):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def _commit(path: str, write) -> None:
    """Make the directory ``path`` atomically: ``write(tmp)`` fills a
    temporary sibling, which is then renamed to ``path`` (an existing
    ``path`` is replaced)."""
    path = os.path.abspath(path)
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        write(tmp)
        if os.path.exists(path):
            old = f"{path}.old-{os.getpid()}"
            os.replace(path, old)
            os.replace(tmp, path)
            shutil.rmtree(old)
        else:
            os.replace(tmp, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -------------------------------------------------------------- model dirs
def save_model(path: str, module_or_state_dict, cfg: config_lib.Config,
               step: int = 0) -> None:
    """Write the model directory ``path``: ``params_{step}.pt`` (the
    module's ``state_dict``, or the given one, as CPU tensors) and
    ``config.json``."""
    sd = (module_or_state_dict.state_dict()
          if isinstance(module_or_state_dict, nn.Module)
          else module_or_state_dict)
    sd = {k: _to_cpu(v) for k, v in sd.items()}

    def write(tmp):
        torch.save(sd, os.path.join(tmp, f"params_{step}.pt"))
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump({"config": config_lib.to_dict(cfg), "step": step}, f,
                      indent=2)
    _commit(path, write)


def load_model(path: str):
    """-> (weights, cfg, step). ``weights`` is the ``state_dict`` of a
    directory the port wrote, or the flat flax tree ``{"a/b/c": ndarray}``
    of one the JAX package wrote (``weights.from_flax`` takes it)."""
    path = os.path.abspath(path)
    with open(os.path.join(path, "config.json")) as f:
        meta = json.load(f)
    cfg = config_lib.from_dict(meta["config"])
    step = meta["step"]
    port_file = os.path.join(path, f"params_{step}.pt")
    if os.path.exists(port_file):
        return (torch.load(port_file, map_location="cpu", weights_only=True),
                cfg, step)
    orbax_dir = os.path.join(path, f"params_{step}")
    if os.path.isdir(orbax_dir):
        return read_orbax(orbax_dir), cfg, step
    raise FileNotFoundError(f"{path} has neither params_{step}.pt (the "
                            f"port's) nor params_{step}/ (the JAX package's)")


def read_orbax(directory: str) -> dict:
    """The leaves of an Orbax ``StandardCheckpointer`` directory as a flat
    ``{"a/b/c": ndarray}``, read with ``tensorstore`` alone: the leaf names
    come from ``_METADATA``, the arrays from the OCDBT key-value store."""
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError(
            "reading a checkpoint written by the JAX package (an Orbax "
            f"directory, {directory}) needs the 'tensorstore' package, "
            "which is not installed") from e
    directory = os.path.abspath(directory)
    with open(os.path.join(directory, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt") or meta.get("use_zarr3"):
        raise ValueError(f"{directory}: only Orbax's default layout (OCDBT "
                         "over zarr v2) is read")
    out = {}
    for leaf in meta["tree_metadata"].values():
        keys = [str(k["key"]) for k in leaf["key_metadata"]]
        spec = {"driver": "zarr",
                "kvstore": {"driver": "ocdbt", "base": f"file://{directory}",
                            "path": ".".join(keys)}}
        out["/".join(keys)] = ts.open(spec, open=True).result().read() \
            .result()
    return out


# ------------------------------------------------------- training checkpoints
def manager_steps(ckpt_dir: str) -> list[int]:
    """The committed steps under ``ckpt_dir``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d) for d in os.listdir(ckpt_dir) if d.isdigit())


def read_step(ckpt_dir: str, step: int) -> dict:
    """One manager step as saved: ``{"module", "optimizer", "step",
    "ema"}`` with CPU tensors."""
    return torch.load(os.path.join(ckpt_dir, str(step), _STATE_FILE),
                      map_location="cpu", weights_only=True)


def save_due(step: int, latest: int | None, interval: int) -> bool:
    """Orbax's default save policy: the first step (``InitialSavePolicy``)
    and every ``interval``-th step past the latest
    (``FixedIntervalPolicy``)."""
    if latest is None:
        return True
    return step > latest and step % interval == 0


class CheckpointManager:
    """Training checkpoints under one directory, saved synchronously.

    ``save`` decides as Orbax's default policy does: a step is saved when
    none exists yet (``InitialSavePolicy``) or when ``step %
    save_interval_steps == 0`` (``FixedIntervalPolicy``), never at a step at
    or below the latest, and always under ``force``; a step that exists
    raises. The newest ``max_to_keep`` steps are kept (None: all)."""

    def __init__(self, directory: str, max_to_keep: int | None = 3,
                 save_interval_steps: int = 1000):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        os.makedirs(self.directory, exist_ok=True)
        for d in os.listdir(self.directory):        # a save cut short
            if d.split(".", 1)[0].isdigit() and not d.isdigit():
                shutil.rmtree(os.path.join(self.directory, d))

    def all_steps(self) -> list[int]:
        return manager_steps(self.directory)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step: int) -> bool:
        return save_due(step, self.latest_step(), self.save_interval_steps)

    def save(self, step: int, state, force: bool = False) -> bool:
        """Save ``state`` (a ``train.step.TrainState``) as ``step``; False
        when the policy declines."""
        if not force and not self.should_save(step):
            return False
        if step in self.all_steps():
            raise FileExistsError(f"checkpoint for step {step} already "
                                  f"exists in {self.directory}")
        payload = {"module": _to_cpu(state.module.state_dict()),
                   "optimizer": _to_cpu(state.optimizer.state_dict()),
                   "step": int(state.step),
                   "ema": _to_cpu(state.ema)}
        _commit(os.path.join(self.directory, str(step)),
                lambda tmp: torch.save(payload, os.path.join(tmp,
                                                             _STATE_FILE)))
        steps = self.all_steps()
        if self.max_to_keep is not None:
            for old in steps[:max(0, len(steps) - self.max_to_keep)]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        return True

    def restore(self, step: int, template_state):
        """Load ``step`` into ``template_state`` in place and return it. Its
        optimizer must be built over ``module.parameters()`` in the same
        order as the saved one (``train.step.init_state`` builds it so)."""
        saved = read_step(self.directory, step)
        state = template_state
        state.module.load_state_dict(saved["module"])
        state.optimizer.load_state_dict(saved["optimizer"])
        state.step = saved["step"]
        if (saved["ema"] is None) != (state.ema is None):
            raise ValueError(f"step {step} and the template disagree on "
                             "whether the state has an EMA "
                             "(train.ema_decay)")
        if state.ema is not None:
            with torch.no_grad():
                for name, t in state.ema.items():
                    t.copy_(saved["ema"][name])
        return state

    def wait_until_finished(self) -> None:
        """Saves are synchronous: nothing to wait for."""


def make_manager(ckpt_dir: str, max_to_keep: int | None = 3,
                 save_interval_steps: int = 1000) -> CheckpointManager:
    return CheckpointManager(ckpt_dir, max_to_keep, save_interval_steps)
