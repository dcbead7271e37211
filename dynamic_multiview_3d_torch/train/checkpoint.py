"""Checkpoints (port of train/checkpoint.py).

Two surfaces, as in the JAX package:

- model directories: ``save_model`` / ``load_model``, the format of
  ``Model.from_checkpoint``. A directory holds ``config.json``
  (``{"config": ..., "step": ...}``, the JAX schema) beside its weights,
  in one of two formats. ``fmt="pt"`` (the default): ``params_{step}.pt``,
  ``torch.save`` of a ``state_dict`` of CPU tensors, read back with
  ``weights_only=True``. ``fmt="orbax"``: the JAX package's format, an
  Orbax directory ``params_{step}/`` holding the flax tree
  (``weights.to_flax``, f32 as stored), which the JAX package's
  ``load_model`` reads. ``load_model`` reads both, the Orbax one with the
  port's own reader (``train/orbax.py``: no JAX, no tensorstore) as its
  flat flax tree. A directory is written under a temporary name and
  renamed into place, so a reader never sees half of one.
- training checkpoints: ``make_manager`` -> ``CheckpointManager``, one
  directory ``<ckpt_dir>/<step>/`` a step, in one of two layouts: the
  port's ``state.pt`` (the module's and the optimizer's ``state_dict``,
  the step and the EMA), or the JAX package's manager step
  (``<step>/default/``, Orbax, its flax ``TrainState``: params, optax
  state, step, EMA; ``train/jax_state.py`` maps it). It restores either,
  so a JAX run resumes in the port's loop, and writes the layout of the
  directory's latest step (``state.pt`` in a fresh one) unless told
  otherwise, so the JAX loop resumes a run the port continued. It decides
  when to save as Orbax's ``CheckpointManager`` does by default.
- TensorFlow 1 checkpoints: ``import_tf1_checkpoint``, the JAX package's
  function, reads a ``tf.train.Saver`` checkpoint with the port's own
  reader (``train/tf1.py``: no TensorFlow) through a name map into a flax
  tree; ``import_tf1_state_dict`` gives a module's ``state_dict`` of it.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from collections.abc import Mapping

import torch
from torch import nn

from dynamic_multiview_3d_torch import config as config_lib
from dynamic_multiview_3d_torch import weights
from dynamic_multiview_3d_torch.train import jax_state
from dynamic_multiview_3d_torch.train.orbax import (HANDLER, read_orbax,
                                                    write_orbax)
from dynamic_multiview_3d_torch.train.tf1 import BundleReader

_STATE_FILE = "state.pt"
_JAX_STEP = "default"           # Orbax's item name in a JAX manager step
FORMATS = ("pt", "orbax")


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
               step: int = 0, fmt: str = "pt") -> None:
    """Write the model directory ``path``: ``config.json`` and the module's
    ``state_dict`` (or the given one) as ``params_{step}.pt`` (``fmt="pt"``)
    or as the flax tree in the Orbax directory ``params_{step}/``
    (``fmt="orbax"``, the JAX package's format)."""
    if fmt not in FORMATS:
        raise ValueError(f"fmt must be one of {FORMATS}, not {fmt!r}")
    sd = (module_or_state_dict.state_dict()
          if isinstance(module_or_state_dict, nn.Module)
          else module_or_state_dict)
    sd = {k: _to_cpu(v) for k, v in sd.items()}

    def write(tmp):
        if fmt == "pt":
            torch.save(sd, os.path.join(tmp, f"params_{step}.pt"))
        else:
            write_orbax(os.path.join(tmp, f"params_{step}"),
                        weights.flatten(weights.to_flax(sd)))
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump({"config": config_lib.to_dict(cfg), "step": step}, f,
                      indent=2)
    _commit(path, write)


def load_model(path: str):
    """-> (weights, cfg, step). ``weights`` is the ``state_dict`` of a
    ``params_{step}.pt`` directory, or the flat flax tree ``{"a/b/c":
    ndarray}`` of an Orbax one (``weights.from_flax`` takes it)."""
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
    raise FileNotFoundError(f"{path} has neither params_{step}.pt nor "
                            f"params_{step}/ (Orbax)")


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


def is_jax_step(ckpt_dir: str, step: int) -> bool:
    """Whether the step is a JAX run's (Orbax ``<step>/default/``)."""
    return os.path.isdir(os.path.join(ckpt_dir, str(step), _JAX_STEP))


def read_jax_step(ckpt_dir: str, step: int, none_leaves: bool = False
                  ) -> dict:
    """A JAX run's manager step, its train state as a flat ``{"a/b/c":
    array}`` (``params/...``, ``ema_params/...`` when the run keeps an EMA,
    ``opt_state/...``, ``step``); with ``none_leaves`` its None leaves (the
    empty optax states, an absent EMA) too, as None."""
    return read_orbax(os.path.join(ckpt_dir, str(step), _JAX_STEP),
                      none_leaves)


def _write_jax_step(directory: str, tree: dict) -> None:
    """A manager step as the JAX package's Orbax ``CheckpointManager``
    writes it: the item ``default/`` and the step's metadata, which names
    the item's handler."""
    t0 = time.time_ns()
    write_orbax(os.path.join(directory, _JAX_STEP), tree)
    with open(os.path.join(directory, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": {_JAX_STEP: HANDLER}, "metrics": {},
                   "performance_metrics": {}, "init_timestamp_nsecs": t0,
                   "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)


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
    raises. The newest ``max_to_keep`` steps are kept (None: all), of
    either layout.

    ``fmt``: the layout of the steps it writes, "pt" (``state.pt``) or
    "orbax" (the JAX package's); None follows the directory, "orbax" when
    its latest step is a JAX one, else "pt". ``cfg``, the run's config,
    is needed to write or restore a JAX step (its optax state's layout
    follows the optimizer and the lr schedule)."""

    def __init__(self, directory: str, max_to_keep: int | None = 3,
                 save_interval_steps: int = 1000, fmt: str | None = None,
                 cfg: config_lib.Config | None = None):
        if fmt is not None and fmt not in FORMATS:
            raise ValueError(f"fmt must be one of {FORMATS} or None, not "
                             f"{fmt!r}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self.fmt = fmt
        self.cfg = cfg
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

    def step_format(self) -> str:
        """The layout ``save`` writes now."""
        if self.fmt is not None:
            return self.fmt
        latest = self.latest_step()
        return ("orbax" if latest is not None
                and is_jax_step(self.directory, latest) else "pt")

    def _config(self, what: str) -> config_lib.Config:
        if self.cfg is None:
            raise ValueError(f"{what} a JAX-layout step needs the run's "
                             "config: make_manager(..., cfg=cfg)")
        return self.cfg

    def save(self, step: int, state, force: bool = False) -> bool:
        """Save ``state`` (a ``train.step.TrainState``) as ``step``; False
        when the policy declines."""
        if not force and not self.should_save(step):
            return False
        if step in self.all_steps():
            raise FileExistsError(f"checkpoint for step {step} already "
                                  f"exists in {self.directory}")
        if self.step_format() == "orbax":
            tree = jax_state.state_to_jax(state, self._config("writing"))
            _commit(os.path.join(self.directory, str(step)),
                    lambda tmp: _write_jax_step(tmp, tree))
        else:
            payload = {"module": _to_cpu(state.module.state_dict()),
                       "optimizer": _to_cpu(state.optimizer.state_dict()),
                       "step": int(state.step),
                       "ema": _to_cpu(state.ema)}
            _commit(os.path.join(self.directory, str(step)),
                    lambda tmp: torch.save(payload,
                                           os.path.join(tmp, _STATE_FILE)))
        steps = self.all_steps()
        if self.max_to_keep is not None:
            for old in steps[:max(0, len(steps) - self.max_to_keep)]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        return True

    def restore(self, step: int, template_state):
        """Load ``step`` into ``template_state`` in place and return it. Its
        optimizer must be built over ``module.parameters()`` in the same
        order as the saved one (``train.step.init_state`` builds it so). A
        JAX step must hold the optimizer and schedule of the manager's
        ``cfg`` (``train/jax_state.py``)."""
        if is_jax_step(self.directory, step):
            return jax_state.state_from_jax(
                read_jax_step(self.directory, step, none_leaves=True),
                template_state, self._config("restoring"))
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
                 save_interval_steps: int = 1000, fmt: str | None = None,
                 cfg: config_lib.Config | None = None) -> CheckpointManager:
    return CheckpointManager(ckpt_dir, max_to_keep, save_interval_steps, fmt,
                             cfg)


# ---------------------------------------------------- TensorFlow 1 imports
def _nest(flat: dict) -> dict:
    """``{"a/b/c": leaf}`` -> the nested dict."""
    tree: dict = {}
    for path, leaf in flat.items():
        *parents, name = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


def import_tf1_checkpoint(tf1_ckpt_prefix: str, name_map: dict[str, str],
                          template_params) -> dict:
    """Map a TF1 ``tf.train.Saver`` checkpoint onto a flax params tree, as
    the JAX package's function of this name does, without TensorFlow
    (``train/tf1.py`` reads the bundle).

    ``name_map``: TF1 variable name -> '/'-joined path in
    ``template_params`` (a nested dict of arrays, e.g. ``weights.to_flax(
    module.state_dict())``), so one map serves both packages. A 4-D tensor
    whose shape differs from the template leaf's raises ``ValueError`` (TF1
    conv kernels are HWIO like flax); a 2-D one is transposed; unmapped
    leaves keep the template's values; a path not in the template raises
    ``KeyError``. -> the nested tree."""
    reader = BundleReader(tf1_ckpt_prefix)
    by_path = weights.flatten(template_params)
    out = dict(by_path)
    for tf_name, our_path in name_map.items():
        arr = reader.tensor(tf_name)
        if our_path not in by_path:
            raise KeyError(f"pytree path {our_path!r} not in params")
        want = by_path[our_path].shape
        if arr.ndim == 4 and arr.shape != want:
            raise ValueError(f"shape mismatch {arr.shape} vs {want}")
        if arr.ndim == 2 and arr.shape != want:
            arr = arr.T
        out[our_path] = arr
    return _nest(out)


def import_tf1_state_dict(tf1_ckpt_prefix: str, name_map: dict[str, str],
                          module: nn.Module) -> dict[str, torch.Tensor]:
    """``import_tf1_checkpoint`` onto ``module``'s own params, as its
    ``state_dict`` (``weights.from_flax``, strict on shapes)."""
    tree = import_tf1_checkpoint(tf1_ckpt_prefix, name_map,
                                 weights.to_flax(module.state_dict()))
    return weights.from_flax(tree, module)
