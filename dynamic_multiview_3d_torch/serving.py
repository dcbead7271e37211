"""Serving export: a self-contained inference artifact (port of serving.py).

The JAX package ships inference as ``jax.export`` StableHLO; the port ships
``torch.export`` programs, with the weights and config beside them in ONE
zip:

    artifact.dmv3d  (zip)
      ├── predict.pt2         torch.export.save of the predict program at the
      │                       first source count T
      ├── predict_T{t}.pt2    one more program per further T when exported
      │                       with seq_len=(...): the loader dispatches on
      │                       image_seq.shape[1]
      ├── params.npz          {state-dict name: float32 ndarray}
      ├── config.json         the full Config
      └── manifest.json       shapes, signatures, the dmv3d:: operators the
                              programs call, api version

A program is ``fn(flat_params, image_seq, src_poses, tgt_poses) -> view``
(``torch.func.functional_call`` over the sorted state-dict names): the
weights stay outside it and are fed as its first input, as the JAX
artifact feeds them. Its kernels are the registered operators of
``kernels/`` (``dmv3d::warp_composite_fwd``, ``sample_fwd``,
``multiflow_composite_fwd``, ``reproject_sample_fwd``,
``reproject_composite_fwd`` and the frame staging ``dmv3d::stage``): their
CPU implementations are the plain versions and their CUDA ones the
hand-written kernels, so a program served on the card launches the same
kernels as ``Model.predict``, and one served on the CPU runs the plain
versions. Export traces a CPU copy of the model (no card needed, as JAX
lowers without the TPU); the loader moves the programs to the card.

    from dynamic_multiview_3d_torch import serving
    serving.export_predict(model, "/path/artifact.dmv3d",
                           batch=1, seq_len=1, num_targets=8)
    served = serving.ServedModel.load("/path/artifact.dmv3d")   # the card
    views = served.predict(image_seq, target_poses)   # fixed shapes

A served model needs torch, numpy and the port's kernel modules, which
register the operators: none of the model code (``models/``) is imported
at load time (the program IS the model).

``ServedModel.load`` also serves the JAX package's artifact
(``dynamic_multiview_3d_tpu.serving``: ``predict*.stablehlo``, flat flax
``params.npz``, ``config.json``, ``manifest.json``) with no JAX: it never
reads the StableHLO, but rebuilds the model from the artifact's own config
and weights and traces the port's programs in memory at the manifest's
shapes, with the code ``export_predict`` uses. That trace is paid at
every load (seconds at full width); ``cli/export_model.py --ckpt
<jax artifact>`` pays it once and writes the port's artifact.
"""

from __future__ import annotations

import copy
import importlib
import io
import json
import zipfile

import numpy as np
import torch

from dynamic_multiview_3d_torch import config as config_lib

# 2: the programs take a symbolic batch (any batch, e.g. a mesh rank's
# rows); version 1 programs take the exported batch only
MANIFEST_VERSION = 2
# the newest manifest of the JAX package's artifacts this loader reads
# (dynamic_multiview_3d_tpu.serving.MANIFEST_VERSION): a version of its
# own, not the port's
JAX_MANIFEST_VERSION = 1
FORMAT = "torch.export"
PLATFORMS = ["cpu", "cuda"]
DEFAULT_POSE = (0.0, 0.3, 2.0)       # api.DEFAULT_POSE, kept in the manifest
# the modules whose import registers the dmv3d:: operators
KERNEL_MODULES = ("dynamic_multiview_3d_torch.kernels.grid_sample",
                  "dynamic_multiview_3d_torch.kernels.multiflow",
                  "dynamic_multiview_3d_torch.kernels.reproject")


def _device(device=None) -> torch.device:
    """``device`` as a torch.device, "cuda" when None; raises where CUDA is
    asked for and absent (no fallback to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to serve on the CPU")
    return dev


def custom_ops(program) -> set[str]:
    """The ``dmv3d::`` operators an exported program calls."""
    return {node.target._schema.name for node in program.graph.nodes
            if node.op == "call_function"
            and isinstance(node.target, torch._ops.OpOverload)
            and node.target.namespace == "dmv3d"}


def register_ops(names) -> None:
    """Import the kernel modules, which register the ``dmv3d::``
    operators, and raise naming any of ``names`` that is still missing."""
    for module in KERNEL_MODULES:
        importlib.import_module(module)
    missing = [name for name in names
               if not hasattr(torch.ops.dmv3d, name.split("::", 1)[1])]
    if missing:
        raise RuntimeError(f"the artifact calls operators this process has "
                           f"not registered: {missing}")


def _moved(programs: dict, dev: torch.device) -> dict:
    """The programs with every tensor and device argument on ``dev``."""
    if dev.type == "cpu":
        return programs
    from torch.export.passes import move_to_device_pass
    return {t: move_to_device_pass(p, dev) for t, p in programs.items()}


class _Predict(torch.nn.Module):
    """The exported function: (flat_params, image_seq, src_poses,
    tgt_poses) -> view. The model is held outside the module tree, so no
    weight becomes part of the program."""

    def __init__(self, module: torch.nn.Module, names: list[str]):
        super().__init__()
        self._names = names
        self._model = (module,)

    def forward(self, flat_params, image_seq, src_poses, tgt_poses):
        params = dict(zip(self._names, flat_params))
        return torch.func.functional_call(
            self._model[0], params, (image_seq, src_poses, tgt_poses))["view"]


def _seq_lens(cfg, seq_len) -> tuple[int, ...]:
    if seq_len is None:
        return (cfg.data.seq_len,)
    if isinstance(seq_len, int):
        return (seq_len,)
    ts = tuple(seq_len)
    if len(set(ts)) != len(ts):
        raise ValueError(f"duplicate seq_len entries: {ts}")
    return ts


def trace_predict(model, batch: int = 1,
                  seq_len: int | tuple[int, ...] | None = None,
                  num_targets: int = 1) -> tuple[dict, dict]:
    """The programs of ``model``'s forward (an ``api.Model``), traced on a
    CPU copy of its module: ({T: ExportedProgram}, primary T first;
    {state-dict name: float32 tensor}, the weights they take in sorted
    name order). They take any leading (batch) size; the other shapes
    are fixed at ``seq_len`` (one program per T), ``num_targets`` and the
    model's image size. Baked multi-source heads fail for any T but the
    one they were made for, as in the JAX package."""
    cfg = model.cfg
    ts = _seq_lens(cfg, seq_len)
    s = cfg.model.image_size
    module = copy.deepcopy(model.module).to("cpu").eval()
    state = {k: v.detach().to(torch.float32)
             for k, v in module.state_dict().items()}
    names = sorted(state)
    fn = _Predict(module, names)
    flat = tuple(state[n] for n in names)
    pose = torch.tensor(DEFAULT_POSE, dtype=torch.float32)
    rows = torch.export.Dim("batch", min=1, max=1 << 16)
    dynamic = (tuple(None for _ in flat),) + ({0: rows},) * 3
    # an example batch of 1 would specialize the batch to 1 (torch.export
    # treats sizes 0 and 1 as constants), so trace at 2 rows at least
    b = max(batch, 2)
    programs = {}
    with torch.no_grad():
        for t in ts:
            args = (flat, torch.zeros((b, t, s, s, 3)),
                    pose.expand(b, t, 3).clone(),
                    pose.expand(b, num_targets, 3).clone())
            program = torch.export.export(fn, args, dynamic_shapes=dynamic,
                                          strict=False)
            program.example_inputs = None    # they hold the weights
            programs[t] = program
    return programs, {n: state[n] for n in names}


def export_predict(model, path: str, batch: int = 1,
                   seq_len: int | tuple[int, ...] | None = None,
                   num_targets: int = 1) -> dict:
    """Export ``model``'s forward (an ``api.Model``) at fixed shapes into
    the artifact ``path``; returns its manifest. The programs take any
    leading (batch) size, so that ``ServedModel.predict(mesh=)`` can run
    a rank's rows of the exported batch; ``predict`` still holds every
    request to the exported shapes.

    The programs are traced on a CPU copy of the module (its device and
    ``model`` are left as they are; ``trace_predict``); they run on the
    CPU or, moved by the loader, on the card. ``seq_len`` may be a tuple
    of source counts: one program per T, the first the primary (kept at
    ``predict.pt2``). Shared multi-source heads serve any T; baked heads
    fail at trace time for any T but the one they were made for, as in
    the JAX package.
    """
    cfg = model.cfg
    s = cfg.model.image_size
    programs, state = trace_predict(model, batch, seq_len, num_targets)
    names = list(state)
    t0 = next(iter(programs))
    blobs, signatures, ops = {}, {}, set()
    for t, program in programs.items():
        entry = "predict.pt2" if t == t0 else f"predict_T{t}.pt2"
        buf = io.BytesIO()
        torch.export.save(program, buf)
        blobs[entry] = buf.getvalue()
        ops |= custom_ops(program)
        signatures[str(t)] = {"module": entry,
                              "image_seq": [batch, t, s, s, 3],
                              "src_poses": [batch, t, 3]}
    manifest = {
        "version": MANIFEST_VERSION,
        "format": FORMAT,
        "platforms": PLATFORMS,
        # the primary signature (the first T), which a loader without
        # "signatures" serves
        "image_seq": [batch, t0, s, s, 3],
        "src_poses": [batch, t0, 3],
        "tgt_poses": [batch, num_targets, 3],
        "view": [batch, num_targets, s, s, 3],
        "signatures": signatures,
        # the registered operators the programs call: the loader checks
        # that each is registered before it loads a program
        "custom_ops": sorted(ops),
        "param_names": names,
        "default_pose": list(DEFAULT_POSE),
        "synthesis": cfg.model.synthesis,
        "src_views": cfg.data.src_views,
        "trained_seq_len": cfg.data.seq_len,
    }
    npz = io.BytesIO()
    np.savez(npz, **{n: state[n].numpy() for n in names})
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        for entry, blob in blobs.items():
            z.writestr(entry, blob)
        z.writestr("params.npz", npz.getvalue())
        z.writestr("config.json", json.dumps(config_lib.to_dict(cfg)))
        z.writestr("manifest.json", json.dumps(manifest))
    return manifest


def is_jax_artifact(path: str) -> bool:
    """Whether ``path`` is a JAX package artifact: a zip of StableHLO
    programs and no ``torch.export`` one."""
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as z:
        entries = z.namelist()
    return (any(e.endswith(".stablehlo") for e in entries)
            and not any(e.endswith(".pt2") for e in entries))


def jax_seq_lens(manifest: dict) -> tuple[int, ...]:
    """The source counts a JAX manifest serves, primary first: its
    ``signatures``, or, in a manifest older than them, ``src_poses``'
    middle dim (the JAX loader's reading)."""
    sigs = manifest.get("signatures") or {str(manifest["src_poses"][1]): {}}
    return tuple(int(t) for t in sigs)


def read_jax_artifact(path: str, device=None) -> tuple:
    """The model a JAX package artifact holds, rebuilt from its own config
    and flat flax weights with no JAX: (``api.Model`` on ``device``, the
    card unless "cpu" is asked for; the JAX manifest; the config dict).
    Raises on a manifest version newer than ``JAX_MANIFEST_VERSION``
    (naming both), ``param_names`` other than ``params.npz``'s keys, a
    config key this port's schema lacks, a leaf that lands nowhere or an
    entry no leaf fills (``weights.from_flax``, naming them), and a
    signature at a source count the baked heads were not made for."""
    from dynamic_multiview_3d_torch import weights
    from dynamic_multiview_3d_torch.api import Model

    with zipfile.ZipFile(path) as z:
        manifest = json.loads(z.read("manifest.json"))
        if manifest["version"] > JAX_MANIFEST_VERSION:
            raise ValueError(
                f"{path}: JAX artifact manifest version "
                f"{manifest['version']} is newer than the JAX package's "
                f"MANIFEST_VERSION {JAX_MANIFEST_VERSION} this loader reads")
        cfg_dict = json.loads(z.read("config.json"))
        with np.load(io.BytesIO(z.read("params.npz"))) as npz:
            flat = {k: npz[k] for k in npz.files}
    names = manifest["param_names"]
    if sorted(names) != sorted(flat):
        raise ValueError(
            f"{path}: the manifest's param_names are not params.npz's "
            f"keys: only in param_names {sorted(set(names) - set(flat))}, "
            f"only in params.npz {sorted(set(flat) - set(names))}")
    unknown = config_lib.unknown_keys(cfg_dict)
    if unknown:
        raise ValueError(f"{path}: config.json has keys this port's config "
                         f"does not know: {unknown}")
    cfg = config_lib.from_dict(cfg_dict)
    baked = weights.baked_num_sources(flat, cfg.model)
    for t in jax_seq_lens(manifest):
        if baked is not None and t != baked:
            raise ValueError(f"{path}: a signature at T={t}, but the "
                             f"baked multi-source heads are made for "
                             f"{baked} sources")
    return Model.from_flax_params(cfg, flat, device=device), manifest, \
        cfg_dict


class ServedModel:
    """A loaded artifact on one device: fixed-shape predict, no model code
    involved (for a JAX artifact, none after the load's trace)."""

    def __init__(self, programs: dict, params, manifest: dict,
                 cfg_dict: dict, device: torch.device,
                 any_batch: bool = True):
        self.manifest = manifest
        self.cfg_dict = cfg_dict
        self.device = device
        # the weights, in the programs' input order
        self.params = tuple(torch.from_numpy(np.array(p, np.float32))
                            .to(device) for p in params)
        # whether the programs take any batch (predict(mesh=) runs a
        # rank's rows) or the exported one only
        self.any_batch = any_batch
        # one callable per exported source count T, primary first
        self._calls = {t: p.module() for t, p in programs.items()}

    @property
    def seq_lens(self) -> tuple[int, ...]:
        """Source counts this artifact serves, primary first."""
        return tuple(self._calls)

    def call_for(self, seq_len: int | None = None):
        """The program for one source count (default: the primary), as
        ``call(params, image_seq, src_poses, tgt_poses)`` on tensors of the
        served device: the validation-free path a benchmark times (call it
        under ``torch.inference_mode()``)."""
        return self._calls[self.seq_lens[0] if seq_len is None else seq_len]

    @classmethod
    def load(cls, path: str, device=None) -> "ServedModel":
        """Load the artifact ``path`` onto ``device``: the card unless the
        caller passes "cpu"; raises without a GPU. Refuses a newer manifest
        version and an artifact calling an operator this process has not
        registered.

        A JAX package artifact (StableHLO programs) is served by the
        port's own programs, traced at its manifest's batch, at each
        signature's T and at its ``tgt_poses`` K from the model its config
        and weights rebuild (``read_jax_artifact``, with its checks); its
        manifest stays the contract ``predict`` applies. The trace is paid
        at every such load (about 10 s for the c2 preset on an H100
        machine's host), and once only through ``cli/export_model.py
        --ckpt <jax artifact>``, which writes the port's artifact."""
        dev = _device(device)
        if is_jax_artifact(path):
            return cls._load_jax(path, dev)
        with zipfile.ZipFile(path) as z:
            if not any(e.endswith(".pt2") for e in z.namelist()):
                raise ValueError(f"{path} holds neither a torch.export nor "
                                 "a StableHLO program")
            manifest = json.loads(z.read("manifest.json"))
            if manifest["version"] > MANIFEST_VERSION:
                raise ValueError(
                    f"artifact version {manifest['version']} is newer than "
                    f"this loader ({MANIFEST_VERSION})")
            register_ops(manifest.get("custom_ops", ()))
            cfg_dict = json.loads(z.read("config.json"))
            # an artifact without "signatures" carries one program at the
            # primary entry; its T is src_poses' middle dim
            sigs = manifest.get("signatures") or {
                str(manifest["src_poses"][1]): {"module": "predict.pt2"}}
            programs = {int(t): torch.export.load(io.BytesIO(
                z.read(sig["module"]))) for t, sig in sigs.items()}
            with np.load(io.BytesIO(z.read("params.npz"))) as npz:
                params = [npz[n] for n in manifest["param_names"]]
        return cls(_moved(programs, dev), params, manifest, cfg_dict, dev,
                   any_batch=manifest["version"] >= 2)

    @classmethod
    def _load_jax(cls, path: str, dev: torch.device) -> "ServedModel":
        model, manifest, cfg_dict = read_jax_artifact(path, device="cpu")
        programs, state = trace_predict(
            model, batch=manifest["image_seq"][0],
            seq_len=jax_seq_lens(manifest),
            num_targets=manifest["tgt_poses"][1])
        return cls(_moved(programs, dev), state.values(), manifest,
                   cfg_dict, dev)

    def _tensor(self, x) -> torch.Tensor:
        if not torch.is_tensor(x):
            x = np.array(x, np.float32)          # a writable copy for torch
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def predict(self, image_seq, target_poses, source_poses=None,
                mesh=None) -> torch.Tensor:
        """Run the artifact: views [B, K, H, W, 3] float32 on the served
        device for image_seq [B, T, H, W, 3] (T one of ``seq_lens``) and
        target_poses [B, K, 3] at the exported shapes; source_poses
        [B, T, 3], by default the manifest's pose for single-source
        artifacts and required for multi-source ones.

        With ``mesh`` (a ``parallel.mesh.Mesh``; every rank calls with the
        whole request) each data rank runs its contiguous rows of the
        batch (model peers run the same rows, as the JAX artifact's
        ``P('data')`` does), and the views are gathered over the data axis
        so that every rank returns the whole [B, K, H, W, 3]:
        data-parallel serving without re-export (the counterpart of the
        JAX artifact's GSPMD partitioning); the exported batch must divide
        by the data ranks."""
        if mesh is not None:
            from dynamic_multiview_3d_torch.parallel import mesh as mesh_lib
            if not isinstance(mesh, mesh_lib.Mesh):
                raise TypeError(f"mesh must be a parallel.mesh.Mesh, not "
                                f"{type(mesh).__name__}")
            if not self.any_batch:
                raise ValueError("this artifact's programs take the "
                                 "exported batch only: re-export it to "
                                 "serve over a mesh")
        m = self.manifest
        image_seq = self._tensor(image_seq)
        target_poses = self._tensor(target_poses)
        t_in = image_seq.shape[1] if image_seq.dim() >= 2 else None
        call = self._calls.get(t_in)
        if call is None:
            raise ValueError(
                f"image_seq has {t_in} source frames but this artifact was "
                f"exported for T in {sorted(self._calls)} (serving "
                "artifacts are fixed-shape; re-export with "
                "seq_len=(...) for other source counts)")
        exp_image_seq = list(m["image_seq"])
        exp_image_seq[1] = t_in
        exp_src_poses = list(m["src_poses"])
        exp_src_poses[1] = t_in
        expected = {"image_seq": exp_image_seq, "src_poses": exp_src_poses,
                    "tgt_poses": m["tgt_poses"]}
        if source_poses is None:
            # multi-source artifacts blend every source frame by its own
            # camera: a broadcast canonical pose would mis-condition them
            synthesis = m.get("synthesis", "flow")
            if synthesis in ("multiflow", "multidepth"):
                raise ValueError(
                    f"this artifact was exported from a {synthesis!r} "
                    "checkpoint: predict() requires source_poses "
                    f"(shape {m['src_poses']}, az/el/radius per source "
                    "camera); a default pose would mis-condition every "
                    "source")
            pose = m.get("default_pose", DEFAULT_POSE)
            source_poses = self._tensor(pose).expand(*exp_src_poses)
        else:
            source_poses = self._tensor(source_poses)
        for name, arr in (("image_seq", image_seq),
                          ("src_poses", source_poses),
                          ("tgt_poses", target_poses)):
            if list(arr.shape) != expected[name]:
                raise ValueError(
                    f"{name} shape {list(arr.shape)} != exported "
                    f"{expected[name]} (serving artifacts are fixed-shape; "
                    "re-export for other shapes)")
        with torch.inference_mode():
            if mesh is None:
                return call(self.params, image_seq, source_poses,
                            target_poses)
            lo, hi = mesh_lib.local_rows(mesh, image_seq.shape[0])
            views = call(self.params, image_seq[lo:hi],
                         source_poses[lo:hi], target_poses[lo:hi])
            return mesh_lib.all_gather_rows(mesh, views)
