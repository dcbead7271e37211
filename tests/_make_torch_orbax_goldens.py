"""Regenerate tests/torch_goldens/jax_orbax/: checkpoints written by the JAX
package (Orbax, through tensorstore) that the port's own Orbax reader
(dynamic_multiview_3d_torch/train/orbax.py) must read on a machine with
neither JAX nor tensorstore.

    JAX_PLATFORMS=cpu python tests/_make_torch_orbax_goldens.py \
        [c2_adam_run | c2_stream_run | c3md_sampled_run | c2_stream2_run]

(with a fixture's name it rewrites that fixture alone and its entries of
``expected.npz``). Writes, at the tiny widths of tests/test_torch_loop.py (f32,
``warp_precision=exact``):

- ``c2_model/``: a c2 flow model dir (``Model.save_checkpoint``, step 3);
- ``c3md_model/``: a c3md model dir (multidepth, shared heads, T = 3),
  step 5;
- ``c2_run/``: a c2 run dir from ``train.loop.train``: its
  ``train_config.json`` and the manager step ``1/default/`` (one SGD step,
  ``train.ema_decay=0.5``, so the step holds params, EMA params and an
  optimizer state); SGD keeps the three dirs under 1 MB together;
- ``c2_adam_run/``: a c2 run dir that ``train.loop.train`` left at step 2
  of 3 (``ADAM_RUN``: adamw, cosine lr with a warmup step, EMA): its
  ``train_config.json`` and the manager step ``2/default/`` (params, EMA,
  ``ScaleByAdamState``, the schedule's count), which the port resumes;
- ``c2_stream_run/``: the run of ``c2_adam_run`` streamed through Grain
  (``STREAM_RUN``: ``data.streaming=true``, ``data.grain_workers=2``, 5
  scenes in batches of 2, so batches straddle epochs; 4 steps), stopped
  at step 2: its ``train_config.json``, the manager step ``2/default/``
  and the Grain iterator's state beside it, ``grain_state_2_p0.json``;
- ``c3md_sampled_run/``: the c3md preset at these widths with
  ``SAMPLED_RUN`` (``c2_adam_run``'s optimizer; T = 3, 4 scenes, one step
  a dispatch, 4 steps): resident and device-sampled, so its examples are
  ``jax.random`` draws; stopped at step 2: ``train_config.json`` and
  ``2/default/``;
- ``c2_stream2_run/``: ``c2_stream_run`` run by 2 processes
  (``jax.distributed`` on the CPU, one device each, ``mesh.data=2``):
  each streams its own Grain shard in batches of 1 and writes its state;
  stopped at step 2: ``train_config.json``, ``2/default/`` and
  ``grain_state_2_p0.json``, ``grain_state_2_p1.json``;
- ``expected.npz``: ``sha256/<dir>/<leaf>``, the digest of every leaf as
  tensorstore reads it (``leaf_digest``); ``inputs/<model>/{seq,src,tgt}``,
  seeded numpy inputs; ``views/<model>``, the JAX model's views for them
  (``views/c2_run`` from the run's EMA params, which ``cli.snapshot``
  exports); ``c2_adam_run/loss``, the JAX loop's loss at step 3, and
  ``c2_adam_run/params/<leaf>`` and ``c2_adam_run/mu/<leaf>``, its params
  and Adam's first moment after step 3 (whence its step-3 gradient);
  ``c2_stream_run/records``, the record indices of the batch of each of
  the uninterrupted run's 4 steps (found by matching each row to the
  source's examples), ``c2_stream_run/loss``, ``c2_stream_run/params/*``
  and ``c2_stream_run/mu/*`` after its step 3, and
  ``c2_stream_run/grain_state_4``, the text of its
  ``grain_state_4_p0.json``; ``c3md_sampled_run/rows/<name>``, the row
  indices its steps gathered (``seq_idx``, ``tgt_idx``, ``src_pose_idx``,
  ``tgt_pose_idx`` [4 steps, B, n], caught inside the compiled step),
  ``c3md_sampled_run/loss``, ``c3md_sampled_run/params/*`` and
  ``c3md_sampled_run/mu/*`` after its step 3;
  ``c2_stream2_run/records`` [process, step], the record index each
  process's batch held at each of the 4 steps, ``c2_stream2_run/loss``
  at step 3, and ``c2_stream2_run/grain_state_4_p<p>``, the text of each
  process's state after step 4.

Uses JAX, Orbax and tensorstore only; imports nothing of the port.
"""

import hashlib
import json
import os
import shutil
import sys
import tempfile

import jax
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from dynamic_multiview_3d_tpu import config as jconfig  # noqa: E402
from dynamic_multiview_3d_tpu.api import Model  # noqa: E402

OUT = os.path.join(REPO, "tests", "torch_goldens", "jax_orbax")
TINY = ["model.image_size=32", "model.num_levels=3", "model.base_features=8",
        "model.max_features=16", "model.gru_features=16",
        "model.pose_embed_dim=8", "model.dtype=float32",
        "model.use_pallas=False", "data.image_size=32",
        "model.warp_precision=exact"]
MODELS = {"c2_model": ("c2", [], 3, 11),
          "c3md_model": ("c3md", ["data.seq_len=3"], 5, 12)}
RUN = ["train.optimizer=sgd", "train.ema_decay=0.5", "train.lr=0.05",
       "train.num_steps=1", "train.ckpt_every=1", "train.log_every=1",
       "data.batch_size=2", "data.num_scenes=2", "mesh.data=1"]
ADAM_RUN = ["train.optimizer=adamw", "train.weight_decay=0.01",
            "train.lr_schedule=cosine", "train.warmup_steps=1",
            "train.ema_decay=0.9", "train.lr=1e-3", "train.num_steps=3",
            "train.ckpt_every=1", "train.log_every=1", "data.batch_size=2",
            "data.num_scenes=2", "mesh.data=1"]
STREAM_RUN = ADAM_RUN + ["data.streaming=true", "data.grain_workers=2",
                         "data.num_scenes=5", "data.batch_size=2",
                         "train.num_steps=4"]
SAMPLED_RUN = ADAM_RUN + ["data.seq_len=3", "data.num_scenes=4",
                          "train.steps_per_dispatch=1", "train.num_steps=4"]
STREAM2_RUN = STREAM_RUN + ["mesh.data=2"]
# c3md_sampled_run's step-3 forward kept in expected.npz: the loss's inputs
# and the reprojection's (coords [B*K*T, H, W, 2], z_ok [B*K*T, H, W])
FORWARD = ("view", "mask", "geo_view", "geo_valid", "tgt_images", "coords",
           "z_ok")
FIXTURE_RUNS = ("c2_adam_run", "c2_stream_run", "c3md_sampled_run",
                "c2_stream2_run")


def leaf_digest(a) -> str:
    """sha256 of a leaf's dtype name, shape and C-order bytes."""
    a = np.ascontiguousarray(a)
    head = f"{a.dtype.name}|{','.join(map(str, a.shape))}|".encode()
    return hashlib.sha256(head + a.tobytes()).hexdigest()


def ts_read(directory: str) -> dict:
    """Every leaf of an Orbax dir as tensorstore reads it."""
    import tensorstore as ts
    with open(os.path.join(directory, "_METADATA")) as f:
        meta = json.load(f)
    out = {}
    for leaf in meta["tree_metadata"].values():
        if leaf["value_metadata"].get("skip_deserialize"):
            continue                                   # a None leaf
        keys = [str(k["key"]) for k in leaf["key_metadata"]]
        spec = {"driver": "zarr",
                "kvstore": {"driver": "ocdbt", "base": f"file://{directory}",
                            "path": ".".join(keys)}}
        out["/".join(keys)] = ts.open(spec, open=True).result().read() \
            .result()
    return out


def smooth_inputs(seed: int, t: int, size: int = 32):
    """Smooth seeded images in [-1, 1] [2, t, size, size, 3], and source
    and target poses (azimuth, elevation, radius) [2, t, 3] / [2, 3, 3]."""
    rng = np.random.default_rng(seed)
    y, x = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size),
                       indexing="ij")
    f = rng.uniform(0.5, 2.0, (2, t, 1, 1, 3, 2))
    ph = rng.uniform(0, 2 * np.pi, (2, t, 1, 1, 3))
    seq = np.sin(2 * np.pi * (f[..., 0] * x[..., None]
                              + f[..., 1] * y[..., None]) + ph)
    seq = (0.9 * seq).astype(np.float32)

    def poses(n):
        return np.stack([rng.uniform(-0.6, 0.6, (2, n)),
                         rng.uniform(0.1, 0.5, (2, n)),
                         rng.uniform(1.8, 2.2, (2, n))], -1).astype(np.float32)
    return seq, poses(t), poses(3)


def make_adam_run(expected: dict) -> None:
    """``c2_adam_run/``: one JAX run of 3 steps; its step 2 is kept, its
    step-3 loss and params go into ``expected``."""
    from dynamic_multiview_3d_tpu.train import loop as jloop

    run = os.path.join(OUT, "c2_adam_run")
    shutil.rmtree(run, ignore_errors=True)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = jconfig.get_config("c2", TINY + ADAM_RUN
                                 + [f"train.ckpt_dir={tmp}/run"])
        state, metrics = jloop.train(cfg)
        os.makedirs(run)
        shutil.copy(os.path.join(tmp, "run", "train_config.json"), run)
        shutil.copytree(os.path.join(tmp, "run", "2"), os.path.join(run, "2"))
    for k, v in ts_read(os.path.join(run, "2", "default")).items():
        expected[f"sha256/c2_adam_run/2/default/{k}"] = leaf_digest(v)
    expected["c2_adam_run/loss"] = np.float64(metrics["loss/total"])
    for name, tree in (("params", state.params),
                       ("mu", state.opt_state[0].mu)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(p.key) for p in path)
            expected[f"c2_adam_run/{name}/{key}"] = np.asarray(leaf)


class _Recorder:
    """A Grain iterator that keeps each batch it yields."""

    def __init__(self, it):
        self.it, self.batches = it, []

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self.it)
        self.batches.append(batch)
        return batch

    def get_state(self):
        return self.it.get_state()

    def set_state(self, state):
        self.it.set_state(state)


class _Losses:
    """A metrics writer that keeps the loss of each step."""
    has_images = False

    def __init__(self):
        self.loss = {}

    def write(self, step, metrics):
        self.loss[step] = metrics["loss/total"]


def make_stream_run(expected: dict) -> None:
    """``c2_stream_run/``: one streamed JAX run of 4 steps; its step 2 and
    Grain state are kept, its batches' records, its step 3 and its Grain
    state after step 4 go into ``expected``."""
    from dynamic_multiview_3d_tpu.data import pipeline as jpipeline
    from dynamic_multiview_3d_tpu.train import loop as jloop

    run = os.path.join(OUT, "c2_stream_run")
    shutil.rmtree(run, ignore_errors=True)
    make = jpipeline.make_grain_iterator
    recorders = []

    def recorded(*args, **kwargs):
        recorders.append(_Recorder(make(*args, **kwargs)))
        return recorders[-1]
    with tempfile.TemporaryDirectory() as tmp:
        cfg = jconfig.get_config("c2", TINY + STREAM_RUN
                                 + [f"train.ckpt_dir={tmp}/run"])
        losses = _Losses()
        jpipeline.make_grain_iterator = recorded
        try:
            jloop.train(cfg, writer=losses)
        finally:
            jpipeline.make_grain_iterator = make
        os.makedirs(run)
        for name in ("train_config.json", "grain_state_2_p0.json"):
            shutil.copy(os.path.join(tmp, "run", name), run)
        shutil.copytree(os.path.join(tmp, "run", "2"), os.path.join(run, "2"))
        with open(os.path.join(tmp, "run", "grain_state_4_p0.json")) as f:
            expected["c2_stream_run/grain_state_4"] = np.array(f.read())
        after = ts_read(os.path.join(tmp, "run", "3", "default"))
    for k, v in ts_read(os.path.join(run, "2", "default")).items():
        expected[f"sha256/c2_stream_run/2/default/{k}"] = leaf_digest(v)
    source = jpipeline.make_source(cfg.data)
    examples = [source.example(i, raw=True)
                for i in range(cfg.data.num_scenes)]
    records = [[i for i, e in enumerate(examples)
                if all(np.array_equal(e[k], b[k][r]) for k in e)]
               for b in recorders[0].batches
               for r in range(len(b["image_seq"]))]
    assert all(len(r) == 1 for r in records), records
    expected["c2_stream_run/records"] = np.array(records).reshape(4, -1)
    expected["c2_stream_run/loss"] = np.float64(losses.loss[3])
    for name, prefix in (("params", "params/"), ("mu", "opt_state/0/mu/")):
        for k, v in after.items():
            if k.startswith(prefix):
                expected[f"c2_stream_run/{name}/{k[len(prefix):]}"] = v


def _after_step(run: str, step: int, name: str, expected: dict) -> None:
    """``<name>/params/*`` and ``<name>/mu/*``: the params and Adam's first
    moment of ``run``'s manager step ``step``."""
    after = ts_read(os.path.join(run, str(step), "default"))
    for key, prefix in (("params", "params/"), ("mu", "opt_state/0/mu/")):
        for k, v in after.items():
            if k.startswith(prefix):
                expected[f"{name}/{key}/{k[len(prefix):]}"] = v


def _keep(src: str, run: str, names: tuple, step: int = 2) -> None:
    os.makedirs(run)
    for name in names:
        shutil.copy(os.path.join(src, name), run)
    shutil.copytree(os.path.join(src, str(step)), os.path.join(run, str(step)))


def make_sampled_run(expected: dict) -> None:
    """``c3md_sampled_run/``: one device-sampled JAX run of 4 steps; its
    step 2 is kept, the rows each step gathered, its step-3 loss and
    params go into ``expected``."""
    from dynamic_multiview_3d_tpu.data import resident as jresident
    from dynamic_multiview_3d_tpu.train import loop as jloop

    name = "c3md_sampled_run"
    run = os.path.join(OUT, name)
    shutil.rmtree(run, ignore_errors=True)
    from dynamic_multiview_3d_tpu.ops import reproject as jreproject
    from dynamic_multiview_3d_tpu.train import losses as jlosses

    rows, forwards, traced = [], [], {}
    gather = jresident.ResidentFrames.gather
    reproject, total = jreproject.reproject_coords, jlosses.total_loss

    def caught(frames, poses, idx):
        jax.debug.callback(lambda i: rows.append(
            {k: np.asarray(v) for k, v in i.items()}), idx, ordered=True)
        return gather(frames, poses, idx)

    def traced_coords(*args, **kwargs):
        traced["geo"] = reproject(*args, **kwargs)
        return traced["geo"]

    def caught_loss(out, batch, *args, **kwargs):
        loss, metrics = total(out, batch, *args, **kwargs)
        jax.debug.callback(
            lambda *a: forwards.append([np.asarray(x) for x in a]),
            loss, *(out[k] for k in FORWARD[:4]), batch["tgt_images"],
            *traced.pop("geo"))
        return loss, metrics
    with tempfile.TemporaryDirectory() as tmp:
        cfg = jconfig.get_config("c3md", TINY + SAMPLED_RUN
                                 + [f"train.ckpt_dir={tmp}/run"])
        losses = _Losses()
        jresident.ResidentFrames.gather = staticmethod(caught)
        jreproject.reproject_coords = traced_coords
        jlosses.total_loss = caught_loss
        try:
            jloop.train(cfg, writer=losses)
        finally:
            jresident.ResidentFrames.gather = gather
            jreproject.reproject_coords = reproject
            jlosses.total_loss = total
        _keep(os.path.join(tmp, "run"), run, ("train_config.json",))
        _after_step(os.path.join(tmp, "run"), 3, name, expected)
    for k, v in ts_read(os.path.join(run, "2", "default")).items():
        expected[f"sha256/{name}/2/default/{k}"] = leaf_digest(v)
    assert len(rows) == 4, len(rows)
    for k in rows[0]:
        expected[f"{name}/rows/{k}"] = np.stack([r[k] for r in rows])
    expected[f"{name}/loss"] = np.float64(losses.loss[3])
    # the forward of step 3, as its loss saw it (one callback a step)
    assert len(forwards) == 4, len(forwards)
    loss, *step3 = forwards[2]
    assert np.float32(loss) == np.float32(losses.loss[3])
    for k, v in zip(FORWARD, step3):
        expected[f"{name}/step3/{k}"] = v


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def stream_process(port: str, pid: int, run: str) -> None:
    """One of ``c2_stream2_run``'s 2 JAX processes (a child of
    ``make_stream2_run``): the loop with its Grain batches recorded; its
    records and losses to ``<run>_p<pid>.json``. The loop's model export
    is skipped (process 0 alone would wait on the other at Orbax's
    barrier)."""
    from dynamic_multiview_3d_tpu.data import pipeline as jpipeline
    from dynamic_multiview_3d_tpu.train import loop as jloop

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(f"localhost:{port}", num_processes=2,
                               process_id=pid)
    cfg = jconfig.get_config("c2", TINY + STREAM2_RUN
                             + [f"train.ckpt_dir={run}"])
    make = jpipeline.make_grain_iterator
    recorders = []

    def recorded(*args, **kwargs):
        recorders.append(_Recorder(make(*args, **kwargs)))
        return recorders[-1]
    jpipeline.make_grain_iterator = recorded
    jloop.ckpt_lib.save_model = lambda *args, **kwargs: None
    losses = _Losses()
    jloop.train(cfg, writer=losses)
    source = jpipeline.make_source(cfg.data)
    examples = [source.example(i, raw=True)
                for i in range(cfg.data.num_scenes)]
    records = [[i for i, e in enumerate(examples)
                if all(np.array_equal(e[k], b[k][r]) for k in e)]
               for b in recorders[0].batches
               for r in range(len(b["image_seq"]))]
    with open(f"{run}_p{pid}.json", "w") as f:
        json.dump({"records": records, "loss": losses.loss}, f)
    jax.distributed.shutdown()


def make_stream2_run(expected: dict) -> None:
    """``c2_stream2_run/``: the streamed run of 2 JAX processes; its step 2
    and both Grain states are kept, each process's records, the step-3
    loss and the states after step 4 go into ``expected``."""
    import subprocess

    name = "c2_stream2_run"
    out = os.path.join(OUT, name)
    shutil.rmtree(out, ignore_errors=True)
    with tempfile.TemporaryDirectory() as tmp:
        run = os.path.join(tmp, "run")
        port = _free_port()
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=1")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--stream-process",
             str(port), str(pid), run], env=env) for pid in (0, 1)]
        for proc in procs:
            if proc.wait(timeout=600):
                raise SystemExit(f"a process of {name} failed")
        _keep(run, out, ("train_config.json", "grain_state_2_p0.json",
                         "grain_state_2_p1.json"))
        results = []
        for pid in (0, 1):
            with open(f"{run}_p{pid}.json") as f:
                results.append(json.load(f))
            with open(os.path.join(run, f"grain_state_4_p{pid}.json")) as f:
                expected[f"{name}/grain_state_4_p{pid}"] = np.array(f.read())
    for k, v in ts_read(os.path.join(out, "2", "default")).items():
        expected[f"sha256/{name}/2/default/{k}"] = leaf_digest(v)
    assert all(len(r) == 1 for res in results for r in res["records"])
    expected[f"{name}/records"] = np.array(
        [[r[0] for r in res["records"]] for res in results])
    assert results[0]["loss"] == results[1]["loss"]
    expected[f"{name}/loss"] = np.float64(results[0]["loss"]["3"])


def main(argv) -> None:
    from dynamic_multiview_3d_tpu.train import loop as jloop

    if argv[:1] == ["--stream-process"]:
        stream_process(argv[1], int(argv[2]), argv[3])
        return
    if len(argv) == 1 and argv[0] in FIXTURE_RUNS:
        path = os.path.join(OUT, "expected.npz")
        expected = {k: v for k, v in np.load(path).items()
                    if f"{argv[0]}/" not in k}
        {"c2_adam_run": make_adam_run,
         "c2_stream_run": make_stream_run,
         "c3md_sampled_run": make_sampled_run,
         "c2_stream2_run": make_stream2_run}[argv[0]](expected)
        np.savez(path, **expected)
        print(json.dumps({"out": OUT, "entries": len(expected)}))
        return
    if argv:
        raise SystemExit(f"unknown arguments {argv}")
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    expected = {}
    views = {}
    for name, (preset, extra, step, seed) in MODELS.items():
        cfg = jconfig.get_config(preset, TINY + extra)
        Model.init_random(cfg, seed=seed).save_checkpoint(
            os.path.join(OUT, name), step=step)
        views[name] = (Model.from_checkpoint(os.path.join(OUT, name)),
                       cfg.data.seq_len)
        for k, v in ts_read(os.path.join(OUT, name, f"params_{step}")).items():
            expected[f"sha256/{name}/params_{step}/{k}"] = leaf_digest(v)

    with tempfile.TemporaryDirectory() as tmp:
        cfg = jconfig.get_config("c2", TINY + RUN
                                 + [f"train.ckpt_dir={tmp}/run"])
        jloop.train(cfg)
        run = os.path.join(OUT, "c2_run")
        os.makedirs(run)
        shutil.copy(os.path.join(tmp, "run", "train_config.json"), run)
        shutil.copytree(os.path.join(tmp, "run", "1"),
                        os.path.join(run, "1"))
        views["c2_run"] = (Model.from_checkpoint(os.path.join(tmp, "run",
                                                              "model")), 1)
    for k, v in ts_read(os.path.join(run, "1", "default")).items():
        expected[f"sha256/c2_run/1/default/{k}"] = leaf_digest(v)
    make_adam_run(expected)
    make_stream_run(expected)
    make_sampled_run(expected)
    make_stream2_run(expected)

    for i, (name, (model, t)) in enumerate(views.items()):
        seq, src, tgt = smooth_inputs(100 + i, t)
        expected[f"inputs/{name}/seq"] = seq
        expected[f"inputs/{name}/src"] = src
        expected[f"inputs/{name}/tgt"] = tgt
        expected[f"views/{name}"] = np.asarray(
            model.predict(seq, tgt, source_poses=src), np.float32)
    np.savez(os.path.join(OUT, "expected.npz"), **expected)
    print(json.dumps({"out": OUT, "entries": len(expected)}))


if __name__ == "__main__":
    main(sys.argv[1:])
