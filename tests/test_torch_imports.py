"""The port imports nothing of JAX: importing every module of
dynamic_multiview_3d_torch in a fresh process leaves no jax, flax, orbax,
tensorstore, zstandard, ml_dtypes or dynamic_multiview_3d_tpu module in
sys.modules (a JAX-written checkpoint is read by the port's own Orbax
reader, tests/test_torch_orbax.py). Its data path needs none of the JAX
package's data dependencies (grain, imageio, OpenCV, TensorFlow, PIL,
google_crc32c), which the machine with the GPU lacks: it runs with all of
them blocked."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODE = """
import importlib, json, pkgutil, sys
import dynamic_multiview_3d_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(n for n in sys.modules if n.split(".")[0] in
             ("jax", "jaxlib", "flax", "orbax", "tensorstore", "zstandard",
              "ml_dtypes", "dynamic_multiview_3d_tpu"))
print(json.dumps({"names": names, "bad": bad}))
"""


def test_port_modules_import_no_jax():
    run = subprocess.run([sys.executable, "-c", CODE], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    # every module, the new ones included
    assert {f"dynamic_multiview_3d_torch.{m}" for m in (
        "api", "train.checkpoint", "train.loop", "train.metrics",
        "utils.debugging", "utils.profiling", "utils.png", "cli.train",
        "cli.snapshot", "cli.eval", "cli.predict", "cli.make_dataset",
        "data.frames", "data.native", "data.pipeline", "data.resident",
        "data.shapenet", "data.tfrecords", "serving",
        "cli.export_model", "parallel.mesh", "parallel.dryrun",
        "train.orbax", "utils.zstd", "utils.cxx", "train.jax_state",
        "train.tf1")} \
        <= set(out["names"])


STACK = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore",
         "zstandard", "ml_dtypes", "tensorflow", "dynamic_multiview_3d_tpu")

CHECKPOINTS = """
import json, sys
for name in %r:
    sys.modules[name] = None          # an import of it raises ImportError
from dynamic_multiview_3d_torch.cli import snapshot, train
from dynamic_multiview_3d_torch.train import checkpoint, jax_state, loop, tf1
print(json.dumps(sorted(n for n in sys.modules if sys.modules[n] is not None
                        and n.split(".")[0] in %r)))
""" % (STACK, STACK)


def test_checkpoint_modules_import_with_the_jax_stack_blocked():
    """The modules that read and write JAX and TensorFlow checkpoints
    (train/jax_state.py, train/tf1.py, train/checkpoint.py) and the loop
    and CLIs above them import in a process where JAX, flax, optax, Orbax,
    tensorstore, zstandard and TensorFlow cannot be imported."""
    run = subprocess.run([sys.executable, "-c", CHECKPOINTS], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert json.loads(run.stdout.strip().splitlines()[-1]) == []


BENCH = """
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("bench_torch", "bench_torch.py")
bench = importlib.util.module_from_spec(spec)
spec.loader.exec_module(bench)
from dynamic_multiview_3d_torch.parallel import dryrun, mesh
bad = sorted(n for n in sys.modules if n.split(".")[0] in
             ("jax", "jaxlib", "flax", "orbax", "dynamic_multiview_3d_tpu"))
print(json.dumps(bad))
"""


BENCH_BLOCKED = ("jax", "flax", "orbax", "grain", "cv2", "tensorflow")

BENCH_C5 = """
import json, sys
for name in %r:
    sys.modules[name] = None          # an import of it raises ImportError
import bench_torch
line = bench_torch.main([
    "--preset", "c5", "--device", "cpu", "--iters", "1", "--warmup", "1",
    "--set", "data.grain_workers=0", "--set", "model.image_size=32",
    "--set", "data.image_size=32", "--set", "model.num_levels=3",
    "--set", "model.base_features=8", "--set", "model.max_features=16",
    "--set", "model.gru_features=16"])
bad = sorted(n for n in sys.modules if sys.modules[n] is not None
             and n.split(".")[0] in %r + ("jaxlib", "dynamic_multiview_3d_tpu"))
print(json.dumps({"line": line, "bad": bad}))
""" % (BENCH_BLOCKED, BENCH_BLOCKED)


def test_bench_script_and_parallel_import_no_jax():
    """bench_torch.py (a script at the repo root, not in the package) and
    the parallel modules import no JAX; ``--preset c5`` at tiny widths on
    the CPU (the compute-only step and the input goodput: png and packed
    exports read by the stream iterator) runs with jax, flax, orbax,
    grain, OpenCV and TensorFlow blocked, and imports none of them."""
    run = subprocess.run([sys.executable, "-c", BENCH], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert json.loads(run.stdout.strip().splitlines()[-1]) == []
    run = subprocess.run([sys.executable, "-c", BENCH_C5], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    line = out["line"]
    assert line["config"] == "c5_multihost256" and line["backend"] == "cpu"
    for key in ("input_png_examples_per_sec_per_host",
                "input_packed_examples_per_sec_per_host",
                "train256_steps_per_sec_per_chip_compute"):
        assert line[key] > 0, key


BLOCKED = ("grain", "imageio", "cv2", "tensorflow", "PIL", "google_crc32c")

DATA_PATH = """
import json, os, sys, tempfile
for name in %r:
    sys.modules[name] = None          # an import of it raises ImportError
import numpy as np
from dynamic_multiview_3d_torch import config
from dynamic_multiview_3d_torch.data import (frames, pipeline, resident,
                                             shapenet, tfrecords)
tmp = tempfile.mkdtemp()
kw = dict(num_scenes=2, image_size=16, num_views=3, seq_len=2)
roots = {"png": frames.export_synthetic(tmp + "/png", fmt="png", **kw),
         "packed": frames.export_synthetic(tmp + "/packed", fmt="packed",
                                           **kw),
         "tfrecords": tfrecords.export_tfrecords(tmp + "/tfr", **kw),
         "shapenet_dir": shapenet.export_fixture(tmp + "/snet",
                                                 num_scenes=2,
                                                 image_size=16, num_views=3)}
shapes = {}
for name, root in roots.items():
    source = "frames" if name in ("png", "packed") else name
    cfg = config.get_config("default", [
        f"data.source={source}", f"data.root={root}", "data.image_size=16",
        "data.seq_len=1", "data.num_targets=2", "data.batch_size=2",
        "data.grain_workers=0"]).data
    src = pipeline.make_source(cfg)
    shapes[name] = list(src.batch(range(2))["tgt_images"].shape)
    batch = next(pipeline.make_stream_iterator(cfg))
    assert batch["image_seq"].dtype == np.uint8
    if name == "packed":
        res = resident.ResidentFrames(src, cfg, device="cpu")
        idx = res.index_batch(range(2))
        got = res.gather(res.frames, res.poses, idx)
        assert (got["image_seq"].numpy() == src.batch(
            range(2), raw=True)["image_seq"]).all()
        drawn = res.device_sample(res.sample_meta(), 0, 0, 2)
        shapes["device_sample"] = list(drawn["tgt_images"].shape)
bad = sorted(n for n in sys.modules if sys.modules[n] is not None
             and n.split(".")[0] in %r + ("jax", "jaxlib", "flax",
                                          "dynamic_multiview_3d_tpu"))
print(json.dumps({"shapes": shapes, "bad": bad}))
""" % (BLOCKED, BLOCKED)


def test_data_path_runs_without_the_jax_data_dependencies():
    """Export png, packed, tfrecord and shapenet data, read each through
    make_source, take a streamed batch, a resident gather and a device
    draw, in a process where the JAX package's data dependencies cannot be
    imported: none of them, and no jax, ends up imported."""
    run = subprocess.run([sys.executable, "-c", DATA_PATH], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert out["shapes"] == {"png": [2, 2, 16, 16, 3],
                             "packed": [2, 2, 16, 16, 3],
                             "tfrecords": [2, 2, 16, 16, 3],
                             "shapenet_dir": [2, 2, 16, 16, 3],
                             "device_sample": [2, 2, 16, 16, 3]}
