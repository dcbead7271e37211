"""The port imports nothing of JAX: importing every module of
dynamic_multiview_3d_torch in a fresh process leaves no jax, flax, orbax,
tensorstore or dynamic_multiview_3d_tpu module in sys.modules
(``tensorstore`` is imported only when a JAX-written checkpoint is read,
tests/test_torch_checkpoint.py)."""

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
             ("jax", "jaxlib", "flax", "orbax", "tensorstore",
              "dynamic_multiview_3d_tpu"))
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
        "cli.snapshot", "cli.eval", "cli.predict")} <= set(out["names"])
