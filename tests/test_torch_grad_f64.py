"""The f32 gradients of the committed JAX run's resumed step, held to the
exact answer.

``tests/test_torch_jax_resume.py`` resumes ``tests/torch_goldens/
jax_orbax/c2_adam_run`` (the c2 preset at tiny widths, f32,
``warp_precision=exact``) at its step 2 and takes step 3 on the loop's
host batch of that step. There the port's f32 gradients and the JAX
package's differ by up to a few % on a tensor. This file computes, on that
step's weights and batch, three sets of gradients of the total loss:

- the JAX package's in float64 (``test_torch_model.py``'s ``_f64``: x64
  on, every ``float32`` the models name read as float64): the exact
  answer, to ~1e-12;
- the JAX package's in f32;
- the port's in f32 (TF32 off).

For each parameter tensor, the gap of a set from the f64 one is
``max|g - g64| / (max|g64| + tiny)``, ``tiny`` a hundredth of the
largest |g64| in the model (it keeps the two biases whose exact gradient
is zero, each feeding a GroupNorm with one channel per group, from
dividing rounding by rounding). Measured on an x86 CPU (AVX-512): the
JAX package's f32 gradients are up to 3.7e-2 from f64 (the gap of the
resume test); the port's 4.2e-7 to 1.4e-5, on every tensor at most 0.35x
as far as JAX's; in float64 the packages agree to 8e-13. So the gap
between the packages is JAX's f32 rounding on flat synthetic scenes, not
a formula of the port. The tests assert that the
port is no farther than ``FACTOR`` x JAX's gap on every tensor, that the
port's f32 gap stays under 1e-4 everywhere, and that in float64 the two
packages agree to 1e-10.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dynamic_multiview_3d_torch import config as tconfig
from dynamic_multiview_3d_torch import weights
from dynamic_multiview_3d_torch.data import pipeline as tpipeline
from dynamic_multiview_3d_torch.models import DMV3D as TDMV3D
from dynamic_multiview_3d_torch.train import checkpoint as tckpt
from dynamic_multiview_3d_torch.train import losses as tlosses
from dynamic_multiview_3d_torch.utils import jax_random as jr
from dynamic_multiview_3d_tpu import config as jconfig
from dynamic_multiview_3d_tpu.models import DMV3D as JDMV3D
from dynamic_multiview_3d_tpu.train import losses as jlosses
from test_torch_model import _f64

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "torch_goldens", "jax_orbax",
                       "c2_adam_run")
STEP = 2                 # the fixture's manager step; the next step's batch
FACTOR = 2.0             # the port's gap may be at most this x JAX's
TOL_F32 = 1e-4
TOL_F64 = 1e-10


def _wide(batch: dict) -> dict:
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v
            for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _step_inputs():
    """(port config, the fixture's params at ``STEP`` as a state_dict, the
    host batch the loop gives the next step, normalized as the step
    normalizes it)."""
    with open(os.path.join(FIXTURE, "train_config.json")) as f:
        cfg = tconfig.from_dict(json.load(f))
    flat = tckpt.read_jax_step(FIXTURE, STEP)
    sd = weights.from_flax(
        {k[len("params/"):]: v for k, v in flat.items()
         if k.startswith("params/")}, TDMV3D(cfg.model))
    b = cfg.data.batch_size
    raw = tpipeline.make_source(cfg.data).batch(
        range(STEP * b, (STEP + 1) * b), raw=True)
    key, _ = jr.step_keys(cfg.data.seed, STEP, False)
    batch = tpipeline.preprocess(raw, device="cpu", key=key,
                                 targets_per_step=cfg.data.targets_per_step)
    return cfg, sd, {k: v.numpy() for k, v in batch.items()}


def _port_grads(cfg, sd, batch, f64=False) -> dict:
    module = TDMV3D(cfg.model)
    module.load_state_dict(sd)
    if f64:
        module.double()
    bt = {k: torch.as_tensor(v) for k, v in batch.items()}
    out = module(bt["image_seq"], bt["src_poses"], bt["tgt_poses"])
    loss, _ = tlosses.total_loss(out, bt, cfg.train,
                                 synthesis=cfg.model.synthesis)
    loss.backward()
    return {n: p.grad.detach().double().numpy()
            for n, p in module.named_parameters()}


def _jax_grads(cfg, sd, batch, dtype) -> dict:
    jcfg = jconfig.from_dict(tconfig.to_dict(
        tconfig.override(cfg, [f"model.dtype={dtype}"])))
    module = JDMV3D(jcfg.model)
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype),
                          weights.to_flax(sd))

    def loss_fn(p, b):
        out = module.apply({"params": p}, b["image_seq"], b["src_poses"],
                           b["tgt_poses"])
        return jlosses.total_loss(out, b, jcfg.train,
                                  synthesis=jcfg.model.synthesis)[0]
    grads = jax.jit(jax.grad(loss_fn))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return {n: v.double().numpy() for n, v in weights.from_flax(
        jax.tree.map(np.asarray, grads), TDMV3D(cfg.model)).items()}


@functools.lru_cache(maxsize=None)
def _grads() -> dict:
    """The four gradient sets by name: jax64, jax32, port32, port64."""
    cfg, sd, batch = _step_inputs()
    torch.backends.cudnn.allow_tf32 = False
    out = {"jax32": _jax_grads(cfg, sd, batch, "float32"),
           "port32": _port_grads(cfg, sd, batch)}
    with _f64():
        cfg64 = tconfig.override(cfg, ["model.dtype=float64"])
        out["jax64"] = _jax_grads(cfg64, sd, _wide(batch), "float64")
        out["port64"] = _port_grads(cfg64, sd, _wide(batch), f64=True)
    return out


def grad_gaps(grads: dict, ref: dict) -> dict:
    """Per tensor, max |g - ref| / (max |ref| + tiny), tiny a hundredth of
    the largest |ref| in the model."""
    tiny = 1e-2 * max(float(np.abs(r).max()) for r in ref.values())
    return {n: float(np.abs(grads[n] - r).max())
            / (float(np.abs(r).max()) + tiny) for n, r in ref.items()}


def _gaps(which: str) -> dict:
    """``grad_gaps`` of the set ``which`` from the JAX f64 gradients."""
    g = _grads()
    return grad_gaps(g[which], g["jax64"])


def test_port_f32_gradients_no_farther_from_f64_than_jax():
    """The resume test's gap is JAX's f32 rounding: on every tensor the
    port's f32 gradients are at most ``FACTOR`` x as far from the f64 ones
    as the JAX package's f32 gradients are."""
    port, ref = _gaps("port32"), _gaps("jax32")
    assert sorted(port) == sorted(ref) and len(port) > 70
    farther = {n: (port[n], ref[n]) for n in port
               if not port[n] <= FACTOR * ref[n]}
    assert not farther, farther


def test_port_f32_gradients_within_tolerance_of_f64():
    gaps = _gaps("port32")
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= TOL_F32, (worst, gaps[worst])


def test_port_f64_gradients_match_jax_f64():
    """Both frameworks in float64 on the step's weights and batch: every
    gradient tensor to 1e-10."""
    gaps = _gaps("port64")
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= TOL_F64, (worst, gaps[worst])


if __name__ == "__main__":
    port, ref = _gaps("port32"), _gaps("jax32")
    for n in sorted(port, key=lambda n: -port[n] / ref[n]):
        print(f"{n:45s} port {port[n]:.3e} jax {ref[n]:.3e} "
              f"ratio {port[n] / ref[n]:.3f}")
    print("f64:", max(_gaps("port64").values()))
