"""The c1, c3 and c5 presets (``BASELINE.json``'s eval configs beside c2)
in the port against the JAX package on the CPU, and the package's
``predict``.

Each preset keeps its own ``num_levels``, T, K, ``remat_scan``,
``dynamic``, synthesis and data source (c1: static synthetic scenes, 4
levels, T = K = 1; c3: dynamic synthetic scenes, 5 levels, T = 8, K = 4,
remat; c5: the frames source with no root, ``SyntheticFrames``, 6 levels,
T = 4, K = 2, remat). What is cut: the widths, to ``base_features=8``,
``max_features=16``, ``gru_features=16``; the image, only as far as the
levels allow (c1 32², c3 32², c5 64²: a 2 x 2, 1 x 1 and 1 x 1
bottleneck); the batch, to c3's and c5's first 2 examples (c1 has 1).
The models run in f32 with TF32 off and ``warp_precision=exact``, as
every parity test (c1 is f32 by its preset; c3 and c5 compute in bf16 on
the card).

Per preset, on the same seeded weights (the port's init, handed to JAX
through ``weights.to_flax``) and the same batch, rendered by both
packages' sources and held equal:

- forward: every output within 1e-4 of the JAX model's float64 outputs
  (``test_torch_model.py``'s bound and ``_gaps``), and the port's float64
  outputs within 1e-10 of them;
- one train step through ``make_train_step`` (c3 and c5 with
  ``remat_scan``): the loss within 1e-5 relative of JAX's f64 loss, every
  gradient tensor within ``TOL_GRAD`` of JAX's f64 gradients by
  ``tests/test_torch_grad_f64.py``'s measure (c2's 1e-4 for c3; see
  ``TOL_GRAD`` for c5), and in float64 within 1e-10.

Measured on an x86 CPU (AVX-512): forward 1.6e-5 (c1), 1.3e-5 (c3),
4.9e-5 (c5) in f32, at most 2.5e-12 in f64; the step's loss 2.7e-8 /
5.6e-8 relative, its gradients 3.7e-5 / 1.7e-3 in f32 and at most 7.3e-12
in f64 (c3 / c5).
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynamic_multiview_3d_torch as tpkg
import dynamic_multiview_3d_tpu as jpkg
from dynamic_multiview_3d_torch import api as tapi
from dynamic_multiview_3d_torch import config as tconfig
from dynamic_multiview_3d_torch import weights
from dynamic_multiview_3d_torch.api import Model as TModel
from dynamic_multiview_3d_torch.data import pipeline as tpipeline
from dynamic_multiview_3d_torch.models import DMV3D as TDMV3D
from dynamic_multiview_3d_torch.train import step as tstep
from dynamic_multiview_3d_tpu import config as jconfig
from dynamic_multiview_3d_tpu.data import pipeline as jpipeline
from dynamic_multiview_3d_tpu.models import DMV3D as JDMV3D
from dynamic_multiview_3d_tpu.train import losses as jlosses
from test_torch_grad_f64 import grad_gaps
from test_torch_model import _f64, _gaps

TOL, TOL_F64 = 1e-4, 1e-10
# the f32 train step's gradients against JAX's f64 ones: c2's bound
# (tests/test_torch_grad_f64.py); on c5's batch one ReLU input at the
# decoder's full resolution lies 4.5e-7 from zero and takes the other sign
# in f32 (the port's f32 and f64 backward compared layer by layer: the
# gradient there is 8.8e-6 off against 1.8e-8 elsewhere), which moves the
# gradients below it by up to 1.7e-3
TOL_GRAD = {"c3": 1e-4, "c5": 5e-3}
WIDTHS = ["model.base_features=8", "model.max_features=16",
          "model.gru_features=16", "model.dtype=float32",
          "model.warp_precision=exact"]
# image size (the smallest the preset's levels allow) and batch
CUTS = {"c1": (32, 1), "c3": (32, 2), "c5": (64, 2)}
KEEPS = {"c1": (4, 1, 1, False, False, "synthetic"),
         "c3": (5, 8, 4, True, True, "synthetic"),
         "c5": (6, 4, 2, True, True, "frames")}


def _configs(preset: str):
    size, b = CUTS[preset]
    sets = WIDTHS + [f"model.image_size={size}", f"data.image_size={size}",
                     f"data.batch_size={b}", "data.num_scenes=4"]
    tcfg = tconfig.get_config(preset, sets)
    return tcfg, jconfig.from_dict(tconfig.to_dict(tcfg))


@functools.lru_cache(maxsize=None)
def _source_batch(preset: str):
    """The preset's first batch (uint8) from each package's source."""
    tcfg, jcfg = _configs(preset)
    b = tcfg.data.batch_size
    with pytest.warns(UserWarning, match="SyntheticFrames") \
            if tcfg.data.source == "frames" else contextlib.nullcontext():
        ours = tpipeline.make_source(tcfg.data).batch(range(b), raw=True)
        ref = jpipeline.make_source(jcfg.data).batch(range(b), raw=True)
    return ours, ref


@functools.lru_cache(maxsize=None)
def _setup(preset: str):
    """(port config, seeded state_dict, the batch normalized as the train
    step normalizes it, in float64: the f64 runs' input, exactly)."""
    tcfg, _ = _configs(preset)
    sd = TModel.init_random(tcfg, seed=0, device="cpu").module.state_dict()
    with _f64():
        batch = tpipeline.preprocess(_source_batch(preset)[0], device="cpu")
    return tcfg, sd, {k: v.numpy() for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_f64(preset: str):
    """The JAX model in float64: (outputs, loss, gradients by port name)."""
    tcfg, sd, batch = _setup(preset)
    jcfg = jconfig.from_dict(tconfig.to_dict(
        tconfig.override(tcfg, ["model.dtype=float64"])))
    module = JDMV3D(jcfg.model)
    with _f64():
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                              weights.to_flax(sd))
        b = {k: jnp.asarray(v) for k, v in batch.items()}

        def loss_fn(p):
            out = module.apply({"params": p}, b["image_seq"],
                               b["src_poses"], b["tgt_poses"])
            loss, _ = jlosses.total_loss(out, b, jcfg.train,
                                         synthesis=jcfg.model.synthesis)
            return loss, out
        (loss, out), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
        out = {k: np.asarray(v) for k, v in out.items()}
        grads = {n: g.double().numpy() for n, g in weights.from_flax(
            jax.tree.map(np.asarray, grads), TDMV3D(tcfg.model)).items()}
    return out, float(loss), grads


def _port_outputs(preset: str, f64: bool = False) -> dict:
    tcfg, sd, batch = _setup(preset)
    if f64:
        tcfg = tconfig.override(tcfg, ["model.dtype=float64"])
    model = TModel.from_flax_params(tcfg, weights.to_flax(sd), device="cpu")
    if f64:
        model.module.double()
    x = {k: torch.as_tensor(v) for k, v in batch.items()}   # no f32 copy
    return model.predict(x["image_seq"], x["tgt_poses"],
                         source_poses=x["src_poses"], return_aux=True)


PRESETS = list(CUTS)


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_keeps_its_shape(preset):
    """What the cut leaves of the preset: levels, T, K, remat, dynamic
    scenes, flow synthesis and the source kind."""
    tcfg, _ = _configs(preset)
    m, d = tcfg.model, tcfg.data
    assert (m.num_levels, d.seq_len, d.num_targets, m.remat_scan,
            d.dynamic, d.source) == KEEPS[preset]
    assert m.synthesis == "flow"
    assert m.image_size // 2 ** m.num_levels >= 1
    full = tconfig.get_config(preset)
    assert (full.model.num_levels, full.data.seq_len, full.data.num_targets,
            full.model.remat_scan) == KEEPS[preset][:4]


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_sources_render_the_same_batch(preset):
    """Both packages' sources of the preset give one batch, bitwise: the
    images, the poses and their shapes."""
    ours, ref = _source_batch(preset)
    tcfg, _ = _configs(preset)
    b, t, k = (tcfg.data.batch_size, tcfg.data.seq_len,
               tcfg.data.num_targets)
    assert ours["image_seq"].shape == (b, t) + (tcfg.data.image_size,) * 2 \
        + (3,)
    assert ours["tgt_images"].shape[:2] == (b, k)
    assert sorted(ours) == sorted(ref)
    for name in ours:
        np.testing.assert_array_equal(ours[name], ref[name], err_msg=name)


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_forward_matches_jax_f64(preset):
    tcfg, _, _ = _setup(preset)
    ref = _jax_f64(preset)[0]
    ours = _port_outputs(preset)
    assert set(ours) == set(ref)
    gaps = _gaps(ref, ours, tcfg)
    assert max(gaps.values()) <= TOL, gaps


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_forward_f64_matches_jax_f64(preset):
    tcfg, _, _ = _setup(preset)
    with _f64():
        ours = _port_outputs(preset, f64=True)
    gaps = _gaps(_jax_f64(preset)[0], ours, tcfg)
    assert max(gaps.values()) <= TOL_F64, gaps


def _step_grads(preset: str, f64: bool = False) -> tuple:
    """One step of the port's train step on the preset's source batch
    (remat on: each recurrence step recomputed in the backward): (loss,
    gradients by name)."""
    tcfg, sd, _ = _setup(preset)
    if f64:
        tcfg = tconfig.override(tcfg, ["model.dtype=float64"])
    state = tstep.init_state(tcfg, seed=5, device="cpu")
    state.module.load_state_dict(sd)
    if f64:
        state.module.double()
    _, metrics = tstep.make_train_step(tcfg, device="cpu")(
        state, _source_batch(preset)[0])
    return metrics["loss/total"], {n: p.grad.double().numpy()
                                   for n, p in state.module.named_parameters()}


@pytest.mark.parametrize("preset", ["c3", "c5"])
def test_preset_train_step_matches_jax_f64(preset):
    """The loss within 1e-5 relative of JAX's f64 loss; every gradient
    within ``TOL_GRAD`` of JAX's f64 gradients."""
    assert _setup(preset)[0].model.remat_scan
    _, loss64, g64 = _jax_f64(preset)
    loss, grads = _step_grads(preset)
    assert abs(loss - loss64) <= 1e-5 * abs(loss64)
    gaps = grad_gaps(grads, g64)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= TOL_GRAD[preset], (worst, gaps[worst])


@pytest.mark.parametrize("preset", ["c3", "c5"])
def test_preset_train_step_f64_matches_jax_f64(preset):
    """The port's train step in float64 (remat on) against JAX's f64
    gradients: every tensor to 1e-10."""
    with _f64():
        loss, grads = _step_grads(preset, f64=True)
    _, loss64, g64 = _jax_f64(preset)
    assert abs(loss - loss64) <= 1e-12 * abs(loss64)
    gaps = grad_gaps(grads, g64)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= TOL_F64, (worst, gaps[worst])


# ------------------------------------------------------------ public names
def test_package_serves_the_jax_public_names():
    """``dynamic_multiview_3d_torch`` exports the JAX package's public
    names: ``Model`` and the one-shot ``predict`` among them."""
    assert set(tpkg.__all__) == set(jpkg.__all__)
    assert tpkg.predict is tapi.predict and tpkg.Model is tapi.Model
    with pytest.raises(AttributeError):
        tpkg.no_such_name  # noqa: B018


def test_predict_matches_jax_predict():
    """The one-shot ``predict(checkpoint_path, image_seq, target_poses)``
    of both packages on the JAX-written tiny c2 model dir
    (tests/torch_goldens/jax_orbax/c2_model): views within 1e-4."""
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_goldens", "jax_orbax", "c2_model")
    rng = np.random.default_rng(0)
    from dynamic_multiview_3d_torch.data.synthetic import (random_poses,
                                                           smooth_images)
    seq, tgt = smooth_images(rng, 2, 1, 32), random_poses(rng, 2, 3)
    src = random_poses(rng, 2, 1)
    ref = np.asarray(jpkg.predict(path, seq, tgt, source_poses=src))
    ours = tpkg.predict(path, seq, tgt, device="cpu", source_poses=src)
    assert tuple(ours.shape) == ref.shape == (2, 3, 32, 32, 3)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=TOL, atol=TOL)
