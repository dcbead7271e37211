"""The port's DMV3D and Model (models/dmv3d.py, api.py, weights.py) against the
JAX package on the tiny f32 config of tests/test_golden.py.

Tolerance 1e-4 on every output, with flow compared in units of its range
(``max_flow * image_size`` pixels, i.e. the head's tanh output): every layer
agrees to ~1e-7 relative (tests/test_torch_layers.py), but ~20 layers of
GroupNorm with one-pass variance amplify the different order of f32 sums to
~5e-6 of the flow range. The inputs are smooth random images: a sharp image
turns that flow difference into a larger warp difference at its edges.

The JAX model on the CPU warps in f32 whatever ``warp_precision`` says (its
fallback path ignores it), so the port is compared with
``warp_precision=exact``.

``test_dmv3d_matches_jax_f64`` runs both frameworks in float64 (``_f64``):
there they agree to ~1e-13, so the f32 difference is rounding, not a
formula. JAX's f32 rounding depends on the machine's XLA:CPU code, so
``test_dmv3d_matches_jax`` holds the port's f32 outputs to the JAX model's
f64 outputs, the exact answer, at 1e-4. The ConvLSTM model amplified the
f32 rounding most, through GroupNorm's one-pass variance: the port's
GroupNorm computes the same variance in two passes, which keeps every
variant's f32 outputs well inside the bound on every CPU path.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_model.py

prints each variant's f32 distance from the f64 answer per output, in the
unit that TOL bounds; ``ONEDNN_MAX_CPU_ISA=AVX2`` takes the convolutions'
path on a CPU without AVX-512.
"""

import contextlib
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_multiview_3d_torch import config as tconfig
from dynamic_multiview_3d_torch import weights
from dynamic_multiview_3d_torch.api import DEFAULT_POSE
from dynamic_multiview_3d_torch.api import Model as TModel
from dynamic_multiview_3d_torch.data.synthetic import random_poses, smooth_images
from dynamic_multiview_3d_torch.models import DMV3D as TDMV3D
from dynamic_multiview_3d_tpu import api as jax_api
from dynamic_multiview_3d_tpu import config as jconfig
from dynamic_multiview_3d_tpu.api import Model as JModel
from dynamic_multiview_3d_tpu.data.synthetic import SyntheticScenes
from test_golden import GOLDEN, _cfg

TOL = 1e-4
EXACT = ["model.warp_precision=exact"]


def _configs(extra):
    jcfg = jconfig.override(_cfg(), EXACT + extra)
    tcfg = tconfig.from_dict(jconfig.to_dict(jcfg))
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _pair(extra=(), seed=0):
    """(JAX Model, port Model, flax params) on the same weights: the port's
    seeded init, handed to JAX as a flax tree and read back through
    ``from_flax`` (JAX's own jitted init would compile once per config)."""
    jcfg, tcfg = _configs(list(extra))
    init = TModel.init_random(tcfg, seed=seed, device="cpu")
    params = weights.to_flax(init.module.state_dict())
    return (JModel(jcfg, params),
            TModel.from_flax_params(tcfg, params, device="cpu"), params)


def _gaps(ref, ours, cfg) -> dict:
    """Per output, max |ours - ref| / (1 + |ref|) (flow in units of its
    range): ``_assert_outputs_close`` passes where each is <= ``tol``."""
    scale = cfg.model.max_flow * cfg.model.image_size
    out = {}
    for k in ref:
        r = np.asarray(ref[k], np.float64)
        o = ours[k].numpy().astype(np.float64)
        if k == "flow":
            r, o = r / scale, o / scale
        out[k] = float(np.max(np.abs(o - r) / (1.0 + np.abs(r))))
    return out


def _assert_outputs_close(ref, ours, cfg, tol=TOL):
    assert set(ours) == set(ref)
    for k in ref:
        r, o = np.asarray(ref[k]), ours[k].numpy()
        assert o.shape == r.shape, k
        if k == "flow":
            scale = cfg.model.max_flow * cfg.model.image_size
            r, o = r / scale, o / scale
        np.testing.assert_allclose(o, r, rtol=tol, atol=tol, err_msg=k)


VARIANTS = [
    ([], 1),
    (["model.up_order=norm_first"], 1),
    (["model.skip_fusion=concat"], 1),
    (["model.up_order=norm_first", "model.skip_fusion=concat"], 1),
    (["model.rnn=lstm"], 1),
    ([], 2),
]
TOL_F64 = 1e-10


@contextlib.contextmanager
def _f64():
    """Both frameworks in float64: x64 on, and the ``float32`` that either
    model names for its f32 islands (GroupNorm statistics, head outputs,
    sampling coordinates) read as float64 while the block runs."""
    with jax.enable_x64(True), \
            mock.patch.object(jnp, "float32", jnp.float64), \
            mock.patch.object(torch, "float32", torch.float64):
        yield


def _dmv3d_inputs(t):
    rng = np.random.default_rng(0)
    seq = smooth_images(rng, 2, t, 32)
    return seq, random_poses(rng, 2, 3), random_poses(rng, 2, t)


@functools.lru_cache(maxsize=None)
def _jax_f64_outputs(extra, t):
    """The JAX model's outputs in float64 on ``_pair``'s weights."""
    _, _, params = _pair(extra)
    jcfg, _ = _configs(list(extra) + ["model.dtype=float64"])
    seq, tgt, src = _dmv3d_inputs(t)
    with _f64():
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        out = JModel(jcfg, p64).predict(seq.astype(np.float64),
                                        tgt.astype(np.float64),
                                        source_poses=src.astype(np.float64),
                                        return_aux=True)
        out = {k: np.asarray(v) for k, v in out.items()}
    assert all(v.dtype == np.float64 for v in out.values())
    return out


@pytest.mark.parametrize("extra,t", VARIANTS)
def test_dmv3d_matches_jax(extra, t):
    """The port in f32 against the JAX model's f64 outputs."""
    _, tm, _ = _pair(tuple(extra))
    seq, tgt, src = _dmv3d_inputs(t)
    ours = tm.predict(seq, tgt, source_poses=src, return_aux=True)
    ref = _jax_f64_outputs(tuple(extra), t)
    _assert_outputs_close(ref, ours, tm.cfg)


@pytest.mark.parametrize("extra,t", VARIANTS)
def test_dmv3d_matches_jax_f64(extra, t):
    """Both frameworks in f64 on the same weights and inputs: every output
    agrees to 1e-10 (flow in units of its range)."""
    _, tm, params = _pair(tuple(extra))
    _, tcfg = _configs(list(extra) + ["model.dtype=float64"])
    seq, tgt, src = _dmv3d_inputs(t)
    ref = _jax_f64_outputs(tuple(extra), t)
    with _f64():
        tm64 = TModel.from_flax_params(tcfg, params, device="cpu")
        tm64.module.double()
        ours = tm64.predict(seq, tgt, source_poses=src, return_aux=True)
    assert all(v.dtype == torch.float64 for v in ours.values())
    _assert_outputs_close(ref, ours, tcfg, tol=TOL_F64)


def test_golden_views_reproduced():
    """The JAX golden (tests/goldens/tiny_model_views.npy) from the port,
    on the JAX init's weights, at the golden test's own bar."""
    src = SyntheticScenes(num_scenes=2, image_size=32, seq_len=2,
                          num_targets=2)
    ex = src.example(1)
    jcfg, tcfg = _configs([])
    params = jax.tree.map(np.asarray,
                          JModel.init_random(jcfg, seed=123).params)
    tm = TModel.from_flax_params(tcfg, params, device="cpu")
    views = tm.predict(ex["image_seq"], ex["tgt_poses"],
                       source_poses=ex["src_poses"]).numpy()
    golden = np.load(GOLDEN)
    assert views.shape == golden.shape
    mse = float(np.mean((views - golden) ** 2))
    psnr = 10 * np.log10(4.0 / max(mse, 1e-16))
    assert psnr >= 60.0, f"golden drift: PSNR {psnr:.1f} dB"


def test_predict_unbatched_and_default_pose():
    assert DEFAULT_POSE == jax_api.DEFAULT_POSE
    rng = np.random.default_rng(1)
    _, tm, _ = _pair()
    seq = smooth_images(rng, 1, 2, 32)[0]                # [T, H, W, 3]
    tgt = random_poses(rng, 1, 3)[0]                      # [K, 3]
    views = tm.predict(seq, tgt)
    assert views.shape == (3, 32, 32, 3)
    explicit = tm.predict(seq[None], tgt[None],
                          source_poses=np.broadcast_to(
                              np.float32(DEFAULT_POSE), (1, 2, 3)))
    torch.testing.assert_close(views, explicit[0], rtol=0, atol=0)
    aux = tm.predict(seq, tgt, return_aux=True)
    assert aux["flow_valid"].shape == (3, 32, 32)
    torch.testing.assert_close(aux["view"], views, rtol=0, atol=0)


@pytest.mark.parametrize("extra", [["model.synthesis=depth",
                                    "model.predict_depth=true"],
                                   ["model.predict_depth=true"]],
                         ids=["c2d", "c2g"])
def test_depth_paths_match_jax(extra):
    """Depth synthesis (c2d: the view from the fused depth reprojection +
    composite, the flow warp through the plain sampler) and flow synthesis
    with the geometric side view (c2g): every output (view, warped, flow,
    flow_valid, mask, rgb, depth, geo_view, geo_valid) against the JAX
    model on the same weights. Some target pixels reproject behind the
    source camera or off the image."""
    rng = np.random.default_rng(3)
    jm, tm, _ = _pair(tuple(extra))
    seq = smooth_images(rng, 2, 1, 32)
    src, tgt = random_poses(rng, 2, 1), random_poses(rng, 2, 3)
    ref = jm.predict(seq, tgt, source_poses=src, return_aux=True)
    ours = tm.predict(seq, tgt, source_poses=src, return_aux=True)
    assert set(ours) == {"view", "warped", "flow", "flow_valid", "mask",
                         "rgb", "depth", "geo_view", "geo_valid"}
    _assert_outputs_close(ref, ours, tm.cfg)
    assert ours["geo_view"].shape == (2, 3, 32, 32, 3)
    assert ours["geo_valid"].shape == ours["depth"].shape == (2, 3, 32, 32)
    assert bool((ours["depth"] > 0.1).all())


def test_depth_synthesis_needs_predict_depth():
    _, tcfg = _configs(["model.synthesis=depth"])
    with pytest.raises(ValueError, match="predict_depth"):
        TDMV3D(tcfg.model)


# ---------------------------------------------------------------- multi-source
def _multi(synthesis, mode, t=3):
    """Config overrides of the tiny multi-source model; baked heads are made
    for data.seq_len = t sources."""
    return (f"model.synthesis={synthesis}", f"model.multi_head_mode={mode}",
            f"data.seq_len={t}")


MULTI = [(s, m) for s in ("multiflow", "multidepth")
         for m in ("shared", "baked")]


@pytest.mark.parametrize("synthesis,mode", MULTI)
def test_multi_source_matches_jax(synthesis, mode):
    """Every output (view, warped, mask, rgb, flow / depth, validity,
    conf_weights) at T = 3 sources and K = 2 targets."""
    rng = np.random.default_rng(2)
    jm, tm, _ = _pair(_multi(synthesis, mode))
    seq = smooth_images(rng, 2, 3, 32)
    src, tgt = random_poses(rng, 2, 3), random_poses(rng, 2, 2)
    ref = jm.predict(seq, tgt, source_poses=src, return_aux=True)
    ours = tm.predict(seq, tgt, source_poses=src, return_aux=True)
    _assert_outputs_close(ref, ours, tm.cfg)
    assert ours["conf_weights"].shape == (2, 2, 32, 32, 3)
    torch.testing.assert_close(ours["conf_weights"].sum(-1),
                               torch.ones(2, 2, 32, 32))


@pytest.mark.parametrize("synthesis", ["multiflow", "multidepth"])
@pytest.mark.parametrize("t", [2, 5])
def test_shared_heads_serve_another_source_count(synthesis, t):
    """Shared heads carry no T: weights made with 3 sources answer T = 2
    and T = 5 requests as JAX does (tests/test_model.py's variable-T
    check, against the reference's numbers)."""
    rng = np.random.default_rng(t)
    jm, tm, params = _pair(_multi(synthesis, "shared"))
    assert weights.baked_num_sources(params, tm.cfg.model) is None
    seq = smooth_images(rng, 1, t, 32)
    src, tgt = random_poses(rng, 1, t), random_poses(rng, 1, 2)
    ref = jm.predict(seq, tgt, source_poses=src, return_aux=True)
    ours = tm.predict(seq, tgt, source_poses=src, return_aux=True)
    _assert_outputs_close(ref, ours, tm.cfg)


@pytest.mark.parametrize("synthesis", ["multiflow", "multidepth"])
def test_baked_heads_take_t_from_the_weights_and_refuse_another(synthesis):
    _, tm, params = _pair(_multi(synthesis, "baked"))
    assert tm.module.num_sources == 3
    assert weights.baked_num_sources(params, tm.cfg.model) == 3
    conv = params["decoder"]["heads_multi"]["kernel"]
    assert conv.shape[-1] == (13 if synthesis == "multiflow" else 7)
    assert params["bottleneck"]["pose_fc1"]["kernel"].shape == (24, 8)
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="3 sources"):
        tm.predict(smooth_images(rng, 1, 2, 32), random_poses(rng, 1, 2),
                   source_poses=random_poses(rng, 1, 2))
    with pytest.raises(ValueError, match="num_sources"):
        TDMV3D(tm.cfg.model)


def test_multi_source_from_flax_is_strict():
    _, tm, params = _pair(_multi("multiflow", "shared"))
    flat = weights.flatten(params)
    for path in ("decoder/srchead_mix/bias", "decoder/srchead_emb/kernel",
                 "decoder/heads_base/kernel"):
        missing = dict(flat)
        del missing[path]
        with pytest.raises(ValueError, match=path.replace("/", r"\.")
                           .replace("kernel", "weight")):
            weights.from_flax(missing, tm.module)
    wrong = dict(flat)
    wrong["decoder/srchead_out/kernel"] = np.zeros((1, 1, 32, 1), np.float32)
    with pytest.raises(ValueError, match="srchead_out/kernel"):
        weights.from_flax(wrong, tm.module)
    # a baked tree does not load into shared heads, nor a T=4 one into T=3
    _, baked, baked_params = _pair(_multi("multiflow", "baked"))
    with pytest.raises(ValueError, match="heads_multi"):
        weights.from_flax(baked_params, tm.module)
    _, _, baked4 = _pair(_multi("multiflow", "baked", t=4))
    with pytest.raises(ValueError, match="heads_multi/kernel"):
        weights.from_flax(baked4, baked.module)


def test_multi_source_predict_needs_source_poses():
    _, tm, _ = _pair()
    cfg = tconfig.override(tm.cfg, ["model.synthesis=multiflow"])
    with pytest.raises(ValueError, match="source_poses"):
        TModel(cfg, tm.module).predict(np.zeros((2, 32, 32, 3), np.float32),
                                       np.zeros((1, 3), np.float32))


def test_from_flax_is_strict():
    _, tm, params = _pair()
    flat = weights.flatten(params)
    module = tm.module
    missing = dict(flat)
    del missing["decoder/heads/bias"]
    with pytest.raises(ValueError, match="heads.bias"):
        weights.from_flax(missing, module)
    extra = dict(flat, **{"decoder/extra/kernel": np.zeros((3, 3, 8, 8))})
    with pytest.raises(ValueError, match="decoder/extra/kernel"):
        weights.from_flax(extra, module)
    wrong = dict(flat)
    wrong["decoder/heads/kernel"] = np.zeros((3, 3, 8, 7), np.float32)
    with pytest.raises(ValueError, match="decoder/heads/kernel"):
        weights.from_flax(wrong, module)
    # nested and flat forms convert to the same state_dict
    nested = weights.from_flax(params, module)
    for k, v in weights.from_flax(flat, module).items():
        torch.testing.assert_close(v, nested[k], rtol=0, atol=0)


def test_init_random_is_seeded_flax_default():
    _, tcfg = _configs([])
    a = TModel.init_random(tcfg, seed=5, device="cpu").module.state_dict()
    b = TModel.init_random(tcfg, seed=5, device="cpu").module.state_dict()
    c = TModel.init_random(tcfg, seed=6, device="cpu").module.state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    w = a["recurrent.encoder.down2.conv.weight"]
    assert not torch.equal(w, c["recurrent.encoder.down2.conv.weight"])
    fan_in = w[0].numel()
    assert abs(w.std().item() * fan_in ** 0.5 - 1.0) < 0.15   # lecun variance
    assert w.abs().max().item() <= 2.0 / 0.8796256610342398 / fan_in ** 0.5
    assert torch.all(a["recurrent.encoder.down2.norm.scale"] == 1)
    assert torch.all(a["recurrent.encoder.down2.conv.bias"] == 0)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    _, tcfg = _configs([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TModel.init_random(tcfg)


def test_config_round_trips_jax_config_json():
    """A JAX checkpoint's config.json loads unchanged, including the
    multi_head_mode="baked" backfill for configs that lack the field."""
    for name in jconfig.PRESETS:
        d = jconfig.to_dict(jconfig.get_config(name))
        assert tconfig.to_dict(tconfig.from_dict(d)) == d
    d = jconfig.to_dict(jconfig.get_config("c3mf"))
    del d["model"]["multi_head_mode"]
    assert tconfig.from_dict(d).model.multi_head_mode == "baked"
    assert tconfig.to_dict(tconfig.from_dict(d)) == \
        jconfig.to_dict(jconfig.from_dict(d))


@pytest.mark.parametrize("synthesis", ["multiflow", "multidepth"])
def test_multi_source_one_target_matches_jax(synthesis):
    """K = 1 target (tests/test_api.py's multi-source request): the
    per-source coordinates reach the fused kernel contiguous, as at K > 1."""
    rng = np.random.default_rng(4)
    jm, tm, _ = _pair(_multi(synthesis, "shared"))
    seq = smooth_images(rng, 2, 3, 32)
    src, tgt = random_poses(rng, 2, 3), random_poses(rng, 2, 1)
    ref = jm.predict(seq, tgt, source_poses=src, return_aux=True)
    ours = tm.predict(seq, tgt, source_poses=src, return_aux=True)
    _assert_outputs_close(ref, ours, tm.cfg)


if __name__ == "__main__":
    for extra, t in VARIANTS:
        _, tm, _ = _pair(tuple(extra))
        seq, tgt, src = _dmv3d_inputs(t)
        got = _gaps(_jax_f64_outputs(tuple(extra), t),
                    tm.predict(seq, tgt, source_poses=src, return_aux=True),
                    tm.cfg)
        print(f"{' '.join(extra) or 'default'} T={t}:",
              {k: f"{v:.3g}" for k, v in sorted(got.items())})
