"""The port's layers (models/layers.py) against flax ``apply`` on the same
weights, converted with ``weights.from_flax``. f32 on both sides; tolerance
1e-5 (the order of sums in the convolutions and GroupNorm statistics)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from dynamic_multiview_3d_torch.models import layers as tl
from dynamic_multiview_3d_torch.weights import from_flax
from dynamic_multiview_3d_tpu.models import layers as jl

TOL = 1e-5


def _nchw(x):
    return torch.tensor(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _apply_both(jmod, tmod, *xs):
    variables = jmod.init(jax.random.key(0), *(jnp.asarray(x) for x in xs))
    params = jax.tree.map(np.asarray, variables["params"])
    tmod.load_state_dict(from_flax(params, tmod))
    ref = np.asarray(jmod.apply(variables, *(jnp.asarray(x) for x in xs)))
    return ref, _nhwc(tmod(*(_nchw(x) for x in xs)))


def test_fast_group_norm(rng):
    # a large common offset makes the one-pass variance matter
    x = (rng.standard_normal((2, 8, 12, 16)) + 3.0).astype(np.float32)
    ref, ours = _apply_both(jl.FastGroupNorm(num_groups=4),
                            tl.FastGroupNorm(4, 16), x)
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("stride,kernel,size", [(1, 3, 16), (2, 3, 16),
                                                (2, 3, 15), (1, 1, 8)])
def test_conv_block(rng, stride, kernel, size):
    x = rng.standard_normal((2, size, size, 8), dtype=np.float32)
    ref, ours = _apply_both(jl.ConvBlock(16, stride=stride, kernel=kernel),
                            tl.ConvBlock(8, 16, stride, kernel), x)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)


def test_stride2_same_padding_is_not_symmetric(rng):
    """flax SAME pads a 3x3 stride-2 conv on an even size by (0, 1); torch's
    symmetric padding=1 gives a different result on the same weights."""
    x = rng.standard_normal((1, 16, 16, 4), dtype=np.float32)
    jmod = nn.Conv(8, (3, 3), strides=(2, 2), padding="SAME")
    variables = jmod.init(jax.random.key(1), jnp.asarray(x))
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    conv = tl.Conv(4, 8, 3, stride=2)
    conv.load_state_dict(from_flax(
        jax.tree.map(np.asarray, variables["params"]), conv))
    np.testing.assert_allclose(_nhwc(conv(_nchw(x))), ref, rtol=TOL, atol=TOL)
    naive = F.conv2d(_nchw(x), conv.weight, conv.bias, stride=2, padding=1)
    assert np.abs(_nhwc(naive) - ref).max() > 0.1


def test_up_conv_2x2_same(rng):
    x = rng.standard_normal((2, 4, 4, 16), dtype=np.float32)
    ref, ours = _apply_both(nn.Conv(32, (2, 2), padding="SAME"),
                            tl.Conv(16, 32, 2), x)
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)


def test_depth_to_space2_phase_order(rng):
    x = rng.standard_normal((2, 3, 5, 12), dtype=np.float32)
    ref = np.asarray(jl.depth_to_space2(jnp.asarray(x)))
    ours = _nhwc(tl.depth_to_space2(_nchw(x)))
    np.testing.assert_array_equal(ours, ref)
    # torch's pixel_shuffle reads channels as (c, dy, dx): not the same
    assert np.abs(_nhwc(F.pixel_shuffle(_nchw(x), 2)) - ref).max() > 0.1


def test_conv_gru_cell(rng):
    h = rng.standard_normal((2, 4, 4, 16), dtype=np.float32)
    x = rng.standard_normal((2, 4, 4, 8), dtype=np.float32)
    ref, ours = _apply_both(jl.ConvGRUCell(16), tl.ConvGRUCell(8, 16), h, x)
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)


def test_conv_lstm_cell(rng):
    state = rng.standard_normal((2, 4, 4, 32), dtype=np.float32)
    x = rng.standard_normal((2, 4, 4, 8), dtype=np.float32)
    ref, ours = _apply_both(jl.ConvLSTMCell(16), tl.ConvLSTMCell(8, 16),
                            state, x)
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)
    hid = tl.ConvLSTMCell.hidden(_nchw(ref), 16)
    np.testing.assert_array_equal(
        _nhwc(hid), np.asarray(jl.ConvLSTMCell.hidden(jnp.asarray(ref), 16)))


def test_dense(rng):
    x = rng.standard_normal((5, 12), dtype=np.float32)
    jmod = nn.Dense(7)
    variables = jmod.init(jax.random.key(0), jnp.asarray(x))
    dense = tl.Dense(12, 7)
    dense.load_state_dict(from_flax(
        jax.tree.map(np.asarray, variables["params"]), dense))
    np.testing.assert_allclose(
        dense(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jmod.apply(variables, jnp.asarray(x))), rtol=TOL, atol=TOL)
