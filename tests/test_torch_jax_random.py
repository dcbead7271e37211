"""The port's copy of ``jax.random`` (utils/jax_random.py) and the draws
made with it, bitwise against JAX on the CPU.

``key``, ``fold_in``, ``split``, ``random_bits``, ``randint`` and
``permutation`` equal ``jax.random``'s for seeds 0, 1 and 2**31 - 1,
fold_in data up to 2**31 - 1, randint spans from 1 to 2**31 - 1 (and
maxval <= minval), permutations of 1 ... 40 elements and of 2000 (two
sort rounds), on Python-int keys and on batches of tensor keys, and under
hypothesis over seeds and steps. The draws of a train step: the device
draw (``ResidentFrames.device_draw``, whose CPU path is the plain version
of csrc/jax_draw.cu) equals the JAX package's ``device_sample`` from the
JAX step's key chain (``fold_in(key(seed), step)``, split), recovered by
gathering from frame and pose tables coded with their row numbers, at
orbit and fixed cameras, V >= T and V < T, V >= K and V < K, offsets 0
and 32 and steps 0, 1, 15 and 10**6, and the rows the JAX step itself
gathered in the committed run ``c3md_sampled_run``; ``preprocess``'s
target subsample equals JAX's with and without the device-sampling
split. The layout ported is the one with ``jax_threefry_partitionable``
on, which this module asserts of the JAX under test.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamic_multiview_3d_torch.data import pipeline as tpipeline
from dynamic_multiview_3d_torch.data import resident as tresident
from dynamic_multiview_3d_torch.kernels import jax_draw
from dynamic_multiview_3d_torch.utils import jax_random as jr
from dynamic_multiview_3d_tpu.data import pipeline as jpipeline
from dynamic_multiview_3d_tpu.data import resident as jresident

assert jax.config.jax_threefry_partitionable, \
    "the port copies jax.random's partitionable threefry layout"

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPECTED = os.path.join(REPO, "tests", "torch_goldens", "jax_orbax",
                        "expected.npz")
SEEDS = [0, 1, 2 ** 31 - 1]
SPANS = [1, 2, 3, 7, 512, 65537, 2 ** 31 - 1]


def _data(k) -> tuple:
    return tuple(int(x) for x in jax.random.key_data(k))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_split_and_bits(seed):
    k = jax.random.key(seed)
    assert jr.key(seed) == _data(k)
    for d in (0, 1, 11, 2 ** 20 + 3, 2 ** 31 - 1):
        assert jr.fold_in(jr.key(seed), d) == _data(jax.random.fold_in(k, d))
    for n in (2, 4, 7):
        assert jr.split(jr.key(seed), n) == [_data(x) for x in
                                             jax.random.split(k, n)]
    for shape in ((), (5,), (3, 4)):
        np.testing.assert_array_equal(
            jr.random_bits(jr.key(seed), shape).numpy(),
            np.asarray(jax.random.bits(k, shape), np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_randint(seed):
    k = jax.random.key(seed)
    for n in SPANS:
        for lo in (0, -5):
            hi = min(lo + n, 2 ** 31 - 1)
            np.testing.assert_array_equal(
                jr.randint(jr.key(seed), (6,), lo, hi).numpy(),
                np.asarray(jax.random.randint(k, (6,), lo, hi)), str(n))
    for lo, hi in ((3, 3), (5, -7), (-2 ** 31, 2 ** 31 - 1)):
        np.testing.assert_array_equal(
            jr.randint(jr.key(seed), (4,), lo, hi).numpy(),
            np.asarray(jax.random.randint(k, (4,), lo, hi)))
    with pytest.raises(ValueError, match="int32"):
        jr.randint(jr.key(seed), (), 0, 2 ** 31)


@pytest.mark.parametrize("seed", SEEDS)
def test_permutation(seed):
    k = jax.random.key(seed)
    assert jr.shuffle_rounds(2000) == 2 and jr.shuffle_rounds(40) == 1
    for n in [*range(1, 41), 2000]:
        np.testing.assert_array_equal(
            jr.permutation(jr.key(seed), n).numpy(),
            np.asarray(jax.random.permutation(k, n)), str(n))


def test_batched_tensor_keys_are_vmapped_draws():
    """A batch of tensor keys draws what ``jax.vmap`` draws from each."""
    base = jax.random.fold_in(jax.random.key(3), 7)
    idx = np.arange(40, 52)
    keys = jax.vmap(jax.random.fold_in, (None, 0))(base, idx)
    ours = jr.fold_in(jr.fold_in(jr.key(3), 7), torch.as_tensor(idx))
    np.testing.assert_array_equal(torch.stack(ours, -1).numpy(),
                                  np.asarray(jax.random.key_data(keys)))
    for got, want in (
            (jr.randint(ours, (), 0, 9),
             jax.vmap(lambda q: jax.random.randint(q, (), 0, 9))(keys)),
            (jr.randint(ours, (5,), 0, 3),
             jax.vmap(lambda q: jax.random.randint(q, (5,), 0, 3))(keys)),
            (jr.permutation(ours, 8),
             jax.vmap(lambda q: jax.random.permutation(q, 8))(keys))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    parts = jr.split(ours, 4)
    want = jax.vmap(lambda q: jax.random.split(q, 4))(keys)
    for i, (a, b) in enumerate(parts):
        np.testing.assert_array_equal(
            torch.stack([a, b], -1).numpy(),
            np.asarray(jax.random.key_data(want[:, i])))


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), step=st.integers(0, 2 ** 31 - 1),
       n=st.integers(1, 64))
def test_step_keys_and_draws_under_hypothesis(seed, step, n):
    key = jax.random.fold_in(jax.random.key(seed), step)
    after, k_samp = jax.random.split(key)
    assert jr.step_keys(seed, step, False) == (_data(key), None)
    assert jr.step_keys(seed, step, True) == (_data(after), _data(k_samp))
    np.testing.assert_array_equal(
        jr.permutation(jr.step_keys(seed, step, False)[0], n).numpy(),
        np.asarray(jax.random.permutation(key, n)))
    np.testing.assert_array_equal(
        jr.randint(_data(k_samp), (3,), 0, n).numpy(),
        np.asarray(jax.random.randint(k_samp, (3,), 0, n)))


# ----------------------------------------------------------- the draws
# (V = 6 views, T = 4 frames of 5, K = 3): the table of
# tests/test_torch_resident.py; the c3md bank of [loop-c3md]
META = {"num_scenes": 5, "num_views": 6, "t_avail": 5, "t_len": 4,
        "num_targets": 3, "orbit": True}
C3MD_META = {"num_scenes": 64, "num_views": 8, "t_avail": 8, "t_len": 8,
             "num_targets": 2, "orbit": True}
METAS = {"meta-orbit": META, "meta-fixed": dict(META, orbit=False),
         "few-views": dict(META, num_views=2),      # V < T, V < K
         "c3md-orbit": C3MD_META, "c3md-fixed": dict(C3MD_META, orbit=False)}


def _jax_rows(meta, seed, step, batch, offset) -> dict:
    """The rows JAX's ``device_sample`` draws with the JAX step's sampling
    key, recovered from tables coded with their row numbers."""
    key = jax.random.fold_in(jax.random.key(seed), step)
    _, k_samp = jax.random.split(key)
    s, v, t = meta["num_scenes"], meta["num_views"], meta["t_avail"]
    frames = jnp.arange(s * v * t, dtype=jnp.int32)[:, None]
    poses = jnp.arange(s * v, dtype=jnp.int32)[:, None]
    b = jresident.ResidentFrames.device_sample(frames, poses, meta, k_samp,
                                               batch, index_offset=offset)
    return {"seq_idx": b["image_seq"], "tgt_idx": b["tgt_images"],
            "src_pose_idx": b["src_poses"], "tgt_pose_idx": b["tgt_poses"]}


@pytest.mark.parametrize("meta", list(METAS))
def test_device_draw_is_jaxs(meta):
    meta = METAS[meta]
    for step in (0, 1, 15, 10 ** 6):
        for offset in (0, 32):
            want = _jax_rows(meta, 7, step, 8, offset)
            got = tresident.ResidentFrames.device_draw(
                meta, jr.step_keys(7, step, True)[1], 8, "cpu", offset)
            for k, w in want.items():
                np.testing.assert_array_equal(
                    got[k].numpy(), np.asarray(w)[..., 0],
                    f"{k} step {step} offset {offset}")


def test_device_draw_is_the_jax_steps():
    """The rows the JAX step gathered in the committed device-sampled run
    (c3md at tiny widths, 4 steps of 2 examples), caught inside its
    compiled step: the port draws them for the same steps."""
    expected = np.load(EXPECTED)
    meta = {"num_scenes": 4, "num_views": 8, "t_avail": 3, "t_len": 3,
            "num_targets": 2, "orbit": True}
    for step in range(4):
        got = tresident.ResidentFrames.device_draw(
            meta, jr.step_keys(0, step, True)[1], 2, "cpu")
        for k, v in got.items():
            np.testing.assert_array_equal(
                v.numpy(), expected[f"c3md_sampled_run/rows/{k}"][step])


def test_jax_draw_refuses_other_devices():
    with pytest.raises(ValueError, match="cpu or cuda"):
        jax_draw.jax_draw(META, (0, 1), 2, "meta")


@pytest.mark.parametrize("device_sampling", [False, True],
                         ids=["host-batch", "device-sampling"])
def test_target_subsample_is_jaxs(device_sampling):
    rng = np.random.default_rng(0)
    b, k = 6, 5
    batch = {"image_seq": rng.integers(0, 256, (b, 1, 4, 4, 3), np.uint8),
             "src_poses": rng.normal(size=(b, 1, 3)).astype(np.float32),
             "tgt_poses": rng.normal(size=(b, k, 3)).astype(np.float32),
             "tgt_images": rng.integers(0, 256, (b, k, 4, 4, 3), np.uint8)}
    for seed, step, offset in ((3, 0, 0), (3, 9, 4), (0, 10 ** 6, 32)):
        key = jax.random.fold_in(jax.random.key(seed), step)
        if device_sampling:
            key, _ = jax.random.split(key)
        want = jpipeline.preprocess({n: jnp.asarray(x)
                                     for n, x in batch.items()}, key=key,
                                    targets_per_step=2, index_offset=offset)
        got = tpipeline.preprocess(
            batch, device="cpu",
            key=jr.step_keys(seed, step, device_sampling)[0],
            targets_per_step=2, index_offset=offset)
        for n in ("tgt_poses", "tgt_images"):
            np.testing.assert_array_equal(got[n].numpy(),
                                          np.asarray(want[n]), n)
