"""``Model.predict``'s inputs (api.py): on the CPU the float32 conversion
as it always was; on a CUDA device one pass into a pinned block and a
non-blocking copy, with no wait on the card, bitwise the blocking path's
inputs and views; and the counters that say the staging engages
(``profiling.count``).

No JAX here: the card runs this file's ``cuda`` tests with ``-m cuda``.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dynamic_multiview_3d_torch import api
from dynamic_multiview_3d_torch import config as tconfig
from dynamic_multiview_3d_torch.api import DEFAULT_POSE, Model
from dynamic_multiview_3d_torch.utils import profiling

TINY = ["model.image_size=32", "model.num_levels=3", "model.base_features=8",
        "model.max_features=16", "model.gru_features=16",
        "model.pose_embed_dim=8", "data.image_size=32"]
COUNTERS = ("dmv3d.predict.inputs.staged",
            "dmv3d.predict.inputs.staged_bytes",
            "dmv3d.predict.inputs.host_allocs")


def _parent_f32(x, device):
    if not torch.is_tensor(x):
        x = np.array(x, np.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _parent_inputs(image_seq, target_poses, source_poses, device):
    """``Model._inputs`` as it was before the staging, for a single-source
    model: the float32 conversion, the batch axis, the default pose."""
    image_seq = _parent_f32(image_seq, device)
    target_poses = _parent_f32(target_poses, device)
    unbatched = image_seq.dim() == 4
    if unbatched:
        image_seq = image_seq[None]
        target_poses = target_poses[None]
    b, t = image_seq.shape[:2]
    if source_poses is None:
        source_poses = torch.tensor(DEFAULT_POSE, dtype=torch.float32,
                                    device=device).expand(b, t, 3)
    else:
        source_poses = _parent_f32(source_poses, device)
        if source_poses.dim() == 2:
            source_poses = source_poses[None]
    return image_seq, target_poses, source_poses, unbatched


def _read_only(x):
    x = x.copy()
    x.flags.writeable = False
    return x


def _strided(x):
    """The same values as a non-contiguous view: every other element of an
    array twice as long on the last axis."""
    wide = np.repeat(x, 2, axis=-1)
    wide[..., 1::2] = 7.0
    out = wide[..., ::2]
    assert not out.flags.c_contiguous
    return out


KINDS = {
    "float32": lambda x: x.astype(np.float32),
    "float64": lambda x: x,
    "list": lambda x: x.tolist(),
    "read_only": lambda x: _read_only(x.astype(np.float32)),
    "strided": lambda x: _strided(x.astype(np.float32)),
    "reversed": lambda x: x.astype(np.float32)[::-1],
    "big_endian": lambda x: x.astype(">f4"),
    "float16": lambda x: x.astype(np.float16),
    "tensor": lambda x: torch.from_numpy(x.astype(np.float32)),
    "tensor_float64": torch.from_numpy,
    "tensor_bfloat16": lambda x: torch.from_numpy(x).to(torch.bfloat16),
}


def _raw(batched: bool, t: int = 2, k: int = 2, size: int = 32, seed=0):
    """float64 frames, target and source poses, whose float32 rounding
    matters (values off the float32 grid)."""
    rng = np.random.default_rng(seed)
    lead = (2,) if batched else ()
    return (rng.uniform(-1, 1, lead + (t, size, size, 3)),
            rng.uniform(0, 2, lead + (k, 3)),
            rng.uniform(0, 2, lead + (t, 3)))


def _cfg(*extra):
    return tconfig.get_config("default", TINY + list(extra))


@pytest.fixture(scope="module")
def cpu_model():
    return Model.init_random(_cfg("data.seq_len=2"), device="cpu")


def _same(a, b):
    assert a.dtype == b.dtype and a.device == b.device
    assert a.shape == b.shape and a.stride() == b.stride()
    assert torch.equal(a, b)


@pytest.mark.parametrize("poses", ["given", "default"])
@pytest.mark.parametrize("batched", [True, False], ids=["batched",
                                                        "unbatched"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_cpu_inputs_are_the_parents(cpu_model, kind, batched, poses):
    frames, tgt, src = (KINDS[kind](x) for x in _raw(batched))
    if poses == "default":
        src = None
    with torch.inference_mode():
        got = cpu_model._inputs(frames, tgt, src)
        want = _parent_inputs(frames, tgt, src, torch.device("cpu"))
    assert got[3] == want[3] == (not batched)
    for a, b in zip(got[:3], want[:3]):
        _same(a, b)


@pytest.mark.parametrize("kind", list(KINDS))
def test_a_host_block_holds_the_float32_conversion(kind):
    # the staging's host pass, in an unpinned block on the CPU
    x = KINDS[kind](_raw(True)[0])
    block = api._host_f32(x, pin_memory=False)
    _same(block, _parent_f32(x, "cpu").contiguous())


def test_a_cpu_model_counts_nothing(cpu_model):
    frames, tgt, src = (x.astype(np.float32) for x in _raw(True))
    with profile(activities=[ProfilerActivity.CPU]):
        cpu_model.predict(frames, tgt, source_poses=src)
    assert profiling.recordings()[-1].counters == {}


def test_count_is_off_outside_a_profiler():
    before = len(profiling.recordings())
    assert not profiling.on()
    profiling.count("dmv3d.test", 5)
    assert len(profiling.recordings()) == before


def test_count_adds_up_in_its_own_sessions_recording():
    for n in (1, 2):
        with profile(activities=[ProfilerActivity.CPU]):
            assert profiling.on()
            for _ in range(n):
                profiling.count("dmv3d.test")
                profiling.count("dmv3d.test.bytes", 12)
    first, second = profiling.recordings()[-2:]
    assert first.counters == {"dmv3d.test": 1, "dmv3d.test.bytes": 12}
    assert second.counters == {"dmv3d.test": 2, "dmv3d.test.bytes": 24}
    with profile(activities=[ProfilerActivity.CPU]):
        pass
    assert profiling.recordings()[-1].counters == {}


def test_count_is_off_under_export():
    class Counted(torch.nn.Module):
        def forward(self, x):
            profiling.count("dmv3d.test", 3)
            return x * 2
    with profile(activities=[ProfilerActivity.CPU]):
        program = torch.export.export(Counted(), (torch.ones(4),))
    assert profiling.recordings()[-1].counters == {}
    targets = [str(n.target) for n in program.graph.nodes]
    assert not [t for t in targets if "profiler" in t]


# -- on the card ------------------------------------------------------------

SHAPES = {   # (preset overrides, T, K, batch)
    "c2": (["model.synthesis=flow", "data.seq_len=1"], 1, 8, 4),
    "c3md": (["model.synthesis=multidepth", "model.multi_head_mode=shared",
              "model.src_head_features=8", "data.seq_len=8"], 8, 2, 4),
}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: pinned memory and the card's copy")
    return torch.device("cuda")


def _card_model(shape, cuda):
    extra, t, k, b = SHAPES[shape]
    cfg = tconfig.get_config(shape, TINY + extra)
    return Model.init_random(cfg, seed=1, device=cuda), t, k, b


def _request(t, k, b, seed):
    frames, tgt, src = _raw(True, t=t, k=k, seed=seed)
    frames = np.concatenate([frames] * (b // 2))
    tgt, src = np.concatenate([tgt] * (b // 2)), np.concatenate([src] *
                                                                (b // 2))
    return frames.astype(np.float32), tgt.astype(np.float32), \
        src.astype(np.float32)


def _blocking(model, frames, tgt, src):
    """The views of the blocking path: float32 tensors already on the card,
    which ``predict`` takes as they are."""
    dev = model.device
    on = [None if x is None else torch.as_tensor(
        np.array(x, np.float32)).to(dev) for x in (frames, tgt, src)]
    views = model.predict(on[0], on[1], source_poses=on[2])
    torch.cuda.synchronize()
    return views


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
def test_staged_views_are_the_blocking_paths(shape, cuda):
    model, t, k, b = _card_model(shape, cuda)
    # torch's threads fill the block from a writable array, np.copyto
    # from a read-only one
    for seed, host in ((0, np.copy), (1, _read_only)):
        req = [host(x) for x in _request(t, k, b, seed)]
        want = _blocking(model, *req)
        got = model.predict(req[0], req[1], source_poses=req[2])
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        if shape == "c2":
            want = _blocking(model, req[0], req[1], None)
            got = model.predict(req[0], req[1])
            torch.cuda.synchronize()
            assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
def test_predict_makes_no_stream_sync(shape, cuda):
    model, t, k, b = _card_model(shape, cuda)
    req = _request(t, k, b, 0)
    poses = [req[2]] + ([None] if shape == "c2" else [])
    for src in poses:                                  # warm-up
        model.predict(req[0], req[1], source_poses=src)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for src in poses:
            model.predict(req[0], req[1], source_poses=src)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
def test_the_callers_arrays_are_free_on_return(shape, cuda):
    model, t, k, b = _card_model(shape, cuda)
    req = _request(t, k, b, 0)
    want = _blocking(model, *req)
    frames, tgt, src = (x.copy() for x in req)
    torch.cuda._sleep(200_000_000)            # the stream busy ~0.1 s
    got = model.predict(frames, tgt, source_poses=src)
    for x in (frames, tgt, src):
        x[...] = 0.5
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
def test_back_to_back_requests_keep_their_own_inputs(shape, cuda):
    model, t, k, b = _card_model(shape, cuda)
    reqs = [_request(t, k, b, seed) for seed in range(4)]
    wants = [_blocking(model, *r) for r in reqs]
    torch.cuda._sleep(200_000_000)            # every copy still in flight
    gots = [model.predict(r[0], r[1], source_poses=r[2]) for r in reqs]
    torch.cuda.synchronize()
    for got, want in zip(gots, wants):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
def test_counters_read_the_staging_and_a_warm_cache(shape, cuda):
    model, t, k, b = _card_model(shape, cuda)
    req = _request(t, k, b, 0)
    for _ in range(2):
        model.predict(req[0], req[1], source_poses=req[2])
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):
        for _ in range(2):
            model.predict(req[0], req[1], source_poses=req[2])
            torch.cuda.synchronize()
    counters = profiling.recordings()[-1].counters
    assert counters == {COUNTERS[0]: 6,
                        COUNTERS[1]: 2 * sum(x.nbytes for x in req),
                        COUNTERS[2]: 0}


@pytest.mark.cuda
def test_a_pinned_float32_tensor_is_sent_as_it_is(cuda):
    model, t, k, b = _card_model("c3md", cuda)
    req = _request(t, k, b, 0)
    want = _blocking(model, *req)
    pinned = [torch.from_numpy(x).pin_memory() for x in req]
    with profile(activities=[ProfilerActivity.CUDA]):
        got = model.predict(pinned[0], pinned[1], source_poses=pinned[2])
        torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert profiling.recordings()[-1].counters == dict.fromkeys(COUNTERS, 0)
