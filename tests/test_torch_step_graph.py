"""The train step's CUDA graph (train/step.py ``StepGraph``): which steps
replay the captured forward, loss and backward, and that a graphed run
trains as an eager one does.

On the CPU: the rule that engages the graph (``graph_engages``: a CUDA
device, one process, autograd on), the batch signature that a replay
needs (each leaf's shape, dtype and strides), the capture on a
signature's third step, and the counters a CPU step records under a
profiler (eager steps, never a capture). On the card (``cuda``): graphed
runs of a tiny c3md-like configuration (device sampling, 4 steps a
dispatch, remat, multidepth: #4 / #5), its multiflow twin, a tiny
c2-like one (host batches) and its depth variants c2d and c2g (#2, #6,
#7 and the depth backward) held to eager runs from the same start, a
mid-run batch of another shape, a caller's
``zero_grad(set_to_none=True)``, and the optimizer's hooks and a patched
draw firing once a step.

No JAX here: the card runs this file's ``cuda`` tests with ``-m cuda``.
"""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dynamic_multiview_3d_torch import config as tconfig
from dynamic_multiview_3d_torch.data import pipeline
from dynamic_multiview_3d_torch.data import resident as tresident
from dynamic_multiview_3d_torch.data.synthetic import SyntheticScenes
from dynamic_multiview_3d_torch.parallel import mesh as tmesh
from dynamic_multiview_3d_torch.train import step as tstep
from dynamic_multiview_3d_torch.utils import profiling

TINY = ["model.image_size=32", "model.num_levels=3", "model.base_features=8",
        "model.max_features=16", "model.gru_features=16",
        "model.pose_embed_dim=8", "data.image_size=32", "data.batch_size=2",
        "data.num_targets=2", "train.lr=1e-3"]
CUDA = torch.device("cuda")      # a device object: no card needed to name it
ONE = tmesh.Mesh(device=CUDA)


def _batch(b=2, k=2):
    return {"image_seq": torch.zeros(b, 1, 8, 8, 3),
            "src_poses": torch.zeros(b, 1, 3),
            "tgt_poses": torch.zeros(b, k, 3),
            "tgt_images": torch.zeros(b, k, 8, 8, 3)}


def _module():
    return torch.nn.Linear(2, 2)


def _captured(graph, module, batch):
    """``graph`` as a capture of ``module`` on ``batch`` leaves it, without
    a card: what ``plan`` reads."""
    graph.graph, graph.module = object(), module
    graph.sig = tstep.signature(batch)
    graph.params = list(module.parameters())
    graph.ptrs = [p.data_ptr() for p in graph.params]


@pytest.mark.parametrize("device,mesh,grad,want", [
    (CUDA, ONE, True, True),
    (torch.device("cpu"), tmesh.Mesh(), True, False),
    (CUDA, tmesh.Mesh(world_size=2, device=CUDA), True, False),
    (CUDA, tmesh.Mesh(world_size=2, model_size=2, device=CUDA), True, False),
    (CUDA, ONE, False, False),
], ids=["cuda", "cpu", "world_size_2", "model_size_2", "no_grad"])
def test_graph_engages_on_one_cuda_process_with_autograd(device, mesh, grad,
                                                         want):
    with torch.set_grad_enabled(grad):
        assert tstep.graph_engages(device, mesh) is want
        graph = tstep.StepGraph(device, mesh)
        module, batch = _module(), _batch()
        plans = [graph.plan(module, batch) for _ in range(4)]
    assert plans == (["eager", "eager", "capture", "capture"] if want
                     else ["eager"] * 4)


def test_capture_on_the_third_step_of_a_signature():
    graph = tstep.StepGraph(CUDA, ONE)
    module, a, b = _module(), _batch(), _batch(b=1)
    plans = [graph.plan(module, x) for x in (a, b, a, b, a)]
    assert plans == ["eager", "eager", "eager", "eager", "capture"]


def _changed(leaf: str, what: str) -> dict:
    batch = _batch()
    v = batch[leaf]
    batch[leaf] = {"shape": lambda: torch.zeros(v.shape[0] + 1,
                                                *v.shape[1:]),
                   "dtype": lambda: v.to(torch.float64),
                   "strides": lambda: v.transpose(-1, -2).contiguous()
                   .transpose(-1, -2)}[what]()
    return batch


@pytest.mark.parametrize("what", ["shape", "dtype", "strides"])
@pytest.mark.parametrize("leaf", ["image_seq", "tgt_poses"])
def test_another_signature_runs_eagerly(leaf, what):
    module, batch = _module(), _batch()
    other = _changed(leaf, what)
    assert tstep.signature(other) != tstep.signature(batch)
    graph = tstep.StepGraph(CUDA, ONE)
    _captured(graph, module, batch)
    assert graph.plan(module, batch) == "replay"
    assert [graph.plan(module, other) for _ in range(4)] == ["eager"] * 4
    assert graph.plan(module, batch) == "replay"


def test_another_module_or_moved_parameters_run_eagerly():
    module, batch = _module(), _batch()
    graph = tstep.StepGraph(CUDA, ONE)
    _captured(graph, module, batch)
    assert graph.plan(_module(), batch) == "eager"
    with torch.no_grad():
        module.weight.data = module.weight.data.clone()
    assert graph.plan(module, batch) == "eager"


@pytest.mark.parametrize("spd", [1, 2])
def test_cpu_step_counts_eager_steps_and_never_captures(spd):
    cfg = tconfig.get_config("default", TINY + [
        "model.dtype=float32", f"train.steps_per_dispatch={spd}"])
    src = SyntheticScenes(num_scenes=2, image_size=32, seq_len=1,
                          num_targets=2)
    batch = src.batch(range(2), raw=True)
    if spd > 1:
        batch = {k: torch.stack([torch.as_tensor(v)] * spd)
                 for k, v in batch.items()}
    state = tstep.init_state(cfg, seed=0, device="cpu")
    step = tstep.make_train_step(cfg, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(4):
            step(state, batch)
    rec = profiling.recordings()[-1]
    assert rec.counters == {"dmv3d.train.graph.eager_steps": 4 * spd}
    names = {s.name for s in rec.spans}
    assert "dmv3d.train.graph" not in names
    assert {"dmv3d.encode", "dmv3d.train.backward"} <= names


# ---------------------------------------------------------------- the card


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: captures a CUDA graph")
    prev = torch.backends.cudnn.deterministic
    # deterministic cuDNN: two eager runs agree bitwise, so a graphed run
    # is held to them bitwise
    torch.backends.cudnn.deterministic = True
    yield CUDA
    torch.backends.cudnn.deterministic = prev


def _c2_like(spd=1):
    return tconfig.get_config("c2", TINY + [f"train.steps_per_dispatch={spd}"])


# the c2 preset with the depth switches: c2d runs #2, #7 and the depth
# backward's composite launch, c2g #1, #6, #3 and its sample launch
DEPTH = {"c2d": ["model.synthesis=depth", "model.predict_depth=true"],
         "c2g": ["model.predict_depth=true"]}


def _c3md_like(spd=4, preset="c3md"):
    return tconfig.get_config(preset, TINY + [
        "data.seq_len=3", "data.num_scenes=4", "train.warmup_steps=4",
        "train.num_steps=64", f"train.steps_per_dispatch={spd}"])


def _bank(cfg):
    source = pipeline.make_source(cfg.data)
    source.materialize_packed()
    return tresident.ResidentFrames(source, cfg.data, CUDA)


def _host_batches(cfg, n, b=None):
    src = SyntheticScenes(num_scenes=8, image_size=cfg.data.image_size,
                          seq_len=cfg.data.seq_len,
                          num_targets=cfg.data.num_targets, seed=3)
    b = b or cfg.data.batch_size
    return [src.batch(range(i, i + b), raw=True) for i in range(n)]


def _state(cfg):
    return tstep.init_state(cfg, seed=0, device=CUDA)


def _eager(cfg, resident=None):
    """An eager step: a fresh ``make_train_step`` for each call, which
    never reaches a signature's third step."""
    def step(state, batch=None):
        return tstep.make_train_step(cfg, device=CUDA,
                                     resident=resident)(state, batch)
    return step


def _tensors(state) -> dict:
    out = {f"p.{n}": p.detach() for n, p in
           state.module.named_parameters()}
    named = dict(state.module.named_parameters())
    for n, p in named.items():
        for key, v in state.optimizer.state.get(p, {}).items():
            if torch.is_tensor(v) and v.dim():
                out[f"{key}.{n}"] = v
    return out


def _gap(a, b) -> float:
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys() and a.step == b.step
    return max(float((ta[k].float() - tb[k].float()).abs().max())
               for k in ta)


def _hold(graphed, eager, other_eager, metrics_g, metrics_e):
    """The graphed state no further from an eager one than two eager runs
    are from each other: bitwise where those agree bitwise."""
    spread = _gap(eager, other_eager)
    gap = _gap(graphed, eager)
    assert gap <= spread, (gap, spread)
    if spread == 0:
        assert metrics_g == metrics_e
    else:
        for m, n in zip(metrics_g, metrics_e):
            assert m.keys() == n.keys()


def _hold_host_steps(cfg, cuda):
    """6 graphed steps of ``cfg`` on host batches held to two eager runs
    from the same start, with the graphed run's counters."""
    batches = _host_batches(cfg, 6)
    runs = {}
    for name, make in (("graphed", lambda: tstep.make_train_step(
            cfg, device=cuda)), ("eager", lambda: _eager(cfg)),
            ("eager2", lambda: _eager(cfg))):
        state, step = _state(cfg), make()
        with profile(activities=[ProfilerActivity.CPU]):
            metrics = [step(state, b)[1] for b in batches]
        runs[name] = state, metrics, profiling.recordings()[-1].counters
    _hold(runs["graphed"][0], runs["eager"][0], runs["eager2"][0],
          runs["graphed"][1], runs["eager"][1])
    assert runs["graphed"][2] == {"dmv3d.train.graph.eager_steps": 2,
                                  "dmv3d.train.graph.captures": 1,
                                  "dmv3d.train.graph.replays": 4}
    assert runs["eager"][2] == {"dmv3d.train.graph.eager_steps": 6}


@pytest.mark.cuda
def test_graphed_c2_like_steps_equal_eager_ones(cuda):
    _hold_host_steps(_c2_like(), cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(DEPTH))
def test_graphed_depth_steps_equal_eager_ones(cuda, variant):
    _hold_host_steps(tconfig.get_config("c2", TINY + DEPTH[variant]), cuda)


def _hold_dispatches(cfg, cuda):
    """3 graphed dispatches of ``cfg`` (device sampling, 4 steps a
    dispatch) held to two eager runs of 12 single steps from the same
    start."""
    one = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, steps_per_dispatch=1))
    bank = _bank(cfg)
    graphed = _state(cfg)
    step = tstep.make_train_step(cfg, device=cuda, resident=bank)
    with profile(activities=[ProfilerActivity.CPU]):
        metrics_g = [step(graphed)[1] for _ in range(3)]
    counters = profiling.recordings()[-1].counters
    assert counters["dmv3d.train.graph.captures"] == 1
    assert counters["dmv3d.train.graph.replays"] == 10
    assert counters["dmv3d.train.graph.eager_steps"] == 2
    # T frames a step whose Python runs: two eager steps and the capture
    assert counters["dmv3d.encode.recomputed_frames"] == 3 * 3
    states, means = [], []
    for _ in range(2):
        state, eager = _state(cfg), _eager(one, bank)
        per_step = [eager(state)[1] for _ in range(12)]
        states.append(state)
        means.append([{k: float(torch.tensor(
            [m[k] for m in per_step[i:i + 4]]).mean()) for k in per_step[0]}
            for i in range(0, 12, 4)])
    _hold(graphed, states[0], states[1], [], [])
    for m, n in zip(metrics_g, means[0]):
        assert m.keys() == n.keys()
        for k in m:
            assert m[k] == pytest.approx(n[k], rel=1e-5, abs=1e-7)


@pytest.mark.cuda
def test_graphed_c3md_like_dispatches_equal_eager_steps(cuda):
    _hold_dispatches(_c3md_like(), cuda)


@pytest.mark.cuda
def test_graphed_c3mf_like_dispatches_equal_eager_steps(cuda):
    _hold_dispatches(_c3md_like(preset="c3mf"), cuda)


@pytest.mark.cuda
def test_a_mid_run_batch_of_another_shape_runs_eagerly(cuda):
    cfg = _c2_like()
    batches = _host_batches(cfg, 7)
    batches[4] = _host_batches(cfg, 1, b=1)[0]       # one example
    states = []
    for make in (lambda: tstep.make_train_step(cfg, device=cuda),
                 lambda: _eager(cfg), lambda: _eager(cfg)):
        state, step = _state(cfg), make()
        with profile(activities=[ProfilerActivity.CPU]):
            for b in batches:
                step(state, b)
        states.append((state, profiling.recordings()[-1].counters))
    _hold(states[0][0], states[1][0], states[2][0], [], [])
    assert states[0][1] == {"dmv3d.train.graph.eager_steps": 3,
                            "dmv3d.train.graph.captures": 1,
                            "dmv3d.train.graph.replays": 4}


@pytest.mark.cuda
def test_a_callers_zero_grad_does_not_cut_the_graph_off(cuda):
    cfg = _c2_like()
    batches = _host_batches(cfg, 6)
    states = []
    for make in (lambda: tstep.make_train_step(cfg, device=cuda),
                 lambda: _eager(cfg), lambda: _eager(cfg)):
        state, step = _state(cfg), make()
        for b in batches:
            step(state, b)
            state.optimizer.zero_grad(set_to_none=True)
        states.append(state)
    _hold(*states, [], [])
    assert all(p.grad is None for p in states[0].module.parameters())


@pytest.mark.cuda
def test_hooks_and_a_patched_draw_fire_once_a_step(cuda):
    cfg = _c3md_like()
    bank = _bank(cfg)
    state = _state(cfg)
    step = tstep.make_train_step(cfg, device=cuda, resident=bank)
    fired = {"pre": 0, "post": 0, "draw": 0}

    def hook(name):
        def count(*_):
            fired[name] += 1
        return count
    draw = bank.device_sample

    def counted(*args, **kw):
        fired["draw"] += 1
        return draw(*args, **kw)
    bank.device_sample = counted
    handles = [state.optimizer.register_step_pre_hook(hook("pre")),
               state.optimizer.register_step_post_hook(hook("post"))]
    try:
        for _ in range(3):
            step(state)
    finally:
        for h in handles:
            h.remove()
        del bank.device_sample
    assert fired == {"pre": 12, "post": 12, "draw": 12}
    assert state.step == 12
