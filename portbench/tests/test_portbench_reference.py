"""The plain reference against the program at a tiny float32 size on the
CPU (forward and one train step), and the benchmark's own counts of work
against the port's kernel table and FLOP count."""

import dataclasses

import pytest
import torch

from portbench import byname, traffic, weights
from portbench.reference import dmv3d
from portbench.reference import train as ref_train

TINY = dict(image_size=16, base_features=4, max_features=8, num_levels=2,
            gru_features=8, pose_embed_dim=8, src_head_features=4,
            dtype="float32", warp_precision="exact")


def _tiny(preset):
    from dynamic_multiview_3d_torch import config
    cfg = config.get_config(preset)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                             **TINY))
    return cfg, config.to_dict(cfg)


def _program(cfg, params, train=False):
    from dynamic_multiview_3d_torch.models import DMV3D
    module = DMV3D(cfg.model, num_sources=cfg.data.seq_len)
    module.load_state_dict(params)
    return module.train(train)


@pytest.mark.parametrize("preset,t,k,views", [("c2", 1, 3, "fixed"),
                                              ("c3md", 3, 2, "orbit")])
def test_forward_matches_the_program(preset, t, k, views):
    from dynamic_multiview_3d_torch import api
    cfg, d = _tiny(preset)
    shapes = dmv3d.param_shapes(d["model"])
    params = weights.draw(shapes, 2**31 + 11, "cpu")
    module = _program(cfg, params)
    assert list(shapes) == list(module.state_dict())
    req = traffic.pool({"pool": 1, "batch": 2, "seq_len": t, "targets": k,
                        "src_views": views, "frames": "float32",
                        "target_images": False}, 16, 3, "cpu")[0]
    got = api.Model(cfg, module).predict(
        req["image_seq"], req["tgt_poses"], source_poses=req["src_poses"])
    with dmv3d.exact_f32(), torch.no_grad():
        want = dmv3d.Net(d["model"], params).forward(
            *(torch.as_tensor(req[n])
              for n in ("image_seq", "src_poses", "tgt_poses")))["view"]
    assert got.shape == want.shape
    assert float((got - want).abs().max()) < 1e-4


@pytest.mark.parametrize("preset,t,k,views", [("c2", 1, 3, "fixed"),
                                              ("c3md", 3, 2, "orbit")])
def test_train_steps_match_the_program(preset, t, k, views):
    # c2: flow synthesis, a constant learning rate; c3md: multidepth with
    # its geometric loss, the cosine schedule's warm-up; two steps, so the
    # schedule's second learning rate and Adam's second update count
    from dynamic_multiview_3d_torch.train import step as tstep
    cfg, d = _tiny(preset)
    # one step a call on host batches (the preset's resident bank and
    # dispatches of 16 are the loop's, not the step's)
    cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, steps_per_dispatch=1),
        data=dataclasses.replace(cfg.data, device_sampling=False,
                                 device_resident="off"))
    params = weights.draw(dmv3d.param_shapes(d["model"]), 5, "cpu")
    batches = traffic.pool({"pool": 2, "batch": 2, "seq_len": t,
                            "targets": k, "src_views": views,
                            "frames": "uint8", "target_images": True},
                           16, 4, "cpu")
    module = _program(cfg, params, train=True)
    state = tstep.TrainState(module,
                             tstep.make_optimizer(cfg, module.parameters()))
    step = tstep.make_train_step(cfg, device="cpu")
    losses = []
    for i, batch in enumerate(batches):
        _, metrics = step(state, batch)
        losses.append(metrics["loss/total"])
        if i == 0:
            first = {n: state.optimizer.state[p]["exp_avg"].clone()
                     / (1 - d["train"]["beta1"])
                     for n, p in module.named_parameters()}
    ref = ref_train.run_steps(d["model"], d["train"], params,
                              [{n: torch.as_tensor(v)
                                for n, v in b.items()} for b in batches])
    assert losses == pytest.approx(ref["losses"], abs=1e-5)
    # the gradient as Adam holds it after one step: its first moment over
    # 1 - beta1; elementwise against the reference's, within a millionth
    # of the median parameter's gradient norm (Adam's step itself turns
    # rounding-sized gradients into steps of the learning rate)
    norms = sorted(float(g.norm()) for g in ref["first_grads"].values())
    scale = norms[len(norms) // 2]
    for name, p in module.named_parameters():
        gap = float((first[name] - ref["first_grads"][name]).abs().max())
        assert gap < 1e-6 * max(scale, 1.0), name
        # Adam's steps where the gradient is well above that
        big = ref["first_grads"][name].abs() > 1e-4
        change = (p.detach() - params[name])[big]
        assert torch.allclose(change, ref["change"][name][big], rtol=1e-3,
                              atol=1e-9), name


def test_reference_goes_on_from_a_state():
    # three steps at once, and one then two from the state it leaves
    _, d = _tiny("c3md")
    params = weights.draw(dmv3d.param_shapes(d["model"]), 6, "cpu")
    batches = [{n: torch.as_tensor(v) for n, v in b.items()}
               for b in traffic.pool({"pool": 3, "batch": 1, "seq_len": 2,
                                      "targets": 1, "src_views": "orbit",
                                      "frames": "uint8",
                                      "target_images": True}, 16, 5, "cpu")]
    whole = ref_train.run_steps(d["model"], d["train"], params, batches)
    one = ref_train.run_steps(d["model"], d["train"], params, batches[:1],
                              keep_state=True)
    mid = {k: params[k] + c for k, c in one["change"].items()}
    two = ref_train.run_steps(d["model"], d["train"], mid, batches[1:],
                              state=one["state"])
    assert one["losses"] + two["losses"] == pytest.approx(whole["losses"],
                                                          rel=1e-5)
    for k in params:
        assert torch.allclose(one["change"][k] + two["change"][k],
                              whole["change"][k], rtol=1e-4, atol=1e-8), k


@pytest.mark.parametrize("metric,shape,nbytes", [
    ("warp_composite_fwd_roofline", (16, 1, 8, 128), 112_197_632),
    ("warp_composite_bwd_roofline", (16, 1, 8, 128), 128_974_848),
    ("multiflow_composite_fwd_roofline", (8, 8, 2, 128), 57_671_680)])
def test_kernel_bytes_match_the_kernel_table(metric, shape, nbytes):
    # PERF.md's kernel table at the c2 shape (#1, #3) and c3md's (#4)
    assert byname.load("metrics", metric).work(*shape)[0] == nbytes


def test_flops_of_a_c2_scene():
    from dynamic_multiview_3d_torch import config
    conf = {"config": config.to_dict(config.get_config("c2"))}
    serve = byname.load("kinds", "serve_closed")
    train = byname.load("kinds", "train_hostbatch")
    one = {"batch": 1, "seq_len": 1, "targets": 8}
    assert round(serve.flops(conf, one) / 1e9, 2) == 21.65
    assert serve.flops(conf, dict(one, batch=16)) \
        == pytest.approx(16 * serve.flops(conf, one), rel=1e-12)
    assert 2.5 < train.flops(conf, one) / serve.flops(conf, one) < 3.5
