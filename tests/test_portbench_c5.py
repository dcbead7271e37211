"""c5's shape on the CPU: the port against the benchmark's plain reference
(``portbench/reference``) at a tiny float32 size with c5's own levels,
frames, targets and remat, and the blocked reference step against the
whole-batch one."""

import dataclasses

import pytest
import torch

from portbench import traffic, weights
from portbench.reference import dmv3d
from portbench.reference import train as ref_train
from portbench.reference import train_blocked

# c5's six levels (64 -> 1), T = 4 frames of one fixed camera, K = 2,
# remat; tiny widths, float32 and the exact warp so that rounding is f32's
TINY = dict(image_size=64, base_features=4, max_features=32, gru_features=8,
            pose_embed_dim=8, dtype="float32", warp_precision="exact")
SHAPE = {"batch": 2, "seq_len": 4, "targets": 2, "src_views": "fixed"}



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tiny models: the suite runs
    several worker processes on a few cores, and torch's default of a
    thread per core each makes them wait on one another's threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _c5():
    from dynamic_multiview_3d_torch import config
    cfg = config.get_config("c5", ["mesh.data=1", "mesh.multihost=false"])
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **TINY),
        data=dataclasses.replace(cfg.data, image_size=64, batch_size=2))
    assert (cfg.model.num_levels, cfg.data.seq_len, cfg.data.num_targets,
            cfg.model.remat_scan) == (6, 4, 2, True)
    return cfg, config.to_dict(cfg)


def _program(cfg, params, train):
    from dynamic_multiview_3d_torch.models import DMV3D
    module = DMV3D(cfg.model, num_sources=cfg.data.seq_len)
    module.load_state_dict(params)
    return module.train(train)


def _batches(n, batch=2, seed=4):
    return traffic.pool(dict(SHAPE, batch=batch, pool=n, frames="uint8",
                             target_images=True), 64, seed, "cpu")


def _distance(got: dict, want: dict) -> float:
    """The distance between two gradients by name, all parameters
    together, over the norm of ``want``."""
    num = sum(float((got[k] - w).square().sum()) for k, w in want.items())
    return (num / sum(float(w.square().sum()) for w in want.values())) ** 0.5


def test_c5_forward_matches_the_reference():
    from dynamic_multiview_3d_torch import api
    cfg, d = _c5()
    params = weights.draw(dmv3d.param_shapes(d["model"]), 2**31 + 25, "cpu")
    req = traffic.pool(dict(SHAPE, pool=1, frames="float32",
                            target_images=False), 64, 3, "cpu")[0]
    got = api.Model(cfg, _program(cfg, params, False)).predict(
        req["image_seq"], req["tgt_poses"], source_poses=req["src_poses"])
    with dmv3d.exact_f32(), torch.no_grad():
        want = dmv3d.Net(d["model"], params).forward(
            *(torch.as_tensor(req[n])
              for n in ("image_seq", "src_poses", "tgt_poses")))["view"]
    assert got.shape == want.shape == (2, 2, 64, 64, 3)
    # both in float32 from the same weights: the views differ by the sum
    # orders of the convolutions and GroupNorm's statistics alone, which
    # tiny widths amplify at most ~100x float32's 1e-7
    assert float((got - want).abs().max()) < 1e-4


def test_c5_train_step_matches_the_reference():
    from dynamic_multiview_3d_torch.train import step as tstep
    cfg, d = _c5()
    params = weights.draw(dmv3d.param_shapes(d["model"]), 2**31 + 26, "cpu")
    batch = _batches(1)[0]
    module = _program(cfg, params, True)
    state = tstep.TrainState(module,
                             tstep.make_optimizer(cfg, module.parameters()))
    _, metrics = tstep.make_train_step(cfg, device="cpu")(state, batch)
    first = {n: state.optimizer.state[p]["exp_avg"]
             / (1 - d["train"]["beta1"]) for n, p in module.named_parameters()}
    ref = ref_train.run_steps(d["model"], d["train"], params,
                              [{n: torch.as_tensor(v)
                                for n, v in batch.items()}])
    # the loss: a mean over 2 x 2 views of 64 x 64 pixels, f32 rounding
    assert metrics["loss/total"] == pytest.approx(ref["losses"][0], abs=1e-5)
    # the gradient as Adam holds it after one step (its first moment over
    # 1 - beta1), all parameters together, within 1e-2 of the reference's
    # norm: the warp's bilinear taps and the frame border's validity switch
    # at whole pixels, and a coordinate a rounding away from one takes the
    # other side's slope on one side only; at this size that moves the
    # whole gradient by up to 1.8e-3 of its norm from the f64 one (the f32
    # reference itself reads 1.2e-3 on some seeds, 5e-6 on others)
    assert _distance(first, ref["first_grads"]) < 1e-2
    for name, p in module.named_parameters():
        # Adam's first step is -lr g / (|g| + eps): where the gradient is
        # well above eps and its rounding, the same step of the learning
        # rate on both sides
        big = ref["first_grads"][name].abs() > 1e-4
        change = (p.detach() - params[name])[big]
        assert torch.allclose(change, ref["change"][name][big], rtol=1e-3,
                              atol=1e-9), name


def _loss_f64(net, batch, train_cfg):
    """``reference.train.loss`` with the images in float64."""
    image_seq = batch["image_seq"].to(torch.float64) / 127.5 - 1.0
    target = batch["tgt_images"].to(torch.float64) / 127.5 - 1.0
    out = net.forward(image_seq, batch["src_poses"].double(),
                      batch["tgt_poses"].double())
    return net.synth.loss(out, target, train_cfg)


@pytest.mark.parametrize("block", [1, 2])
def test_blocked_step_equals_the_whole_batch_step(block, monkeypatch):
    # one step of a batch of 4 examples in float64: the blocks' mean loss
    # and gradient, and the Adam update made of them, equal the whole
    # batch's to float64 rounding. (In float32 they do too, but for the
    # samples whose coordinate lies a rounding from a whole pixel, where
    # the bilinear taps switch: the other summation order puts some on
    # the other side, 2e-3 of the gradient's norm on this batch.)
    monkeypatch.setattr(ref_train, "loss", _loss_f64)
    _, d = _c5()
    params = {k: v.double() for k, v in weights.draw(
        dmv3d.param_shapes(d["model"]), 2**31 + 27, "cpu").items()}
    batches = [{n: torch.as_tensor(v) for n, v in b.items()}
               for b in _batches(1, batch=4, seed=5)]
    whole = ref_train.run_steps(d["model"], d["train"], params, batches)
    blocked = train_blocked.run_steps(d["model"], d["train"], params,
                                      batches, block)
    assert blocked["losses"] == pytest.approx(whole["losses"], rel=1e-12)
    assert _distance(blocked["first_grads"], whole["first_grads"]) < 1e-10
    # the update, Adam's first step lr g / (|g| + 1e-8), wherever the
    # gradient stands above float64 rounding
    for k, g in whole["first_grads"].items():
        big = g.abs() > 1e-12
        assert torch.allclose(blocked["change"][k][big],
                              whole["change"][k][big], rtol=1e-8,
                              atol=0.0), k


@pytest.mark.parametrize("synthesis", ["multidepth", "flow.predict_depth"])
def test_blocked_step_refuses_a_loss_that_is_no_mean(synthesis):
    _, d = _c5()
    m = dict(d["model"], synthesis=synthesis.split(".")[0],
             predict_depth=synthesis.endswith("predict_depth"))
    with pytest.raises(ValueError, match="no mean"):
        train_blocked.run_steps(m, d["train"], {}, [], 1)
