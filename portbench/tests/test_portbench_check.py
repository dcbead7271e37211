"""A whole run of each cell at a tiny size on the CPU, the look for a card
skipped: the program as it is comes out correct, each planted fault and
the fp8 control come out not correct under the cell's own limits. The
program computes in float32 here (its bf16 rounding at widths of 4-8
channels is no measure of the card's), so its readings sit far below the
limits; the control and the faults are what the test is about. On the
card (``-m cuda``) the control runs at the cell's own size."""

import json
import time

import pytest
import torch

from portbench import calibrate, check, harness

CELLS = [w["name"] for w in json.loads(
    (harness.CHECKOUT / "BENCHMARK.json").read_text())["workloads"]]


def tiny(name: str) -> dict:
    cell = harness.load_cell(name)
    m = cell["config_file"]["config"]["model"]
    m.update(image_size=16, base_features=4, max_features=8, num_levels=2,
             gru_features=8, pose_embed_dim=8, src_head_features=4,
             dtype="float32", warp_precision="exact")
    cell["config_file"]["config"]["data"]["image_size"] = 16
    t = cell["traffic_file"]
    t.update(batch=2, targets=3, pool=3, trace=[1, 2],
             seq_len=min(t["seq_len"], 3))
    if "compare" in t:
        t["compare"] = 3
    return cell


def _run(cell, seed=2**31 + 3, trace=False):
    return harness.run_cell(cell, seed, 0.5, trace, "cpu",
                            time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = _run(tiny(name), trace=True)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0


FAULTS = [(n, f) for n in CELLS
          for f in harness.kind(harness.load_cell(n)).FAULTS]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_planted_fault_is_not_correct(name, fault):
    cell = tiny(name)
    with harness.kind(cell).FAULTS[fault]():
        out = _run(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = tiny(name)
    numbers = calibrate.control(cell, 7, torch.device("cpu"))
    assert not check.passed(numbers, cell["limits"]), numbers


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control at the cell's size")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_on_the_card(name, card):
    cell = harness.load_cell(name)
    numbers = calibrate.control(cell, 2**31 + 17, card)
    assert not check.passed(numbers, cell["limits"]), numbers
