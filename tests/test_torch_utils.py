"""The port's utilities (utils/debugging.py, utils/profiling.py,
utils/png.py), mirroring tests/test_utils.py: the NaN tripwire raises at
the operator that makes a NaN, in the forward and in the backward, and
restores the state it found; TraceWindow snaps to dispatch boundaries and
leaves a trace file; the PNG writer's files decode (imageio) to the image
written."""

import json
import os

import imageio.v2 as imageio
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from dynamic_multiview_3d_torch.utils import debugging, png, profiling


def test_debug_mode_raises_on_a_forward_nan():
    with pytest.raises(FloatingPointError, match="log"):
        with debugging.debug_mode():
            torch.log(torch.zeros(4) - 1.0)


def test_debug_mode_raises_on_a_backward_nan():
    x = torch.tensor([0.0, 1.0], requires_grad=True)
    with debugging.debug_mode():
        y = (torch.sqrt(x) * 0.0).sum()          # forward is finite
        with pytest.raises(FloatingPointError):
            y.backward()                         # 0 * inf in the backward


def test_debug_mode_restores_its_state():
    assert _get_current_dispatch_mode() is None
    with debugging.debug_mode():
        assert _get_current_dispatch_mode() is not None
        torch.square(torch.ones(2))              # clean ops still fine
        torch.empty(1000)                        # unwritten memory is not a NaN
    assert _get_current_dispatch_mode() is None
    with pytest.raises(FloatingPointError):
        with debugging.debug_mode():
            torch.log(-torch.ones(1))
    assert _get_current_dispatch_mode() is None
    assert torch.isnan(torch.log(-torch.ones(1))).all()    # off again
    with debugging.debug_mode(nans=False):
        assert torch.isnan(torch.log(-torch.ones(1))).all()


def test_trace_window_snaps_to_dispatch_boundaries(tmp_path):
    tw = profiling.TraceWindow(str(tmp_path), (3, 5))
    # dispatches of 2 steps: [0,2) misses the window start
    tw.maybe_start(0, 2)
    assert not tw.active
    tw.maybe_start(2, 4)                               # 2 <= 3 < 4 -> start
    assert tw.active
    torch.ones(8).sum()
    tw.maybe_stop(4)                                   # 4 < 5: keep going
    assert tw.active
    tw.maybe_stop(6)
    assert not tw.active
    assert os.listdir(tmp_path) == ["trace_steps_2-6.json"]
    with open(tmp_path / "trace_steps_2-6.json") as f:
        assert json.load(f)["traceEvents"]


def test_trace_window_close_writes_an_open_trace(tmp_path):
    tw = profiling.TraceWindow(str(tmp_path), (0, 10))
    tw.maybe_start(0, 1)
    tw.close()
    assert not tw.active
    assert os.listdir(tmp_path) == ["trace_steps_0-.json"]


def test_trace_window_disabled_without_logdir():
    tw = profiling.TraceWindow(None, (0, 1))
    tw.maybe_start(0, 1)
    assert not tw.active
    tw.close()


@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (128, 96)])
def test_png_round_trip(tmp_path, shape):
    img = np.random.default_rng(0).integers(0, 256, shape + (3,),
                                            dtype=np.uint8)
    png.write_png(str(tmp_path / "a.png"), img)
    back = imageio.imread(tmp_path / "a.png")
    assert back.dtype == np.uint8
    np.testing.assert_array_equal(back, img)


@pytest.mark.parametrize("bad", [np.zeros((4, 4, 3), np.float32),
                                 np.zeros((4, 4), np.uint8),
                                 np.zeros((4, 4, 4), np.uint8)])
def test_png_refuses_other_images(tmp_path, bad):
    with pytest.raises(ValueError, match="uint8"):
        png.write_png(str(tmp_path / "a.png"), bad)
