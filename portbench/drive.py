"""What every traffic kind's driver (``kinds/<kind>.py``) shares: the
program built from the cell's configuration and the benchmark's weights,
a clock of set-up's phases, the benchmark's own host spans, and a
patch of the program for the length of a block (the planted faults)."""

from __future__ import annotations

import contextlib
import time

import torch


class Program:
    """The program under test, built from the cell's configuration and the
    benchmark's weights."""

    def __init__(self, config: dict, params: dict, device, train: bool):
        from dynamic_multiview_3d_torch import config as config_lib
        from dynamic_multiview_3d_torch.models import DMV3D
        self.cfg = config_lib.from_dict(config["config"])
        module = DMV3D(self.cfg.model, num_sources=self.cfg.data.seq_len)
        module.load_state_dict({k: v.detach() for k, v in params.items()})
        self.module = module.to(device).train(train)


class Clock:
    """Seconds of each phase of a driver's set-up, the device's work
    included."""

    def __init__(self, device):
        self.device, self.laps = device, {}
        self.last = time.perf_counter()

    def lap(self, name):
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.laps[name] = now - self.last
        self.last = now


def span(name: str):
    """The benchmark's host span ``portbench.<name>`` in a profiled slice."""
    return torch.profiler.record_function(f"portbench.{name}")


@contextlib.contextmanager
def patched(obj, name, make):
    """``obj.name`` replaced by ``make(original)`` while the block runs."""
    original = getattr(obj, name)
    setattr(obj, name, make(original))
    try:
        yield
    finally:
        setattr(obj, name, original)
