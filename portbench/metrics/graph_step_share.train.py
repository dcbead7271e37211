"""API (``train/step.py``): % of the optimizer steps in the profiled
device-only slice that replayed the step's captured CUDA graph of the
forward, the loss and the backward: the program's counters
``dmv3d.train.graph.replays`` over it plus ``.eager_steps``, in
``recordings()[0]``. None where the program counts neither."""

from portbench import spans


def read(run):
    rec = spans.recording()
    counters = getattr(rec, "counters", None) or {}
    replays = counters.get("dmv3d.train.graph.replays", 0)
    eager = counters.get("dmv3d.train.graph.eager_steps", 0)
    if replays + eager == 0:
        return None
    return 100.0 * replays / (replays + eager)
