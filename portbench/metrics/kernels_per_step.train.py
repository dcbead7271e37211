"""Model and layers (``models/dmv3d.py``, ``models/layers.py``): device
kernels launched per train step in the profiled slice (``torch.profiler``),
copies and fills left out."""


def read(run):
    t = run.trace
    return t.kernel_count / t.units if t and t.kernel_count else None
