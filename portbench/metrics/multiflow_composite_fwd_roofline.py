"""Kernel #4 (``kernels/multiflow.py``, ``multiflow_fwd_kernel``): its
bound at the request's shape over its mean device time in the profiled
slice."""


def work(b, t, k, hw, c=3):
    """(bytes, operations) of a launch: the b x t frames once; per pixel of
    the k targets ix, iy, conf of every source, mask, rgb in; view, multi,
    any_valid and the t weights out."""
    px = k * hw * hw
    return 4 * (b * t * c * hw * hw + b * px * (3 * t + 1 + c)
                + b * px * (2 * c + 1 + t)), b * px * t * (30 + 14 * c)


def read(run):
    return run.roofline(work, "multiflow_fwd_kernel")
