"""Kernel #1 (``kernels/grid_sample.py``, ``warp_composite_fwd_kernel``):
its bound at the request's shape over its mean device time in the
profiled slice."""


def work(b, t, k, hw, c=3):
    """(bytes, operations) of a launch: per target pixel ix, iy, mask, rgb
    in, view and warped out, validity out; the b frames once."""
    n, p = b * k, hw * hw
    return 4 * (n * p * (3 + c + 2 * c + 1) + b * c * p), n * p * (20 + 12 * c)


def read(run):
    return run.roofline(work, "warp_composite_fwd_kernel")
