"""Kernel #3 (``kernels/grid_sample.py``, ``warp_composite_bwd_kernel``,
the training launch): its bound at the step's shape over its mean device
time in the profiled slice."""


def work(b, t, k, hw, c=3):
    """(bytes, operations) of the training launch (composite, no image
    gradient): ix, iy, mask, d_view, d_warped in, d_ix, d_iy, d_mask, d_rgb
    out; the frames once."""
    n, p = b * k, hw * hw
    return 4 * (n * p * (3 + 2 * c + 3 + c) + b * c * p), n * p * (30 + 35 * c)


def read(run):
    return run.roofline(work, "warp_composite_bwd_kernel")
