"""The whole train step: the FLOPs of the window's train steps (the reference's
count of forward and backward at the step's shape, the kind's ``flops``) over the window's
host-clock length, as a share of the H100's 989 TFLOP/s bf16 dense peak
at 700 W."""

from portbench import counts


def read(run):
    return 100.0 * run.flops_per_unit * run.units / run.window_s \
        / counts.BF16_FLOPS
