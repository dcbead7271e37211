"""Optimizer (``train/step.py``): the host's self milliseconds a train step
in the program's spans ``dmv3d.train.optimizer`` (the lr and ``zero_grad``,
the gradients' average, the optimizer's step, the EMA), over the steps
of the profiled device-only slice."""

from portbench import spans


def read(run):
    return spans.ms_per_unit({"dmv3d.train.optimizer"})
