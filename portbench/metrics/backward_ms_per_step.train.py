"""Model and layers (autograd's backward): the host's self milliseconds a
train step in the program's span ``dmv3d.train.backward``, over the steps
of the profiled device-only slice."""

from portbench import spans


def read(run):
    return spans.ms_per_unit({"dmv3d.train.backward"})
