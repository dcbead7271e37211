"""Model and layers (``models/dmv3d.py``): the host's self milliseconds a
request in the program's span ``dmv3d.encode`` (the recurrent encoder over
the frames), over the requests of the profiled device-only slice."""

from portbench import spans


def read(run):
    return spans.ms_per_unit({"dmv3d.encode"})
