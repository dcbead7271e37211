"""Model and layers (``models/dmv3d.py``): the host's self milliseconds a
train step in the program's forward spans ``dmv3d.encode``, ``dmv3d.decode``
and ``dmv3d.synthesis``, over the steps of the profiled device-only
slice."""

from portbench import spans


def read(run):
    return spans.ms_per_unit({"dmv3d.encode", "dmv3d.decode",
                              "dmv3d.synthesis"})
