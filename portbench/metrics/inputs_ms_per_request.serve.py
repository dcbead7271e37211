"""API layer (``api.Model.predict``): the host's self milliseconds a request
in the program's span ``dmv3d.predict.inputs`` (the inputs' float32
conversion and their copy to the card), over the requests of the profiled
device-only slice."""

from portbench import spans


def read(run):
    return spans.ms_per_unit({"dmv3d.predict.inputs"})
