"""API layer (``api.Model.predict``): % of the profiled device-only slice's
device-idle seconds (the gaps between its device operations) that lie
inside the program's ``dmv3d.predict.inputs`` spans, on the profiler's
clock: how much of the card's idle time the input copy makes."""

from portbench import spans


def read(run):
    return spans.idle_share_inside(run.trace, {"dmv3d.predict.inputs"})
