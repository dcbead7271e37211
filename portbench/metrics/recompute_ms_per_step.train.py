"""Model and layers (``models/dmv3d.py`` under ``remat_scan``): the host's
self milliseconds a unit in the program's span ``dmv3d.encode.recompute``,
the recurrent encoder's frames run again inside the backward, over the
units of the profiled device-only slice; None where the program records
no such span.

A host time: where the host paces the cell (``c3md.train``) it is the
cost of launching the recomputation; where the card paces it
(``c5.train-b128``) it is mostly the host waiting on a full launch queue
inside the recomputation, not the recomputation's device time."""

from portbench import spans


def read(run):
    return spans.ms_per_unit({"dmv3d.encode.recompute"})
