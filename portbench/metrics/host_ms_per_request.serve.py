"""API layer (``api.Model.predict``): the host's milliseconds in one
``predict`` call, from the call until it returns with the views still
being computed on the card; the mean over every request of the window
(the benchmark's own host-clock span around the call)."""

import statistics


def read(run):
    return 1e3 * statistics.fmean(run.host_s) if run.host_s else None
