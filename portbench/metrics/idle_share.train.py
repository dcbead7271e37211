"""Device: the share of the profiled slice (``torch.profiler``, after the
window) in which no operation ran on the card: 1 - busy_s / window_s of
the slice, the device's intervals' union over the slice's length. The
profiler's tracing slows the host's launches, so the slice reads idler
than the unprofiled window; what makes the card wait on the host moves
both alike."""


def read(run):
    t = run.trace
    if not t or not t.busy_s or not t.window_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
