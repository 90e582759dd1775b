"""loc.device_idle_pct: 100 - the device's busy time (the union of the
recorded device intervals, plus the time of K1 launches the profiler
dropped at its recorded mean) over the traced window's wall time (%)."""

from harness.kernels import missing


def read(ctx):
    t = ctx.trace
    if t is None or not t.device:
        return None
    _, lost_s = missing(t, ctx.window.counters, "K1")
    return 100.0 * (1.0 - (t.busy_s() + lost_s) / t.window_s)
