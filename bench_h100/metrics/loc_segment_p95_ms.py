"""loc_segment_p95_ms: the 95th percentile over all segments completed in
the window, from a segment's sending to its poses on the host (ms)."""

from harness.common import percentile


def read(ctx):
    lat = [1e3 * (r.t_done - r.t_submit) for r in ctx.window.records]
    return percentile(lat, 95) if lat else None
