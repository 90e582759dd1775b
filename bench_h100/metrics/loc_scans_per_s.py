"""loc_scans_per_s: scans of all segments completed in the window over the
window's seconds (host clock, first send to last answer)."""


def read(ctx):
    w = ctx.window
    if not w.records:
        return None
    return sum(ctx.system.frames(r.result) for r in w.records) / (w.t1 - w.t0)
