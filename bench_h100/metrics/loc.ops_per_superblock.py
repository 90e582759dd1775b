"""loc.ops_per_superblock: the program's device operations in the traced
window (kernels, copies, fills; K1 launches the profiler dropped counted
back; not the harness's copies of each request's outputs) over the
superblocks run (K1's launch counter)."""

from harness.kernels import missing


def read(ctx):
    if ctx.trace is None:
        return None
    blocks = int(ctx.window.counters.get("K1", 0))
    if blocks == 0:
        return None
    lost, _ = missing(ctx.trace, ctx.window.counters, "K1")
    return (ctx.trace.program_ops() + lost) / blocks
