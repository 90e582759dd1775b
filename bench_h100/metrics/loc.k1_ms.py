"""loc.k1_ms: K1's (`ops/superblock_fused.superblock_fine`) device time a
launch in the traced window (ms), the mean over the launches the profiler
recorded."""

from harness.kernels import ms_per_launch


def read(ctx):
    return None if ctx.trace is None else ms_per_launch(ctx.trace, "K1")
