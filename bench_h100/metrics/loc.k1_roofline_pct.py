"""loc.k1_roofline_pct: K1's bound over its device time a launch (%). The
bound of a launch is the larger of its distances (8 FLOP each, tile_src x
tile_tgt over the tile pairs its frames' `pair_demand` admits, one
association a frame) at the f32 peak and its input and output bytes once
at the memory rate; the mean over the window's launches."""

import numpy as np

from harness import roofline
from harness.kernels import ms_per_launch


def read(ctx):
    if ctx.trace is None:
        return None
    ms = ms_per_launch(ctx.trace, "K1")
    if ms is None:
        return None
    sh = ctx.system.shapes()
    pk = roofline.peak(ctx.device_name)
    n_bytes = roofline.k1_bytes(sh["K"], sh["n_src_tiles"], sh["tile_src"], sh["n_tgt_tiles"],
                                sh["tile_tgt"], sh["max_pairs"], sh["queue"])
    bounds = []
    for r in ctx.window.records:
        demand = ctx.system.pair_demand(r.result)
        for blk in np.asarray(demand).reshape(-1, sh["K"]):
            flops = roofline.k1_flops(int(blk.sum()), sh["tile_src"], sh["tile_tgt"])
            bounds.append(roofline.bound_ms(flops, n_bytes, pk)[0])
    return 100.0 * float(np.mean(bounds)) / ms if bounds else None
