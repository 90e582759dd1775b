#!/usr/bin/env python3
"""cumsum_rows (csrc/ordered_scan.cu) on one GPU: ms a call on the card
alone (a CUDA graph's replay) and by CUDA events, beside torch.cumsum's and
the bound, with the bits held against the plain version.

    python3 slam_sensor_fusion_tpu_torch/csrc/bench/scan_rows.py [--package DIR] [--label NAME]

The `--package` rule of lio_paths.py: a `git archive` of a parent commit
unpacked under the git-ignored `_parent/` gives the parent's package, and
this checkout's chip_smoke.py gives the inputs (phase 17's seeded rows,
-0.0 rows included) and the bound, so two trees run the same inputs.
Shapes: the LIO anchor's 65 536 x 10, phase 14's 4097 x 10 and
2^20 + 3 x 10, and 700 x 60 (16-row chunks). Each on-card time is the
median of 5 replays of a graph of 20 calls. The kernel launches a call
come from the library's own count where it has one (null before it did).
One JSON line a shape, with the card's name and power limit. Run parent,
change, change, parent in one call to compare two trees on one card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))

SHAPES = ((65536, 10), (4097, 10), (2**20 + 3, 10), (700, 60))


def smoke_helpers():
    """This checkout's chip_smoke.py as a module, whichever package is on
    the path."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", default=ROOT, help="checkout whose package runs")
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.package))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("scan_rows: no CUDA device")
    from slam_sensor_fusion_tpu_torch.ops import cuda_lib
    from slam_sensor_fusion_tpu_torch.ops.ordered_scan import cumsum_rows, cumsum_rows_plain

    cs = smoke_helpers()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    so = cuda_lib.lib()
    counter = getattr(so, "sfk_cumsum_kernel_launches", None)
    if counter is not None:
        counter.restype = __import__("ctypes").c_longlong
    for N, C in SHAPES:
        rng = np.random.default_rng(N + C)
        x = (rng.normal(0.0, 1.0, (N, C)) * 10.0 ** rng.uniform(-3, 6, (N, 1))).astype(np.float32)
        x[rng.uniform(size=N) < 0.1] = -0.0
        xd = torch.from_numpy(x).cuda()
        got = cumsum_rows(xd)
        torch.cuda.synchronize()
        want = cumsum_rows_plain(torch.from_numpy(x))
        bits_equal = bool(torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)))
        launches = None
        if counter is not None:
            before = counter()
            cumsum_rows(xd)
            torch.cuda.synchronize()
            launches = counter() - before
        ms = cs.time_ms(lambda: cumsum_rows(xd), 50)
        alone = sorted(cs.graph_ms(lambda: cumsum_rows(xd), 20) for _ in range(5))[2]
        lib_ms = cs.time_ms(lambda: torch.cumsum(xd, dim=0), 50)
        lib_alone = sorted(cs.graph_ms(lambda: torch.cumsum(xd, dim=0), 20) for _ in range(5))[2]
        bound_ms, bound_by = cs.bound(2.0 * N * C, 2.0 * N * C * 4)
        print(json.dumps({"label": args.label, "card": card, "rows": N, "cols": C,
                          "bits_equal": bits_equal, "launches_a_call": launches,
                          "ms_events": ms, "ms_card_alone": alone, "bound_ms": bound_ms,
                          "bound_by": bound_by, "torch_cumsum_ms_events": lib_ms,
                          "torch_cumsum_ms_card_alone": lib_alone}), flush=True)


if __name__ == "__main__":
    main()
