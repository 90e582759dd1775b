#!/usr/bin/env python3
"""`voxel_segment_sum` on four groups, on one GPU.

    python3 slam_sensor_fusion_tpu_torch/csrc/bench/segsum_groups.py [--package DIR] [--label NAME]

Imports the package of the checkout at DIR (default: this one; a `git
archive` of a parent commit unpacked under the git-ignored `_parent/`
gives the parent's kernel, built into DIR's own `_build/`) and times its
`segment_sum_sorted` on groups of 131 072 sorted rows of 4 floats:
`skewed`, ~30 000 segments of geometric lengths (at most 400 rows), and
`ties`, chip_smoke.py's tie-heavy group (one run of 10 000 rows, then
singletons, then a fifth of the rows aliased to the last id with zero
payload, half of it -0.0), and that group's two long runs apart (`dense
run`: the alias rows made nonzero singletons; `zero run`: the first
10 000 rows made singletons). Each call's bits are held against the plain
version's; then the kernel and `index_add_` on the same rows are timed
back to back by CUDA events (mean of `--reps` calls after a warm-up) and
on the card alone (the profiler's device time a call). One JSON line a
group, with the card's name and power limit. Run parent, change, change,
parent in one call to compare two trees on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))


def groups(dev):
    import numpy as np
    import torch

    rng = np.random.default_rng(12)
    n = 1 << 17
    lens = np.minimum(rng.geometric(0.25, 1 << 15), 400)
    seg = np.repeat(np.arange(1 << 15), lens)[:n]
    vals = (rng.standard_normal((n, 4)) * 40).astype(np.float32)
    out = {"skewed": (vals, seg.astype(np.int32), 1 << 15)}
    # chip_smoke.tie_heavy_group
    rng = np.random.default_rng(9)
    n_alias = n // 5
    n_single = n - n_alias - 10_000
    seg = np.concatenate([np.zeros(10_000, np.int32), np.arange(1, n_single + 1, dtype=np.int32)])
    U = n_single + 2
    seg = np.concatenate([seg, np.full(n_alias, U - 1, np.int32)])
    vals = (rng.standard_normal((n, 4)) * 30).astype(np.float32)
    vals[-n_alias:] = 0.0
    vals[-n_alias::2] = -0.0
    out["ties"] = (vals, seg, U)
    # its two long runs apart: the 10 000-row nonzero run (the alias rows
    # nonzero singletons), and the 26 214-row zero run (the first 10 000
    # rows singletons)
    dense_seg = seg.copy()
    dense_seg[-n_alias:] = np.arange(U - 1, U - 1 + n_alias)
    dense_vals = vals.copy()
    dense_vals[-n_alias:] = 1.0
    out["dense run"] = (dense_vals, dense_seg, U - 1 + n_alias)
    zero_seg = seg + 9_999
    zero_seg[:10_000] = np.arange(10_000)
    out["zero run"] = (vals, zero_seg, U + 9_999)
    return {k: (torch.from_numpy(v).to(dev), torch.from_numpy(s).to(dev), U)
            for k, (v, s, U) in out.items()}


def events_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps, names):
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and any(n in e.key for n in names))
    return us / 1e3 / reps if us > 0 else None


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", default=ROOT, help="checkout whose package is timed")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.package))
    import torch

    if not torch.cuda.is_available():
        sys.exit("segsum_groups: no CUDA device")
    from slam_sensor_fusion_tpu_torch.ops import voxel_segsum as vs

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    for name, (vals, seg, U) in groups(dev).items():
        got = vs.segment_sum_sorted(vals, seg, U)
        want = vs.segment_sum_sorted_plain(vals, seg, U)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            sys.exit(f"segsum_groups: {name}: the kernel's bits differ from the plain version's")
        idx = seg.long()

        def library():
            return torch.zeros_like(want).index_add_(0, idx, vals)

        def kernel():
            return vs.segment_sum_sorted(vals, seg, U)

        print(json.dumps({
            "label": args.label, "group": name, "rows": vals.shape[0], "segments": U,
            "longest_run": int(torch.bincount(seg.long()).max()),
            "ms_events": events_ms(kernel, args.reps),
            "ms_card": device_ms(kernel, args.reps, ("segment_sum_sorted_kernel",)),
            "index_add_ms_events": events_ms(library, args.reps),
            "index_add_ms_card": device_ms(library, args.reps, ("index",)),
            "card": card,
        }), flush=True)


if __name__ == "__main__":
    main()
