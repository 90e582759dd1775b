"""Tracing / profiling utilities (port of the JAX `utils/profiling.py`).

The reference instruments with wall-clock logs behind `enable_debug`
(localization_node.cpp:286-287,350-353 "CALLBACK TOOK %f seconds"; ICP
step prints icp_point_to_point.cpp:172-183). On the card:

* `StageTimer` — named wall-clock stages that end with a
  `torch.cuda.synchronize`, printable like the reference's debug log;
* `trace(dir)` — context manager around `torch.profiler` (CPU and CUDA
  activity) that writes a chrome trace into `dir`;
* `summarize_trace(dir)` — host-side aggregation of that trace's device
  operations by total duration;
* `kernel_launches()` — the launch counts of the port's hand-written
  kernels in this process.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import time
from collections import defaultdict

import torch

#: chrome-trace categories torch.profiler gives operations on the card
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class StageTimer:
    """Wall-clock stage timer with device synchronization."""

    def __init__(self):
        self.stages: dict[str, float] = {}
        #: seconds of the stage that ended last
        self.last = 0.0

    @contextlib.contextmanager
    def stage(self, name: str, sync: torch.Tensor | None = None):
        """Time the block, adding to `stages[name]`; with `sync`, the stage
        ends when the card has finished the work queued for that tensor's
        device."""
        t0 = time.perf_counter()
        yield
        if sync is not None and sync.is_cuda:
            torch.cuda.synchronize(sync.device)
        self.last = time.perf_counter() - t0
        self.stages[name] = self.stages.get(name, 0.0) + self.last

    def report(self) -> str:
        total = sum(self.stages.values())
        lines = [f"TOTAL {total * 1000:.2f} ms"]
        for k, v in sorted(self.stages.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {k}: {v * 1000:.2f} ms")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU, and CUDA where a card is present) and write
    its chrome trace to `log_dir/trace_<ns>.json`. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.time_ns()}.json"))


def summarize_trace(log_dir: str, top: int = 25) -> list[tuple[str, float, int]]:
    """Aggregate the device operations (kernels, copies, fills) of the
    newest chrome trace in log_dir by duration.

    Returns [(op_name, total_ms, count)] sorted by total duration.
    """
    files = sorted(
        glob.glob(f"{log_dir}/**/*.json", recursive=True), key=os.path.getmtime
    )
    if not files:
        return []
    with open(files[-1]) as f:
        events = json.load(f)["traceEvents"]
    dur = defaultdict(float)
    cnt = defaultdict(int)
    for e in events:
        if e.get("ph") == "X" and "dur" in e and e.get("cat") in _DEVICE_CATEGORIES:
            name = e.get("name", "?")
            dur[name] += e["dur"]
            cnt[name] += 1
    out = sorted(dur.items(), key=lambda kv: -kv[1])[:top]
    return [(name, d / 1000.0, cnt[name]) for name, d in out]


def kernel_launches() -> dict[str, int]:
    """Launches of each hand-written kernel in this process (its wrapper's
    count: kernel launches on CUDA tensors; plain versions count none)."""
    from slam_sensor_fusion_tpu_torch.ops import p2p_fused as p2p
    from slam_sensor_fusion_tpu_torch.ops.icp_fused import _fused_core
    from slam_sensor_fusion_tpu_torch.ops.lio_superblock_fused import lio_superblock
    from slam_sensor_fusion_tpu_torch.ops.nn_pallas import pair_nn
    from slam_sensor_fusion_tpu_torch.ops.ordered_scan import cumsum_rows
    from slam_sensor_fusion_tpu_torch.ops.superblock_fused import superblock_fine
    from slam_sensor_fusion_tpu_torch.ops.voxel_segsum import segment_sum_sorted
    from slam_sensor_fusion_tpu_torch.ops.xla_math import xla_math

    return {
        "K1": superblock_fine.launches,
        "K2": pair_nn.launches,
        "K3": _fused_core.launches,
        "K4": p2p._p2p_core.launches,
        "K5": p2p._p2p_associate.launches,
        "K6": p2p._p2p_gn_corr.launches,
        "K7": lio_superblock.launches,
        "voxel_segment_sum": segment_sum_sorted.launches,
        "cumsum_rows": cumsum_rows.launches,
        "xla_math": xla_math.launches,
    }
