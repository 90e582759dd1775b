"""The traced window: torch.profiler over CPU and CUDA activity, reduced to
device intervals by name and the host operations around them.

The profiler is known to drop some launches of the port's kernels (PERF.md:
3 of 20 for most `xla_math` functions), so a kernel's time a launch is the
mean over the launches it recorded, and its share of the busy time is
made up from the port's own launch counters (`utils/profiling.
kernel_launches`), as `chip_smoke.device_ms_by_kernel` does.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

import torch

from harness.common import gaps, union_seconds

WINDOW = "bench.window"
#: the span around a system's copies of a request's outputs to the host:
#: the device operations launched inside it are the harness's
COLLECT = "bench.collect"
#: a device operation's name as the breakdown keeps it (C++ kernel names
#: run to thousands of characters)
NAME_CHARS = 160


def _start_s(e) -> float:
    return e.start_ns() * 1e-9 if hasattr(e, "start_ns") else e.start_us() * 1e-6


def _duration_s(e) -> float:
    return e.duration_ns() * 1e-9 if hasattr(e, "duration_ns") else e.duration_us() * 1e-6


class TraceData:
    """Device operations (kernels, copies, fills: the events on the CUDA
    device) and host operations (CPU ops, runtime calls, the harness's
    spans) of the traced window, in seconds on the profiler's clock."""

    def __init__(self, events):
        self.device = []  # (name, start_s, end_s)
        self.host = []  # (name, start_s, end_s) CPU ops, runtime calls, spans
        self.window = None
        cuda = torch.autograd.DeviceType.CUDA
        device_ids, launches, collect = [], [], []
        for e in events:
            name = e.name()
            s, d = _start_s(e), _duration_s(e)
            cid = e.correlation_id() if hasattr(e, "correlation_id") else 0
            if name.startswith("bench."):
                if name == WINDOW and e.device_type() != cuda:
                    self.window = (s, s + d)
                elif e.device_type() != cuda:
                    self.host.append((name, s, s + d))
                    if name == COLLECT:
                        collect.append((s, s + d))
            elif e.device_type() == cuda:
                self.device.append((name, s, s + d))
                device_ids.append(cid)
            else:
                self.host.append((name, s, s + d))
                if cid and name.startswith("cuda"):
                    launches.append((cid, s))
        if self.window is None:
            raise ValueError("the trace holds no window span")
        # runtime calls made inside a collect span and the device
        # operations they launched (one correlation id for both)
        harness = {cid for cid, s in launches if any(a <= s < b for a, b in collect)}
        lo, hi = self.window
        kept = [(op, cid in harness) for op, cid in zip(self.device, device_ids)
                if op[2] > lo and op[1] < hi]
        self.device = [(n, max(s, lo), min(e, hi)) for (n, s, e), _ in kept]
        #: device operations of the window that the harness launched
        self.harness_ops = sum(mine for _, mine in kept)

    def program_ops(self) -> int:
        """Device operations of the window that the program launched."""
        return len(self.device) - self.harness_ops

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union of
        the recorded intervals)."""
        return union_seconds((s, e) for _, s, e in self.device)

    def by_name(self) -> dict:
        """{name: (seconds, count)} of the recorded device operations."""
        out = defaultdict(lambda: [0.0, 0])
        for n, s, e in self.device:
            out[n][0] += e - s
            out[n][1] += 1
        return {k: tuple(v) for k, v in out.items()}

    def top_ops(self, k: int = 10):
        items = sorted(self.by_name().items(), key=lambda kv: -kv[1][0])[:k]
        return [[name[:NAME_CHARS], s] for name, (s, _) in items]

    def idle_gaps(self, k: int = 10):
        """The idle time of the window by what the host was doing when each
        gap began (the innermost host operation open at that moment), the
        longest first."""
        lo, hi = self.window
        holes = gaps([(s, e) for _, s, e in self.device], lo, hi)
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        by_label = defaultdict(float)
        for gs, ge in holes:
            i = bisect.bisect_right(starts, gs)
            label = "host, between operations"
            # the latest-starting host operation still open at gs
            for j in range(i - 1, max(i - 400, -1), -1):
                name, s, e = host[j]
                if e > gs:
                    label = name
                    break
            by_label[label] += ge - gs
        items = sorted(by_label.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:NAME_CHARS], s] for n, s in items]


@contextlib.contextmanager
def traced(enabled: bool):
    """Profile the block (CPU and CUDA) when `enabled`; yields a holder
    whose `.data` is the TraceData once the block has ended."""
    holder = type("Holder", (), {"data": None})()
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield holder
        if cuda:
            torch.cuda.synchronize()
    holder.data = TraceData(prof.profiler.kineto_results.events())
