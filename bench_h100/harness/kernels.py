"""Device time of the port's hand-written kernels in a traced window,
made good for the launches the profiler drops: the port counts every
launch (`utils/profiling.kernel_launches`), the trace records most."""

from __future__ import annotations

#: the port's launch counter and the trace name of each kernel's symbol
KERNELS = {
    "K1": lambda name: "superblock_kernel" in name and "lio_" not in name,
}


def recorded(trace, kernel: str) -> tuple[float, int]:
    """(seconds, launches) the trace recorded of `kernel`."""
    match = KERNELS[kernel]
    sec, n = 0.0, 0
    for name, s, e in trace.device:
        if match(name):
            sec, n = sec + (e - s), n + 1
    return sec, n


def ms_per_launch(trace, kernel: str) -> float | None:
    sec, n = recorded(trace, kernel)
    return 1e3 * sec / n if n and sec > 0 else None


def missing(trace, counters: dict, kernel: str) -> tuple[int, float]:
    """(launches the trace lacks, the device seconds they stand for at the
    recorded mean)."""
    sec, n = recorded(trace, kernel)
    lost = max(int(counters.get(kernel, 0)) - n, 0)
    return lost, (lost * sec / n if n else 0.0)
