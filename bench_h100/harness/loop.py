"""The one traffic generator: it reads a mix's parameters and drives a
cell's system with them.

A closed loop: each client sends its next request when its last one has
come back (a replay service working through logs). Warm-up passes run
before the window and count as set-up; in the window the clients send
until `seconds` have passed, and the window ends when the last request
sent has come back.
"""

from __future__ import annotations

import time
from typing import NamedTuple

from harness.trace import WINDOW, traced


class Record(NamedTuple):
    index: int
    t_submit: float  # host clock (s)
    t_done: float  # the request's answer on the host
    result: object


class Window(NamedTuple):
    records: list
    t0: float
    t1: float
    counters: dict  # the program's counters' growth over the window
    trace: object  # TraceData or None


def check_mix(traffic: dict) -> None:
    if traffic.get("loop") != "closed" or int(traffic.get("clients", 0)) != 1:
        raise ValueError(f"unsupported mix {traffic}: one client in a closed loop")


def run(system, traffic: dict, seconds: float, trace_on: bool) -> Window:
    """Warm up, then measure `seconds` of requests. `system` gives
    `requests_per_pass`, `request(i) -> result` (back on the host when it
    returns), `counters() -> dict` and `sync()`."""
    from torch.profiler import record_function

    check_mix(traffic)
    for i in range(int(traffic["warmup_passes"]) * system.requests_per_pass):
        system.request(i)
    system.sync()
    before = system.counters()
    records = []
    with traced(trace_on) as tr:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            i = 0
            while True:
                ts = time.perf_counter()
                if ts - t0 >= seconds:
                    break
                with record_function("bench.request"):
                    res = system.request(i)
                records.append(Record(i, ts, time.perf_counter(), res))
                i += 1
            t1 = records[-1].t_done if records else time.perf_counter()
    after = system.counters()
    return Window(records, t0, t1, {k: after[k] - before.get(k, 0) for k in after}, tr.data)
