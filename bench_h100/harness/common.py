"""What every part of the harness shares: finding a cell's files by name,
loading them, and the statistics of a run."""

from __future__ import annotations

import importlib.util
import json
import math
import os
import statistics
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str):
    """Import a harness file by its path (names may hold '.' and '-')."""
    name = "bench_h100_" + "".join(c if c.isalnum() else "_" for c in os.path.relpath(path, HERE))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of BENCHMARK.json with its configuration, its traffic
    mix and the metrics it reports, found by name under `base` (the
    harness's folder)."""

    def __init__(self, bench: dict, workload: str, root: str = ROOT, base: str = HERE):
        by_name = {w["name"]: w for w in bench["workloads"]}
        if workload not in by_name:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = by_name[workload]
        entry = {c["name"]: c for c in bench["configs"]}[self.workload["config"]]
        self.config = load_json(os.path.join(root, entry["file"]))
        self.traffic = load_json(os.path.join(base, "traffic", self.workload["traffic"] + ".json"))
        self.base = base
        self.chips = int(self.workload["chips"])

        def mine(m):
            return "workloads" not in m or workload in m["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]

    def system(self):
        """The module that drives the configuration's system (`System`)."""
        return load_module(os.path.join(self.base, "systems", self.config["system"] + ".py"))

    def metric(self, name: str):
        return load_module(os.path.join(self.base, "metrics", name + ".py"))


def percentile(xs, q: float) -> float:
    """The q-th percentile (0-100) of all samples, linear between ranks
    (numpy's default rule)."""
    s = sorted(xs)
    if not s:
        raise ValueError("percentile of no samples")
    pos = (len(s) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def spread(xs) -> float:
    """Inter-quartile distance as a share of the median, with
    `statistics.quantiles(values, n=4)`'s quartiles."""
    q1, med, q3 = statistics.quantiles(xs, n=4)
    return (q3 - q1) / med


def union_seconds(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def gaps(intervals, lo: float, hi: float):
    """(start, end) stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]
