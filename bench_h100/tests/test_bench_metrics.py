"""The yardstick's arithmetic: bounds, the busy union, idle gaps, kernel
time made good for dropped launches, percentiles and spreads."""

from __future__ import annotations

import statistics

import numpy as np
import pytest
import tiny  # noqa: F401  (puts the harness on the path)

from harness import common, kernels, roofline
from harness.trace import TraceData

H100 = roofline.peak("NVIDIA H100 80GB HBM3")


def test_k1_bound_at_kitti_shape():
    """PERF.md's K1 at 32 x 4096 against 128-row target tiles over 10 140
    tile pairs: 0.6348 ms, operations-bound (chip_smoke.py's bound)."""
    flops = roofline.k1_flops(10140, 4096, 128)
    n_bytes = roofline.k1_bytes(8, 32, 4096, 512, 128, 32 * 512, 4)
    ms, by = roofline.bound_ms(flops, n_bytes, H100)
    assert by == "operations"
    assert round(ms, 4) == 0.6348


def test_bytes_bound_when_no_pairs():
    ms, by = roofline.bound_ms(0.0, roofline.k1_bytes(8, 32, 4096, 512, 128, 16384, 4), H100)
    assert by == "bytes" and ms > 0


def test_unknown_card_has_no_peak():
    with pytest.raises(KeyError):
        roofline.peak("cpu")


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert common.union_seconds(iv) == 3.0
    assert common.gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert common.gaps([], 1.0, 2.0) == [(1.0, 2.0)]


@pytest.mark.parametrize("q", [50, 90, 95, 99])
def test_percentile_is_numpys(q):
    xs = list(np.random.default_rng(q).exponential(size=101))
    assert common.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)), rel=1e-12)


def test_spread_uses_statistics_quartiles():
    xs = [10.0, 11.0, 9.5, 10.2, 10.8, 9.9]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert common.spread(xs) == pytest.approx((q3 - q1) / med)


class _Ev:
    def __init__(self, name, start_s, dur_s, cuda, cid=0):
        import torch

        self._n, self._s, self._d, self._c = name, start_s, dur_s, cid
        self._t = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU

    def name(self):
        return self._n

    def start_ns(self):
        return int(self._s * 1e9)

    def duration_ns(self):
        return int(self._d * 1e9)

    def device_type(self):
        return self._t

    def correlation_id(self):
        return self._c


def _trace():
    ev = [
        _Ev("bench.window", 0.0, 10.0, False),
        _Ev("aten::item", 1.9, 1.2, False),
        _Ev("cudaStreamSynchronize", 2.0, 1.0, False),
        _Ev("void (anonymous namespace)::superblock_kernel<Global>(float)", 0.0, 2.0, True),
        _Ev("void (anonymous namespace)::superblock_kernel<Global>(float)", 4.0, 2.0, True),
        _Ev("void lio_superblock_kernel(float)", 6.0, 1.0, True),
        _Ev("elementwise", 1.5, 1.0, True),
        _Ev("elementwise", 11.0, 1.0, True),  # past the window
    ]
    return TraceData(ev)


def test_trace_reduction():
    t = _trace()
    assert t.window_s == pytest.approx(10.0)
    assert t.busy_s() == pytest.approx(5.5)  # [0, 2.5], [4, 7]
    assert kernels.recorded(t, "K1") == (pytest.approx(4.0), 2)
    assert kernels.ms_per_launch(t, "K1") == pytest.approx(2000.0)
    # one K1 launch the profiler dropped stands for one recorded mean
    assert kernels.missing(t, {"K1": 3}, "K1") == (1, pytest.approx(2.0))
    gaps = dict(t.idle_gaps())
    assert gaps["cudaStreamSynchronize"] == pytest.approx(1.5)  # [2.5, 4.0]
    assert gaps["host, between operations"] == pytest.approx(3.0)  # [7, 10]
    assert sum(gaps.values()) == pytest.approx(4.5)
    assert t.top_ops(1)[0][1] == pytest.approx(4.0)


def test_harness_copies_are_not_the_programs_operations():
    """Device operations launched inside a `bench.collect` span (matched
    to their runtime call by correlation id) are the harness's; they stay
    in the busy time but not in the program's count."""
    ev = [
        _Ev("bench.window", 0.0, 10.0, False),
        _Ev("cudaLaunchKernel", 1.0, 0.1, False, cid=7),
        _Ev("bench.collect", 2.0, 1.0, False),
        _Ev("cudaMemcpyAsync", 2.1, 0.1, False, cid=8),
        _Ev("cudaMemcpyAsync", 2.3, 0.1, False, cid=9),
        _Ev("kernel", 1.5, 1.0, True, cid=7),  # the program's, running into the span
        _Ev("Memcpy DtoH (Device -> Pinned)", 2.5, 0.1, True, cid=8),
        _Ev("Memcpy DtoH (Device -> Pinned)", 2.6, 0.1, True, cid=9),
    ]
    t = TraceData(ev)
    assert len(t.device) == 3 and t.harness_ops == 2 and t.program_ops() == 1
    assert t.busy_s() == pytest.approx(1.2)
