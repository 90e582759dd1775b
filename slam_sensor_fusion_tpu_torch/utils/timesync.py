"""Approximate-time alignment of sensor streams (host side).

The replacement for C13 (SURVEY.md; a copy of the JAX package's
`utils/timesync.py`, the host fallback of `utils/native.nearest_within`): ROS 2
`message_filters::sync_policies::ApproximateTime` over (PointCloud2,
NavSatFix, Odometry) plus the plain compass subscription
(localization_node.cpp:62-84, map_data_save_node.cpp:35-57,
localization_node.py:67-79). Offline/log-replay form: for every scan
timestamp, pick the nearest GPS and odometry samples within `slop`
seconds (mirroring the Python node's queue_size=10/slop=0.1 semantics,
localization_node.py:72-76) and the latest compass heading at or before
the scan (a plain latched subscription in the reference).

Frames without an in-slop GPS or odometry match are dropped, exactly as
an approximate-time synchronizer would never fire for them.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def nearest_within(
    query_t: np.ndarray, stream_t: np.ndarray, slop: float
) -> tuple[np.ndarray, np.ndarray]:
    """For each query time, index of the nearest stream time and a
    validity mask (|dt| <= slop). Streams must be sorted ascending."""
    query_t = np.asarray(query_t, np.float64)
    stream_t = np.asarray(stream_t, np.float64)
    if stream_t.size == 0:
        return np.zeros(len(query_t), np.int64), np.zeros(len(query_t), bool)
    pos = np.searchsorted(stream_t, query_t)
    left = np.clip(pos - 1, 0, len(stream_t) - 1)
    right = np.clip(pos, 0, len(stream_t) - 1)
    d_left = np.abs(query_t - stream_t[left])
    d_right = np.abs(stream_t[right] - query_t)
    idx = np.where(d_left <= d_right, left, right)
    ok = np.abs(stream_t[idx] - query_t) <= slop
    return idx, ok


def latest_at_or_before(query_t: np.ndarray, stream_t: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Index of the newest stream sample at or before each query time
    (latched-subscription semantics for the compass)."""
    query_t = np.asarray(query_t, np.float64)
    stream_t = np.asarray(stream_t, np.float64)
    if stream_t.size == 0:
        return np.zeros(len(query_t), np.int64), np.zeros(len(query_t), bool)
    pos = np.searchsorted(stream_t, query_t, side="right") - 1
    ok = pos >= 0
    return np.clip(pos, 0, len(stream_t) - 1), ok


@dataclasses.dataclass
class AlignedStreams:
    """Output of align(): per-scan indices into each source stream."""

    scan_idx: np.ndarray  # (T,) kept scan indices
    gps_idx: np.ndarray  # (T,)
    odom_idx: np.ndarray  # (T,)
    compass_idx: np.ndarray  # (T,)


def align(
    scan_t: np.ndarray,
    gps_t: np.ndarray,
    odom_t: np.ndarray,
    compass_t: np.ndarray,
    slop: float = 0.1,
) -> AlignedStreams:
    """Align the four streams on scan timestamps.

    Returns only the scans for which GPS and odometry exist within the
    slop AND a compass heading has been received (the node gates on the
    compass too, localization_node.py:197-199).
    """
    gps_idx, gps_ok = nearest_within(scan_t, gps_t, slop)
    odom_idx, odom_ok = nearest_within(scan_t, odom_t, slop)
    cmp_idx, cmp_ok = latest_at_or_before(scan_t, compass_t)
    keep = gps_ok & odom_ok & cmp_ok
    sel = np.flatnonzero(keep)
    return AlignedStreams(
        scan_idx=sel,
        gps_idx=gps_idx[sel],
        odom_idx=odom_idx[sel],
        compass_idx=cmp_idx[sel],
    )
