"""The on-device sensor model (gen/sensor.py), on the CPU at a small site."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
from tiny import tiny_config

from gen import sensor


def _log(seed):
    c = tiny_config()
    site = dict(c["site"], extent=c["world_extent_m"])
    log = dict(c["log"], frames=c["log_frames"])
    stride = c["localization"]["scan_subsample_step"]
    return sensor.make_log(site, log, c["assumed"], seed, "cpu", stride), log


def _bytes(lg):
    parts = [lg.world, lg.poses] + [x for s in lg.scans for x in s] + list(lg.streams)
    return b"".join(t.contiguous().numpy().tobytes() for t in parts)


def test_same_seed_same_bytes():
    a, _ = _log(2**31 + 11)
    b, _ = _log(2**31 + 11)
    assert _bytes(a) == _bytes(b)


def test_other_seed_same_sweeps_in_another_order():
    """Another seed orders each sweep's points otherwise: the same world,
    truth, streams and sweep contents, so the same work."""
    a, _ = _log(3)
    b, _ = _log(4)
    assert torch.equal(a.world, b.world) and torch.equal(a.poses, b.poses)
    assert all(torch.equal(x, y) for x, y in zip(a.streams, b.streams))
    def rows(p):
        p = p.numpy()
        return p[np.lexsort(p.T[::-1])]

    stride = tiny_config()["localization"]["scan_subsample_step"]
    for x, y in zip(a.scans, b.scans):
        assert not torch.equal(x.deskewed, y.deskewed)
        np.testing.assert_array_equal(rows(x.deskewed), rows(y.deskewed))
        # the localizer's subsample keeps the same points
        np.testing.assert_array_equal(rows(x.deskewed[::stride]), rows(y.deskewed[::stride]))
        assert not torch.equal(x.deskewed[::stride], y.deskewed[::stride])


@pytest.mark.parametrize("n,stride", [(1, 2), (7, 2), (10, 2), (11, 3), (5, 1)])
def test_firing_order_keeps_places_modulo_the_stride(n, stride):
    idx = sensor.firing_order(n, stride, sensor.generator(2**31 + 5, "cpu"), "cpu")
    assert sorted(idx.tolist()) == list(range(n))
    assert all(int(i) % stride == p % stride for p, i in enumerate(idx))


def test_scan_sizes():
    lg, log = _log(5)
    for i, s in enumerate(lg.scans):
        in_range = int((torch.linalg.norm(lg.world - lg.poses[i, :3, 3].float(), dim=1)
                        < log["max_range"]).sum())
        n = len(s.deskewed)
        assert n <= log["max_points"]
        assert n == in_range or 0.8 * log["max_points"] <= n


def test_noise_levels_come_from_the_configuration():
    """The configuration's `assumed` block sets every noise level: the
    range noise moves the sweeps, the GPS noise the fixes and their
    covariance, the odometry drift the odometry, the compass noise the
    fixes' yaw."""
    c = tiny_config()
    site = dict(c["site"], extent=c["world_extent_m"])
    log = dict(c["log"], frames=c["log_frames"])
    stride = c["localization"]["scan_subsample_step"]
    base = sensor.make_log(site, log, c["assumed"], 3, "cpu", stride)
    for key in ("range_noise_m", "gps_noise_m", "odom_drift", "compass_noise_rad"):
        other = sensor.make_log(site, log, dict(c["assumed"], **{key: 2 * c["assumed"][key]}),
                                3, "cpu", stride)
        sweeps = not torch.equal(base.scans[2].deskewed, other.scans[2].deskewed)
        odom = not torch.equal(base.streams.odom_T_sensor, other.streams.odom_T_sensor)
        gps = base.streams.map_T_sensor_gps - other.streams.map_T_sensor_gps
        assert (sweeps, odom) == (key == "range_noise_m", key == "odom_drift")
        assert bool(gps[:, :3, 3].abs().max() > 0) == (key == "gps_noise_m")
        assert bool(gps[:, :2, :2].abs().max() > 0) == (key == "compass_noise_rad")


def test_deskewed_points_lie_on_the_world():
    """A deskewed point is its world point (plus the 1 cm noise) seen from
    the end-of-sweep pose."""
    lg, _ = _log(6)
    i = 5
    T = lg.poses[i].float()
    w = lg.scans[i].deskewed @ T[:3, :3].T + T[:3, 3]
    d = torch.cdist(w[:200].double(), lg.world.double()).amin(dim=1)
    assert float(d.max()) < 0.06


def test_azimuth_taus_and_skew():
    lg, _ = _log(7)
    s = lg.scans[3]
    assert float(s.tau.min()) >= 0.0 and float(s.tau.max()) <= 1.0
    # the skewed points sit within the frame motion of the deskewed ones
    assert float((s.skewed - s.deskewed).norm(dim=1).max()) < 0.5


def test_imu_matches_the_turn_rate():
    lg, _ = _log(8)
    g = sensor.generator(1, "cpu")
    gyro, accel, dts = sensor.make_imu(g, lg.poses)
    T = lg.poses.shape[0]
    assert gyro.shape == (T - 1, 10, 3) and accel.shape == (T - 1, 10, 3)
    assert math.isclose(float(dts.sum(dim=1)[0]), 0.1, rel_tol=1e-6)
    yaw = np.unwrap(np.arctan2(lg.poses[:, 1, 0].numpy(), lg.poses[:, 0, 0].numpy()))
    rate = np.diff(yaw) / 0.1
    assert np.allclose(gyro[:, :, 2].mean(dim=1).numpy(), rate, atol=2e-3)
    # at rest on the arc the accelerometer reads about +g upward
    assert abs(float(accel[:, :, 2].mean()) - 9.80665) < 0.05
