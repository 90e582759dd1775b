"""The online sessions of the PyTorch port (models/session) against the JAX
package's on the same pushes, and against the port's own replay entry point
(`Localizer.run`), as tests/test_session.py holds the JAX ones: frames 0-1
carry invalid GPS (the start waits), frame 2 initializes, frame 3 runs the
coarse ladder and its fine step, frame 7 is invalid.

Against JAX: poses 3e-4, ICP error 1e-3, phases, correspondence counts and
converged flags EQUAL. Against the port's replay, which runs the same code
on the same frames: poses to 1e-6."""

import dataclasses

import numpy as np
import pytest

from slam_sensor_fusion_tpu.models import session as js
from slam_sensor_fusion_tpu_torch.models import localization as tl
from slam_sensor_fusion_tpu_torch.models import session as ts
from torch_parity import jax_config
from torch_world import SLICE_CONFIG, build_world

#: the per-frame engine on K3 (bench.py bench_latency's session)
FAST = dataclasses.replace(
    SLICE_CONFIG, superblock_parity=False, block_kernel=False,
    icp=dataclasses.replace(SLICE_CONFIG.icp, mode="fast"),
)
#: the default per-frame parity engine
PARITY = dataclasses.replace(SLICE_CONFIG, superblock_parity=False, block_kernel=False)
#: micro-blocks of two frames on the parity superblock (K1)
BLOCK = dataclasses.replace(SLICE_CONFIG, superstep=2)


@pytest.fixture(scope="module")
def world():
    seq, map_data = build_world(n_frames=12, seed=4)
    seq.gps_alt[:2] = -1.0
    seq.gps_alt[7] = -1.0
    return seq, map_data


def _push_all(sess, seq):
    out = []
    for i in range(len(seq.scans)):
        r = sess.push(seq.scans[i], seq.odom_T_sensor[i], float(seq.gps_lat[i]),
                      float(seq.gps_lon[i]), float(seq.gps_alt[i]), float(seq.compass_yaw[i]),
                      float(seq.odom_cov_trace[i]), float(seq.gps_cov_trace[i]))
        out.extend(r if isinstance(r, list) else [r])
    return out


def _replay(map_data, cfg, seq, chunk):
    return tl.Localizer(map_data, cfg, device="cpu").run(
        seq.scans, seq.odom_T_sensor, seq.gps_lat, seq.gps_lon, seq.gps_alt,
        seq.compass_yaw, seq.odom_cov_trace, seq.gps_cov_trace, chunk=chunk,
    )


def _assert_pushes_equal(got, want):
    assert [r.phase for r in got] == [r.phase for r in want]
    np.testing.assert_allclose(np.stack([r.map_T_sensor for r in got]),
                               np.stack([r.map_T_sensor for r in want]), rtol=0, atol=3e-4)
    for name in ("n_correspondences", "icp_converged"):
        assert [getattr(r, name) for r in got] == [getattr(r, name) for r in want], name
    np.testing.assert_allclose([r.icp_error for r in got], [r.icp_error for r in want],
                               rtol=0, atol=1e-3)


def test_localizer_session_matches_jax(world):
    seq, map_data = world
    got = _push_all(ts.LocalizerSession(map_data, FAST, profile=True, device="cpu"), seq)
    want = _push_all(js.LocalizerSession(map_data, jax_config(FAST)), seq)
    _assert_pushes_equal(got, want)
    assert [r.phase for r in got[:5]] == ["skipped", "skipped", "init", "tracking", "tracking"]
    assert got[7].phase == "skipped"
    np.testing.assert_array_equal(got[7].map_T_sensor, got[6].map_T_sensor)


def test_localizer_session_profile_and_replay(world):
    """The per-frame session equals the replay's per-frame engine
    (parity mode, K2), and `profile` times each steady-state push."""
    seq, map_data = world
    sess = ts.LocalizerSession(map_data, PARITY, profile=True, device="cpu")
    got = _push_all(sess, seq)
    res = _replay(map_data, PARITY, seq, chunk=5)
    poses = np.stack([r.map_T_sensor for r in got])
    np.testing.assert_allclose(poses[res.valid], res.map_T_sensor[res.valid], rtol=0, atol=1e-6)
    assert [r.phase == "tracking" for r in got] == list(res.valid)
    assert set(sess.last_timing) == {"host_ms", "dispatch_ms", "device_ms"}
    assert all(v >= 0 for v in sess.last_timing.values())


def test_block_session_matches_jax_and_replay(world):
    seq, map_data = world
    sess = ts.BlockLocalizerSession(map_data, BLOCK, profile=True, device="cpu")
    got = _push_all(sess, seq)
    want = _push_all(js.BlockLocalizerSession(map_data, jax_config(BLOCK)), seq)
    _assert_pushes_equal(got, want)
    assert len(got) == len(seq.scans)  # 4 startup pushes + 4 whole blocks
    res = _replay(map_data, BLOCK, seq, chunk=2)
    tracking = np.asarray([r.phase == "tracking" for r in got])
    np.testing.assert_array_equal(tracking, res.valid)
    np.testing.assert_allclose(np.stack([r.map_T_sensor for r in got])[tracking],
                               res.map_T_sensor[tracking], rtol=0, atol=1e-6)
    assert set(sess.last_timing) == {"host_ms", "dispatch_ms", "device_ms"}
    with pytest.raises(ValueError, match="block_kernel"):
        ts.BlockLocalizerSession(map_data, FAST, device="cpu")
