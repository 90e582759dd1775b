"""The lite pipeline (the reference's Python twin, models/localization_lite)
of the PyTorch port against the JAX package: the two crops it adds to
ops/cloud, one frame whose map crop is empty (a full no-op), and `run_lite`
over a short run of tests/torch_world.py's world with ICP on K3 (the JAX
side runs its Pallas kernel in interpret mode, the port its plain version).

Poses agree to 3e-4 (tests/test_superblock_kernel.py's bound: the moment
sums round in another order); the crops' masks are EQUAL."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import torch

from slam_sensor_fusion_tpu.models import localization_lite as jlite
from slam_sensor_fusion_tpu.ops import cloud as jcl
from slam_sensor_fusion_tpu.ops import icp_fused as jif
from slam_sensor_fusion_tpu.utils.config import ICPConfig as JICPConfig
from slam_sensor_fusion_tpu_torch.models import localization_lite as tlite
from slam_sensor_fusion_tpu_torch.models.mapping import gps_to_map_poses
from slam_sensor_fusion_tpu_torch.ops import cloud as tcl
from torch_parity import t
from torch_world import build_world


def test_crop_box_and_obb_match_jax():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-10, 10, (500, 3)).astype(np.float32)
    jc, tc = jcl.from_numpy(pts, 512), tcl.from_numpy(pts, 512, device="cpu")
    lo, hi = np.asarray([0.0, -2.0, 0.0], np.float32), np.asarray([5.0, 2.0, 3.0], np.float32)
    np.testing.assert_array_equal(
        tcl.crop_box(tc, t(lo), t(hi)).mask.numpy(),
        np.asarray(jcl.crop_box(jc, jnp.asarray(lo), jnp.asarray(hi)).mask),
    )
    T = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.7), np.sin(0.7)
    T[:2, :2] = [[c, -s], [s, c]]
    T[:3, 3] = [1.0, -2.0, 0.5]
    ext = np.asarray([12.0, 4.0, 9.0], np.float32)
    got = tcl.crop_obb(tc, t(T), t(ext)).mask.numpy()
    np.testing.assert_array_equal(got, np.asarray(jcl.crop_obb(jc, jnp.asarray(T), jnp.asarray(ext)).mask))
    assert 0 < got.sum() < 500


def test_lite_step_empty_crop_is_full_noop():
    """A map far from the coarse pose: the twin skips the WHOLE frame,
    neither map_T_sensor nor odom_previous updates
    (localization_node.py:226-228); a map in range updates both."""
    rng = np.random.default_rng(1)
    cfg = dataclasses.replace(tlite.LiteConfig(), scan_capacity=256)
    buf = np.zeros((256, 3), np.float32)
    buf[:100] = rng.uniform(1.0, 10.0, (100, 3))
    msk = np.arange(256) < 100
    odom_prev, odom_cur, gps_T = (np.eye(4, dtype=np.float32) for _ in range(3))
    odom_prev[:3, 3] = [1.0, 2.0, 0.0]
    odom_cur[:3, 3] = [1.5, 2.0, 0.0]
    gps_T[:3, 3] = [0.4, 0.1, 0.0]
    state = tlite.init_state(torch.eye(4), t(odom_prev))
    far = tcl.from_numpy(rng.uniform(500.0, 520.0, (512, 3)).astype(np.float32), 512, "cpu")
    new, out = tlite.lite_step(state, t(buf), t(msk), t(odom_cur), t(gps_T), far, cfg)
    assert bool(out.cropped_map_empty)
    assert torch.equal(new.map_T_sensor, torch.eye(4))
    assert torch.equal(new.odom_T_sensor_previous, t(odom_prev))
    near = tcl.from_numpy(rng.uniform(0.0, 12.0, (512, 3)).astype(np.float32), 512, "cpu")
    new, out = tlite.lite_step(state, t(buf), t(msk), t(odom_cur), t(gps_T), near, cfg)
    assert not bool(out.cropped_map_empty)
    assert torch.equal(new.odom_T_sensor_previous, t(odom_cur))


def test_run_lite_matches_jax(monkeypatch):
    """Six frames, scan capacity 8192 (32 source tiles of 256, the whole
    scan, as tests/test_lite.py runs it) against the whole map's pages,
    masked by the oriented crop. A capacity that keeps only part of the
    scan leaves too narrow a correspondence set: the Kabsch step is then so
    ill-conditioned that summation order alone moves it by millimetres."""
    seq, map_data = build_world(n_frames=6, seed=4)
    gps_T = gps_to_map_poses(map_data, seq.gps_lat, seq.gps_lon, seq.compass_yaw)
    cfg = dataclasses.replace(tlite.LiteConfig(), scan_capacity=8192)
    jcfg = dataclasses.replace(
        jlite.LiteConfig(), scan_capacity=8192,
        icp=JICPConfig(**dataclasses.asdict(cfg.icp)),
    )
    # the JAX twin calls its Pallas K3 for the TPU; on the CPU it runs in
    # interpret mode, as the JAX package's own K3 tests run it
    monkeypatch.setattr(jlite, "icp_align_fused",
                        functools.partial(jif.icp_align_fused, interpret=True))
    want = jlite.run_lite(map_data.map_points, seq.scans, seq.odom_T_sensor, gps_T, jcfg)
    got = tlite.run_lite(map_data.map_points, seq.scans, seq.odom_T_sensor, gps_T, cfg,
                         device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-4)
    err = np.linalg.norm(got[1:, :3, 3] - seq.true_map_T_sensor[1:, :3, 3], axis=1)
    assert err.mean() < 0.3, err

