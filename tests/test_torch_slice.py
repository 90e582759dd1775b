"""The ported localization slice as a whole against the JAX package:
Localizer -> init_state -> coarse_attempt -> build_paged_frames ->
run_chunk_fast (parity ICP through the superblock kernel, superstep 8,
17 frames). Per-frame poses agree to 3e-4; iterations, correspondence
counts, overflow and slack flags are EQUAL. Also: the port never imports
jax."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_sensor_fusion_tpu.models import localization as jl
from slam_sensor_fusion_tpu.models import pipeline_fast as jpf
from torch_parity import jax_config, np_tree
from torch_world import SLICE_CONFIG, build_world, port_slice

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_slice(seq, map_data):
    cfg = jax_config(SLICE_CONFIG)
    loc = jl.Localizer(map_data, cfg)
    gps_T = loc.gps_poses(seq.gps_lat, seq.gps_lon, seq.compass_yaw)
    state = jl.init_state(cfg, loc.map_cloud.capacity, jnp.asarray(gps_T[0]),
                          jnp.asarray(seq.odom_T_sensor[0], jnp.float32))
    fb = jl.build_frame_batch(cfg, [seq.scans[1]], seq.odom_T_sensor[1:2], gps_T[1:2],
                              seq.odom_cov_trace[1:2], seq.gps_cov_trace[1:2], np.ones(1, bool))
    cm, ct, ref, _, coarse = jl.coarse_attempt(
        state, fb.scan_points[0], fb.scan_mask[0], loc.map_cloud, jnp.asarray(gps_T[0]), cfg
    )
    state = state._replace(map_T_sensor=coarse.map_T_sensor, cropped_map=cm, cached_target=ct, map_T_ref=ref)
    T = len(seq.scans) - 1
    frames = jpf.build_paged_frames(cfg, seq.scans[1:], seq.odom_T_sensor[1:], gps_T[1:],
                                    seq.odom_cov_trace[1:], seq.gps_cov_trace[1:], np.ones(T, bool))
    final, out = jpf.run_chunk_fast(state, frames, loc.map_cloud, cfg, interpret=True)
    return coarse, np_tree(final), np_tree(out)


@pytest.fixture(scope="module")
def world():
    return build_world(n_frames=17, seed=3)


def test_slice_matches_jax(world):
    seq, map_data = world
    jc, jfin, jout = _jax_slice(seq, map_data)
    tc, tfin, tout = port_slice(seq, map_data)

    assert bool(tc.success) and bool(jc.success)
    np.testing.assert_allclose(float(tc.score), float(jc.score), rtol=1e-5)
    np.testing.assert_allclose(tc.map_T_sensor.numpy(), np.asarray(jc.map_T_sensor), atol=1e-6)

    np.testing.assert_allclose(tout.map_T_sensor.numpy(), jout.map_T_sensor, rtol=0, atol=3e-4)
    np.testing.assert_allclose(tout.map_T_sensor_prior.numpy(), jout.map_T_sensor_prior, rtol=0, atol=3e-4)
    for name in ("icp_iterations", "n_correspondences", "icp_converged", "pair_overflow",
                 "slack_violation", "recropped", "pair_demand"):
        np.testing.assert_array_equal(getattr(tout, name).numpy(), getattr(jout, name), err_msg=name)
    assert not jout.pair_overflow.any() and not jout.slack_violation.any()
    np.testing.assert_allclose(tfin.map_T_sensor.numpy(), jfin.map_T_sensor, atol=3e-4)
    np.testing.assert_allclose(tfin.filter_state.transitions.numpy(), jfin.filter_state.transitions, atol=3e-4)
    assert int(tfin.filter_state.count) == int(jfin.filter_state.count)
    np.testing.assert_array_equal(tfin.cropped_map.points.numpy(), jfin.cropped_map.points)
    # pages are rebased on the odometry-predicted crop centre, an einsum
    # chain that rounds differently in the two packages: ulps apart
    np.testing.assert_allclose(tfin.cached_target.pages.numpy(), jfin.cached_target.pages, atol=1e-5)
    # and it localizes
    err = tout.map_T_sensor.numpy()[:, :3, 3] - seq.true_map_T_sensor[1:, :3, 3]
    assert np.sqrt((err ** 2).sum(1).mean()) < 0.12


def test_port_imports_no_jax():
    """Every module of the port imports without pulling jax in."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import slam_sensor_fusion_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "assert len(mods) > 15, mods\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'slam_sensor_fusion_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_run_chunk_fast_rejects_what_the_port_does_not_run(world):
    """The port runs whole superblocks only (a chunk must be a multiple of
    the superstep); with block_kernel=False the superblock runs frame by
    frame (one K3 call a frame) and reports the same per-frame fields; a
    map that is not presorted is Morton-sorted at each re-crop."""
    import dataclasses

    from slam_sensor_fusion_tpu_torch.models import localization as tl
    from slam_sensor_fusion_tpu_torch.models import pipeline_fast as tpf

    seq, map_data = world
    loc = tl.Localizer(map_data, SLICE_CONFIG, device="cpu")
    gps_T = loc.gps_poses(seq.gps_lat, seq.gps_lon, seq.compass_yaw)
    state = tl.init_state(SLICE_CONFIG, 0, torch.from_numpy(gps_T[0]),
                          torch.from_numpy(seq.odom_T_sensor[0]))
    frames = tpf.build_paged_frames(SLICE_CONFIG, seq.scans[1:6], seq.odom_T_sensor[1:6], gps_T[1:6],
                                    seq.odom_cov_trace[1:6], seq.gps_cov_trace[1:6], np.ones(5, bool),
                                    device="cpu")
    with pytest.raises(ValueError, match="multiple of superstep"):
        tpf.run_chunk_fast(state, frames, loc.map_cloud, SLICE_CONFIG)
    per_frame = dataclasses.replace(SLICE_CONFIG, block_kernel=False, superstep=5)
    final, out = tpf.run_chunk_fast(state, frames, loc.map_cloud, per_frame)
    assert out.map_T_sensor.shape == (5, 4, 4) and torch.isfinite(out.map_T_sensor).all()
    assert (out.n_correspondences > 100).all() and not out.pair_overflow.any()
    assert out.slack_violation is not None and out.pair_demand is not None
    torch.testing.assert_close(final.map_T_sensor, out.map_T_sensor[-1])
    # without a presorted map the crop is Morton-sorted at re-crop: the
    # same points as the presorted crop, in the crop's own Z-order
    from slam_sensor_fusion_tpu_torch.ops import morton

    centre = state.map_T_sensor[:3, 3]
    kept, _ = tl.recrop(loc.map_cloud, centre, SLICE_CONFIG)
    cropped, cache = tl.recrop(loc.map_cloud, centre,
                               dataclasses.replace(SLICE_CONFIG, presorted_map=False))
    assert torch.equal(cropped.mask, kept.mask)
    n = int(kept.mask.sum())

    def rows(x):
        return np.unique(x[:n].numpy(), axis=0)

    np.testing.assert_array_equal(rows(cropped.points), rows(kept.points))
    lo, hi = morton.cloud_box(cropped)
    codes = morton.morton_codes(cropped.points, cropped.mask, lo, hi)
    assert bool((codes[1:] >= codes[:-1]).all())
    assert cache.pages.shape == (SLICE_CONFIG.capacity.cropped_map // SLICE_CONFIG.icp.tile_tgt, 3,
                                 SLICE_CONFIG.icp.tile_tgt)
