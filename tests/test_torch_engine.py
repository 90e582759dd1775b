"""The per-frame engine of the PyTorch port against the JAX package:
`run_chunk` (a loop of `step`) in parity mode (the K2 ICP, the JAX side
running its Pallas kernel in interpret mode) and in fast mode (K3), and
`Localizer.run` in both steady-state branches (per frame; superblocks run
frame by frame on K3), with an invalid-GPS frame and a start that waits for
valid GPS. Also, within the port: the per-frame branch of `run_chunk_fast`
(K3 lazy) against K1 on the same superblock.

Poses agree to 3e-4 and the ICP error to 1e-3; iterations, correspondence
counts, converged/overflow/re-crop flags and the valid masks are EQUAL."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_sensor_fusion_tpu.models import localization as jl
from slam_sensor_fusion_tpu_torch.models import localization as tl
from slam_sensor_fusion_tpu_torch.models import pipeline_fast as tpf
from slam_sensor_fusion_tpu_torch.utils import convert
from torch_parity import jax_config, np_tree
from torch_world import SLICE_CONFIG, build_world

#: the default per-frame engine (no superblocks) at test size; the JAX side
#: runs the Pallas NN kernel (interpret mode) as on its TPU path
PARITY = dataclasses.replace(
    SLICE_CONFIG, superblock_parity=False, block_kernel=False,
    icp=dataclasses.replace(SLICE_CONFIG.icp, pallas_interpret=True),
)
#: fast mode without the superblock kernel (bench.py bench_latency's engine)
FAST = dataclasses.replace(
    SLICE_CONFIG, superblock_parity=False, block_kernel=False, superstep=4,
    icp=dataclasses.replace(SLICE_CONFIG.icp, mode="fast"),
)
CONFIGS = {"parity": PARITY, "fast": FAST}

_SCALARS = ("icp_iterations", "n_correspondences", "icp_converged", "pair_overflow", "recropped")


@pytest.fixture(scope="module")
def world():
    seq, map_data = build_world(n_frames=12, seed=4)
    seq.gps_alt[:2] = -1.0  # the start waits for valid GPS
    seq.gps_alt[7] = -1.0  # an invalid frame in the steady state
    return seq, map_data


def _jax_start(cfg, seq, map_data):
    """JAX: init at the first valid fix (frame 2), coarse alignment on
    frame 3; returns (Localizer, gps poses, state after coarse)."""
    loc = jl.Localizer(map_data, cfg)
    gps_T = loc.gps_poses(seq.gps_lat, seq.gps_lon, seq.compass_yaw)
    state = jl.init_state(cfg, loc.map_cloud.capacity, jnp.asarray(gps_T[2]),
                          jnp.asarray(seq.odom_T_sensor[2], jnp.float32))
    fb = jl.build_frame_batch(cfg, [seq.scans[3]], seq.odom_T_sensor[3:4], gps_T[3:4],
                              seq.odom_cov_trace[3:4], seq.gps_cov_trace[3:4], np.ones(1, bool))
    cm, ct, ref, _, coarse = jl.coarse_attempt(
        state, fb.scan_points[0], fb.scan_mask[0], loc.map_cloud, jnp.asarray(gps_T[2]), cfg
    )
    assert bool(coarse.success)
    return loc, gps_T, state._replace(map_T_sensor=coarse.map_T_sensor, cropped_map=cm,
                                      cached_target=ct, map_T_ref=ref)


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_run_chunk_matches_jax(world, mode):
    """Frames 4..11 from the same post-coarse state (handed over through
    utils/convert), frame 7 invalid."""
    seq, map_data = world
    cfg = CONFIGS[mode]
    jcfg = jax_config(cfg)
    jloc, gps_T, jstate = _jax_start(jcfg, seq, map_data)
    sl = slice(4, 12)
    args = (seq.scans[sl], seq.odom_T_sensor[sl], gps_T[sl], seq.odom_cov_trace[sl],
            seq.gps_cov_trace[sl], seq.gps_alt[sl] >= 0)
    jfin, jout = jl.run_chunk(jstate, jl.build_frame_batch(jcfg, *args), jloc.map_cloud, jcfg)
    jfin, jout = np_tree(jfin), np_tree(jout)

    tloc = tl.Localizer(map_data, cfg, device="cpu")
    tstate = convert.state_from_numpy(np_tree(jstate), device="cpu")
    tfin, tout = tl.run_chunk(tstate, tl.build_frame_batch(cfg, *args, device="cpu"),
                              tloc.map_cloud, cfg)

    for name in ("map_T_sensor", "map_T_sensor_prior", "map_T_sensor_odom"):
        np.testing.assert_allclose(getattr(tout, name).numpy(), getattr(jout, name),
                                   rtol=0, atol=3e-4, err_msg=name)
    np.testing.assert_allclose(tout.icp_error.numpy(), jout.icp_error, rtol=0, atol=1e-3)
    for name in _SCALARS:
        np.testing.assert_array_equal(getattr(tout, name).numpy(), getattr(jout, name), err_msg=name)
    np.testing.assert_allclose(tout.icp_det_min.numpy(), jout.icp_det_min, rtol=1e-3)
    assert tout.slack_violation is None and jout.slack_violation is None
    np.testing.assert_allclose(tfin.map_T_sensor.numpy(), jfin.map_T_sensor, atol=3e-4)
    np.testing.assert_allclose(tfin.filter_state.transitions.numpy(), jfin.filter_state.transitions,
                               atol=3e-4)
    assert int(tfin.filter_state.count) == int(jfin.filter_state.count)
    np.testing.assert_array_equal(tfin.cropped_map.mask.numpy(), jfin.cropped_map.mask)
    # the invalid frame is a no-op: zero outputs, the posterior carried
    assert int(tout.n_correspondences[3]) == 0
    np.testing.assert_array_equal(tout.map_T_sensor[3].numpy(), tout.map_T_sensor[2].numpy())
    assert (tout.n_correspondences.numpy()[[0, 1, 2, 4, 5, 6, 7]] > 100).all()
    assert tout.icp_iterations.max() >= 1


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_localizer_run_matches_jax(world, mode):
    """The replay entry point: GPS-gated start (frame 2 initializes), the
    coarse ladder on frame 3, then chunks of 5 (not a multiple of the
    superstep): `run_chunk` in parity mode, `run_chunk_fast`'s per-frame
    branch (K3 fresh) in fast mode."""
    seq, map_data = world
    cfg = CONFIGS[mode]
    run_args = (seq.scans, seq.odom_T_sensor, seq.gps_lat, seq.gps_lon, seq.gps_alt,
                seq.compass_yaw, seq.odom_cov_trace, seq.gps_cov_trace)
    want = jl.Localizer(map_data, jax_config(cfg)).run(*run_args, chunk=5)
    got = tl.Localizer(map_data, cfg, device="cpu").run(*run_args, chunk=5)

    assert got.first_processed_frame == want.first_processed_frame == 2
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    np.testing.assert_array_equal(got.valid, want.valid)
    assert not got.valid[:3].any() and not got.valid[7] and got.valid[3:7].all()
    np.testing.assert_allclose(got.map_T_sensor, want.map_T_sensor, rtol=0, atol=3e-4)
    np.testing.assert_allclose(got.icp_error, want.icp_error, rtol=0, atol=1e-3)
    for name in ("icp_iterations", "icp_converged", "n_correspondences"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    # pose held across the invalid frame, and it localizes
    np.testing.assert_array_equal(got.map_T_sensor[7], got.map_T_sensor[6])
    err = got.map_T_sensor[got.valid, :3, 3] - seq.true_map_T_sensor[got.valid, :3, 3]
    assert np.sqrt((err ** 2).sum(1).mean()) < 0.15


def test_per_frame_superblock_matches_k1(world):
    """One superblock frame by frame on K3 (lazy ICP) against the same
    superblock in K1 (the port's plain versions of both), as the JAX
    package's tests/test_superblock_kernel.py holds its kernel against its
    per-frame scan."""
    seq, map_data = world
    base = dataclasses.replace(SLICE_CONFIG, superstep=4)
    loc = tl.Localizer(map_data, base, device="cpu")
    gps_T = loc.gps_poses(seq.gps_lat, seq.gps_lon, seq.compass_yaw)
    state = tl.init_state(base, 0, torch.from_numpy(gps_T[2]).float(),
                          torch.from_numpy(seq.odom_T_sensor[2]).float())
    valid = np.ones(4, bool)
    valid[2] = False
    frames = tpf.build_paged_frames(base, seq.scans[3:7], seq.odom_T_sensor[3:7], gps_T[3:7],
                                    seq.odom_cov_trace[3:7], seq.gps_cov_trace[3:7], valid,
                                    device="cpu")
    fin_k, out_k = tpf.run_chunk_fast(state, frames, loc.map_cloud, base)
    fin_f, out_f = tpf.run_chunk_fast(state, frames, loc.map_cloud,
                                      dataclasses.replace(base, block_kernel=False))
    for name in ("map_T_sensor", "map_T_sensor_prior", "map_T_sensor_odom"):
        torch.testing.assert_close(getattr(out_f, name), getattr(out_k, name), rtol=0, atol=3e-4)
    torch.testing.assert_close(out_f.icp_error, out_k.icp_error, rtol=0, atol=1e-3)
    for name in _SCALARS + ("slack_violation", "pair_demand"):
        assert torch.equal(getattr(out_f, name), getattr(out_k, name)), name
    torch.testing.assert_close(fin_f.map_T_sensor, fin_k.map_T_sensor, rtol=0, atol=3e-4)
    torch.testing.assert_close(fin_f.filter_state.transitions, fin_k.filter_state.transitions,
                               rtol=0, atol=3e-4)
    assert int(fin_f.filter_state.count) == int(fin_k.filter_state.count)
    assert out_k.icp_iterations.max() >= 2
