"""Three config paths of the PyTorch port against the JAX package:

* `icp_align` dispatches as the JAX function does (ops/icp.py:481-525):
  capacities that are not multiples of the tiles (1000 / 2000 points at the
  default 256 / 512 tiles, which the port once refused) and `gated=False`
  take the dense sweep,
  `nn_backend="xla"` the gated XLA search (ops/nn_gated.gated_nn), and a
  visit list cut by `max_visits` reports its overflow. EQUAL iterations,
  correspondence counts and overflow flags, T to 1e-5.
* `presorted_map=False`: each crop is Morton-sorted at re-crop.
  `run_chunk` (2 frames, the parity ICP on K2's plain version, the JAX side
  in interpret mode) and `run_chunk_fast` (one superblock of 4 frames on
  K1's plain version) agree with the JAX package under tests/test_torch_slice.py's
  tolerances: poses 3e-4, counts and flags EQUAL, the sorted crop EQUAL.
* K1 takes any filter-queue size: its plain version at a 12-pose queue,
  entered two poses short of full, against the JAX kernel in interpret
  mode (3e-4 on poses and state, counts EQUAL, tests/test_torch_superblock.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_sensor_fusion_tpu.models import localization as jl
from slam_sensor_fusion_tpu.models import pipeline_fast as jpf
from slam_sensor_fusion_tpu.ops.icp import icp_align as j_icp_align
from slam_sensor_fusion_tpu.ops.superblock_fused import superblock_fine as j_superblock_fine
from slam_sensor_fusion_tpu.utils.config import ICPConfig as JICPConfig
from slam_sensor_fusion_tpu_torch.models import localization as tl
from slam_sensor_fusion_tpu_torch.models import pipeline_fast as tpf
from slam_sensor_fusion_tpu_torch.ops import icp as ticp
from slam_sensor_fusion_tpu_torch.ops import morton
from slam_sensor_fusion_tpu_torch.ops.superblock_fused import superblock_fine
from slam_sensor_fusion_tpu_torch.utils.config import ICPConfig
from torch_parity import jax_config, np_tree, t
from torch_world import SLICE_CONFIG, build_world, compare_superblock, k3_scene, superblock_args


#: (source capacity, target capacity, ICPConfig fields) of each dispatch case
CASES = {
    "dense-capacities": (1000, 2000, {}),
    "dense-ungated": (1024, 4096, {"gated": False}),
    "gated-xla": (1024, 4096, {"nn_backend": "xla"}),
    "gated-xla-overflow": (1024, 4096, {"nn_backend": "xla", "max_visits": 1}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_icp_align_dispatches_as_jax(case):
    M, N, fields = CASES[case]
    src, smask, tgt, tmask, T0 = k3_scene(5, n_src=min(M, 1000), M=M, N=N)
    want = j_icp_align(*map(jnp.asarray, (src, smask, tgt, tmask, T0)), JICPConfig(**fields))
    got = ticp.icp_align(t(src), t(smask), t(tgt), t(tmask), t(T0), ICPConfig(**fields))
    for name in ("iterations", "n_correspondences", "pair_overflow", "has_converged"):
        assert int(getattr(got, name)) == int(getattr(want, name)), name
    np.testing.assert_allclose(got.transformation.numpy(), np.asarray(want.transformation),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(got.error), float(want.error), rtol=1e-5)
    # ICP stepped, and every source point matched unless the visit lists
    # were cut: the case is not vacuous
    overflow = case == "gated-xla-overflow"
    assert int(got.iterations) >= 1 and bool(got.pair_overflow) == overflow
    assert (int(got.n_correspondences) < 1000) if overflow else (int(got.n_correspondences) == 1000)


def test_gated_nn_matches_jax():
    """The gated XLA search alone: d2 EQUAL inside the gate (the port
    evaluates the norms as XLA's fusion does), the same winners and the
    same overflow flag."""
    from slam_sensor_fusion_tpu.ops.nn_gated import gated_nn as j_gated_nn
    from slam_sensor_fusion_tpu_torch.ops.nn_gated import gated_nn

    src, smask, tgt, tmask, _ = k3_scene(6, n_src=1000, M=1024, N=4096)
    center = np.asarray([0.3, -0.2, 0.1], np.float32)
    want = j_gated_nn(*map(jnp.asarray, (src, smask, tgt, tmask, center)), 0.5, 256, 512, 8)
    got = gated_nn(t(src), t(smask), t(tgt), t(tmask), t(center), 0.5, 256, 512, 8)
    inside = smask & (np.asarray(want.d2) < 0.5)
    assert inside.sum() > 900
    np.testing.assert_array_equal(got.idx.numpy()[inside], np.asarray(want.idx)[inside])
    np.testing.assert_array_equal(got.d2.numpy()[inside], np.asarray(want.d2)[inside])
    assert bool(got.visit_overflow) == bool(want.visit_overflow)


#: the per-frame parity engine (the JAX side's Pallas kernel in interpret
#: mode) and the superblock engine, on a map that is not presorted
UNSORTED = {
    "run_chunk": dataclasses.replace(
        SLICE_CONFIG, presorted_map=False, superblock_parity=False, block_kernel=False,
        icp=dataclasses.replace(SLICE_CONFIG.icp, pallas_interpret=True),
    ),
    "run_chunk_fast": dataclasses.replace(SLICE_CONFIG, presorted_map=False, superstep=4),
}


@pytest.fixture(scope="module")
def unsorted_world():
    """tests/test_torch_slice.py's world. (Seed 6 agrees too: frames 1-2
    to 6e-7 m with equal counts in both engines; the first quantity that
    parts is the first Kabsch step's rotation, by 3.6e-7 (ROADMAP §3).)"""
    seq, map_data = build_world(n_frames=9, seed=3)
    cfg = dataclasses.replace(SLICE_CONFIG, presorted_map=False)
    jcfg = jax_config(cfg)
    jloc = jl.Localizer(map_data, jcfg)
    gps_T = jloc.gps_poses(seq.gps_lat, seq.gps_lon, seq.compass_yaw)
    tloc = tl.Localizer(map_data, cfg, device="cpu")
    np.testing.assert_array_equal(tloc.map_cloud.points.numpy(), np.asarray(jloc.map_cloud.points))
    # both start at frame 0's true pose with an empty crop: the first frame
    # re-crops, sorting the crop, and ICP starts near convergence
    T0 = np.asarray(seq.true_map_T_sensor[0], np.float32)
    odom0 = np.asarray(seq.odom_T_sensor[0], np.float32)
    jstate = jl.init_state(jcfg, jloc.map_cloud.capacity, jnp.asarray(T0), jnp.asarray(odom0))
    tstate = tl.init_state(cfg, 0, t(T0), t(odom0))
    return seq, gps_T, (jloc, jstate), (tloc, tstate)


@pytest.mark.parametrize("engine", list(UNSORTED))
def test_unsorted_map_localizes_as_jax(unsorted_world, engine):
    seq, gps_T, (jloc, jstate), (tloc, tstate) = unsorted_world
    cfg = UNSORTED[engine]
    jcfg = jax_config(cfg)
    n = 2 if engine == "run_chunk" else 4
    sl = slice(1, 1 + n)
    ones = np.ones(n, bool)
    args = (seq.scans[sl], seq.odom_T_sensor[sl], gps_T[sl], seq.odom_cov_trace[sl],
            seq.gps_cov_trace[sl], ones)
    if engine == "run_chunk":
        jfin, jout = jl.run_chunk(jstate, jl.build_frame_batch(jcfg, *args), jloc.map_cloud, jcfg)
        tfin, tout = tl.run_chunk(tstate, tl.build_frame_batch(cfg, *args, device="cpu"),
                                  tloc.map_cloud, cfg)
        names = ("icp_iterations", "n_correspondences", "icp_converged", "pair_overflow",
                 "recropped")
    else:
        jfin, jout = jpf.run_chunk_fast(jstate, jpf.build_paged_frames(jcfg, *args),
                                        jloc.map_cloud, jcfg, interpret=True)
        tfin, tout = tpf.run_chunk_fast(tstate, tpf.build_paged_frames(cfg, *args, device="cpu"),
                                        tloc.map_cloud, cfg)
        names = ("icp_iterations", "n_correspondences", "icp_converged", "pair_overflow",
                 "slack_violation", "recropped")
    jfin, jout = np_tree(jfin), np_tree(jout)
    np.testing.assert_allclose(tout.map_T_sensor.numpy(), jout.map_T_sensor, rtol=0, atol=3e-4)
    for name in names:
        np.testing.assert_array_equal(getattr(tout, name).numpy(), getattr(jout, name),
                                      err_msg=name)
    assert (tout.n_correspondences > 100).all()
    # the crop the frames ran against was sorted at re-crop, as JAX's
    np.testing.assert_array_equal(tfin.cropped_map.points.numpy(), jfin.cropped_map.points)
    lo, hi = morton.cloud_box(tfin.cropped_map)
    codes = morton.morton_codes(tfin.cropped_map.points, tfin.cropped_map.mask, lo, hi)
    assert bool((codes[1:] >= codes[:-1]).all())
    np.testing.assert_array_equal(tfin.cropped_map.mask.numpy(), jfin.cropped_map.mask)
    err = tout.map_T_sensor.numpy()[:, :3, 3] - seq.true_map_T_sensor[sl, :3, 3]
    assert np.sqrt((err ** 2).sum(1).mean()) < 0.12


def test_superblock_plain_takes_a_12_pose_queue_as_jax():
    cfg, args = superblock_args("parity", queue_size=12)
    got = superblock_fine(*args, cfg)  # CPU tensors -> the plain version
    want = j_superblock_fine(
        *[jnp.asarray(x.numpy()) for x in args], jax_config(cfg), interpret=True
    )
    compare_superblock([np.asarray(x) for x in want], [x.numpy() for x in got], args[4].numpy())
    assert got[6].shape == (12, 4, 4) and int(got[7]) == int(want[7]) == 12
    # the full queue's gate saw every frame after the second valid one
    assert torch.isfinite(got[0]).all()
