"""Host side of the PyTorch port against the JAX package: the synthetic
world, the map build, the map load, the GPS pose stream, frame paging, and
the conversion of configs and state. All of it is NumPy in both packages,
so integers and arrays must be EQUAL (GPS poses to 1e-6)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_sensor_fusion_tpu.models import localization as jl
from slam_sensor_fusion_tpu.models import pipeline_fast as jpf
from slam_sensor_fusion_tpu.models.mapping import build_map_data as j_build_map_data
from slam_sensor_fusion_tpu.utils import synthetic as jsyn
from slam_sensor_fusion_tpu_torch.models import localization as tl
from slam_sensor_fusion_tpu_torch.models import pipeline_fast as tpf
from slam_sensor_fusion_tpu_torch.models.mapping import build_map_data as t_build_map_data
from slam_sensor_fusion_tpu_torch.utils import convert
from slam_sensor_fusion_tpu_torch.utils import synthetic as tsyn
from torch_parity import jax_config, np_tree, port_config
from torch_world import SLICE_CONFIG, build_world

JCFG = jax_config(SLICE_CONFIG)


@pytest.fixture(scope="module")
def world():
    return build_world(n_frames=9, seed=3)


def test_synthetic_sequence_equal():
    a = jsyn.make_sequence(seed=1, n_frames=4, scan_points=500,
                           world=jsyn.make_world(np.random.default_rng(1), extent=30.0, n_buildings=4, n_poles=5))
    b = tsyn.make_sequence(seed=1, n_frames=4, scan_points=500,
                           world=tsyn.make_world(np.random.default_rng(1), extent=30.0, n_buildings=4, n_poles=5))
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, list):
            assert all(np.array_equal(u, v) for u, v in zip(x, y))
        else:
            np.testing.assert_array_equal(x, y)


def test_build_map_data_bitwise(world):
    seq, _ = world
    rng = np.random.default_rng(4)
    tiles = [rng.uniform(-20, 20, (2000, 3)).astype(np.float32) for _ in range(3)]
    odom_pos, gps_rows = jsyn.make_mapping_logs(seq, standstill_frames=5)
    a = j_build_map_data(tiles, odom_pos, gps_rows)
    b = t_build_map_data(tiles, odom_pos, gps_rows)
    for name in ("map_points", "map_T_global", "altitude_table"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_localizer_map_and_gps_poses(world):
    seq, map_data = world
    cfg = JCFG
    jloc = jl.Localizer(map_data, cfg)
    tloc = tl.Localizer(map_data, SLICE_CONFIG, device="cpu")
    np.testing.assert_array_equal(np.asarray(jloc.map_cloud.points), tloc.map_cloud.points.numpy())
    np.testing.assert_array_equal(np.asarray(jloc.map_cloud.mask), tloc.map_cloud.mask.numpy())
    a = jloc.gps_poses(seq.gps_lat, seq.gps_lon, seq.compass_yaw)
    b = tloc.gps_poses(seq.gps_lat, seq.gps_lon, seq.compass_yaw)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


def test_build_paged_frames_equal(world):
    seq, map_data = world
    cfg = JCFG
    gps_T = jl.Localizer(map_data, cfg).gps_poses(seq.gps_lat, seq.gps_lon, seq.compass_yaw)
    valid = np.ones(8, bool)
    valid[2] = False
    args = (seq.scans[1:], seq.odom_T_sensor[1:], gps_T[1:], seq.odom_cov_trace[1:],
            seq.gps_cov_trace[1:], valid)
    a = np_tree(jpf.build_paged_frames(cfg, *args))
    b = tpf.build_paged_frames(SLICE_CONFIG, *args, device="cpu")
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name).numpy()
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    # the JAX-side frames convert to the same tensors
    c = convert.paged_frames_from_numpy(a, device="cpu")
    for name in a._fields:
        assert torch.equal(getattr(c, name), getattr(b, name)), name


def test_build_frame_batch_equal(world):
    seq, map_data = world
    cfg = JCFG
    gps_T = jl.Localizer(map_data, cfg).gps_poses(seq.gps_lat, seq.gps_lon, seq.compass_yaw)
    args = (seq.scans[1:3], seq.odom_T_sensor[1:3], gps_T[1:3], seq.odom_cov_trace[1:3],
            seq.gps_cov_trace[1:3], np.ones(2, bool))
    a = np_tree(jl.build_frame_batch(cfg, *args))
    b = tl.build_frame_batch(SLICE_CONFIG, *args, device="cpu")
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name).numpy()
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def test_config_from_fields_round_trip():
    cfg = dataclasses.replace(
        JCFG, fixed_gains=True,
        icp=dataclasses.replace(JCFG.icp, gate_sub_src=64, mode="fast"),
    )
    port = port_config(cfg)
    assert dataclasses.asdict(port) == dataclasses.asdict(cfg)
    assert jax_config(port) == cfg
    with pytest.raises(ValueError):
        convert.config_from_fields({"not_a_field": 1})


def test_state_from_numpy_equal(world):
    seq, map_data = world
    cfg = JCFG
    jloc = jl.Localizer(map_data, cfg)
    gps_T = jloc.gps_poses(seq.gps_lat, seq.gps_lon, seq.compass_yaw)
    js = jl.init_state(cfg, jloc.map_cloud.capacity, jnp.asarray(gps_T[0]),
                       jnp.asarray(seq.odom_T_sensor[0], jnp.float32))
    ts = tl.init_state(SLICE_CONFIG, 0, torch.from_numpy(gps_T[0]),
                       torch.from_numpy(seq.odom_T_sensor[0]))
    conv = convert.state_from_numpy(np_tree(js), device="cpu")
    leaves = torch.utils._pytree.tree_leaves
    for x, y in zip(leaves(conv), leaves(ts), strict=True):
        if x is None:
            assert y is None
            continue
        assert x.dtype == y.dtype
        assert torch.equal(x, y)
    md = convert.map_data_from_numpy(map_data.map_points, map_data.map_T_global, map_data.altitude_table)
    np.testing.assert_array_equal(md.map_points, map_data.map_points)
