"""The KITTI-format path and auto-sizing of the PyTorch port against the
JAX package: the fixture writer, the loader, the synthesized streams
(`make_sequence_from_scans`, `azimuth_taus`, `synthesize_imu`) and the
three autosize functions. All of it is NumPy in both packages, so files
must be EQUAL byte for byte, arrays and configs equal."""

import dataclasses
import os

import numpy as np
import pytest

from slam_sensor_fusion_tpu.utils import autosize as jauto
from slam_sensor_fusion_tpu.utils import kitti as jkitti
from slam_sensor_fusion_tpu.utils import synthetic as jsyn
from slam_sensor_fusion_tpu_torch.utils import autosize as tauto
from slam_sensor_fusion_tpu_torch.utils import kitti as tkitti
from slam_sensor_fusion_tpu_torch.utils import synthetic as tsyn
from torch_parity import jax_config
from torch_world import SLICE_CONFIG

#: the fixture both packages write: 3 frames of up to 2000 points
FIXTURE = dict(n_frames=3, max_points=2000, extent=60.0, points_per_m2=24.0, seed=5)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """(JAX fixture root, port fixture root), the same arguments."""
    roots = []
    for name, mod in (("jax", jkitti), ("port", tkitti)):
        root = str(tmp_path_factory.mktemp(name))
        mod.make_synthetic_kitti(root, **FIXTURE)
        roots.append(root)
    return roots


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def _fields(x):
    """A config as nested dicts (dataclasses and NamedTuples alike)."""
    if dataclasses.is_dataclass(x):
        x = {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    elif hasattr(x, "_asdict"):
        x = x._asdict()
    if isinstance(x, dict):
        return {k: _fields(v) for k, v in x.items()}
    return x


def test_fixture_bytes_equal_the_jax_package(fixtures):
    want, got = (_files(r) for r in fixtures)
    assert sorted(got) == sorted(want) and len(got) == 3 + 2
    for name in want:
        assert got[name] == want[name], name


def test_loader_round_trip(fixtures):
    """The port's loader on either package's fixture gives the JAX
    loader's scans and poses, equal."""
    want = jkitti.load_sequence(fixtures[0], "00")
    for root in fixtures:
        got = tkitti.load_sequence(root, "00", max_frames=3)
        assert len(got.scans) == 3
        for a, b in zip(got.scans, want.scans):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got.poses, want.poses)
    assert len(tkitti.load_sequence(fixtures[1], "00", max_frames=2).scans) == 2


def test_streams_and_sizes_equal(fixtures):
    """azimuth_taus, synthesize_imu, suggest_scan_capacity and
    make_sequence_from_scans: every array equal."""
    seq = tkitti.load_sequence(fixtures[1], "00")
    for s in seq.scans:
        np.testing.assert_array_equal(tkitti.azimuth_taus(s), jkitti.azimuth_taus(s))
    for a, b in zip(tkitti.synthesize_imu(seq.poses), jkitti.synthesize_imu(seq.poses)):
        np.testing.assert_array_equal(a, b)
    for sub in (1, 2, 3):
        assert (tkitti.suggest_scan_capacity(seq.scans, subsample=sub)
                == jkitti.suggest_scan_capacity(seq.scans, subsample=sub))
    assert tkitti.suggest_scan_capacity([]) == jkitti.suggest_scan_capacity([]) == 1024
    got = tsyn.make_sequence_from_scans(seq.scans, seq.poses, seed=2, gps_noise_m=0.3)
    want = jsyn.make_sequence_from_scans(seq.scans, seq.poses, seed=2, gps_noise_m=0.3)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            assert np.asarray(a).dtype == np.asarray(b).dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize("points", [3000, 40000])
def test_suggest_localization_config_equal(points):
    """Both tile regimes (512/512 below 16384 device points a scan,
    4096/128 above), from a random and a given set of crop centers."""
    rng = np.random.default_rng(points)
    scans = [rng.uniform(-20, 20, (n, 3)).astype(np.float32)
             for n in (points, points * 9 // 10)]
    map_pts = rng.uniform(-30, 30, (60_000, 3)).astype(np.float32)
    base = dataclasses.replace(SLICE_CONFIG, scan_subsample_step=1)
    for centers in (None, rng.uniform(-5, 5, (4, 3))):
        got = tauto.suggest_localization_config(scans, map_pts, base=base, poses_xyz=centers)
        want = jauto.suggest_localization_config(scans, map_pts, base=jax_config(base),
                                                 poses_xyz=centers)
        assert _fields(got) == _fields(want)
    assert (got.icp.tile_src, got.icp.tile_tgt) == ((512, 512) if points < 16384 else (4096, 128))
    assert (tauto.estimate_crop_points(map_pts, 10.0)
            == jauto.estimate_crop_points(map_pts, 10.0))


def test_suggest_voxel_map_config_equal(fixtures):
    seq = tkitti.load_sequence(fixtures[1], "00")
    world = [s @ T[:3, :3].T.astype(np.float32) + T[:3, 3].astype(np.float32)
             for s, T in zip(seq.scans, seq.poses)]
    for group in (1, 2):
        got_cfg, got_origin = tauto.suggest_voxel_map_config(world, 0.2, frames_per_insert=group)
        want_cfg, want_origin = jauto.suggest_voxel_map_config(world, 0.2, frames_per_insert=group)
        assert _fields(got_cfg) == _fields(want_cfg)
        np.testing.assert_array_equal(got_origin, want_origin)
    with pytest.raises(ValueError, match="packable"):
        tauto.suggest_voxel_map_config(world, 0.2, origin=np.full(3, 1e3, np.float32))


def test_suggest_lio_config_equal(fixtures):
    from slam_sensor_fusion_tpu.models.lio import LIOConfig as JLIOConfig
    from slam_sensor_fusion_tpu_torch.models.lio import LIOConfig

    seq = tkitti.load_sequence(fixtures[1], "00")
    for target in (2048, 256):
        got = tauto.suggest_lio_config(seq.scans, target_reg_points=target)
        want = jauto.suggest_lio_config(seq.scans, target_reg_points=target)
        assert _fields(got) == _fields(want)
    got = tauto.suggest_lio_config(seq.scans, base=LIOConfig(window=8))
    want = jauto.suggest_lio_config(seq.scans, base=JLIOConfig(window=8))
    assert _fields(got) == _fields(want)
