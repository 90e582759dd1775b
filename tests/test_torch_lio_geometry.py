"""The LIO stack's primitives in the PyTorch port against the JAX package on
the same NumPy inputs: so3/se3 exp and log EQUAL bit for bit to the JAX
functions jitted, as the LIO path runs them (ops/xla_math: glibc's sinf /
cosf, XLA's arccos, correctly rounded sqrt, XLA's fused multiply-adds;
se3_exp twist by twist, as the registration calls it), deskew EQUAL bit
for bit on 10 m coordinates (turning and not), Morton codes and the device sort (EQUAL integers
and order), the skewed-scan renderer and the IMU synthesizer (bitwise:
NumPy both), and the host twins of deskew / se3_log (1e-5 on 10 m
coordinates, 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_sensor_fusion_tpu.ops import deskew as jd
from slam_sensor_fusion_tpu.ops import geometry as jg
from slam_sensor_fusion_tpu.ops import morton as jm
from slam_sensor_fusion_tpu.ops.cloud import Cloud as JCloud
from slam_sensor_fusion_tpu.utils import synthetic as jsyn
from slam_sensor_fusion_tpu_torch.ops import deskew as td
from slam_sensor_fusion_tpu_torch.ops import geometry as tg
from slam_sensor_fusion_tpu_torch.ops import morton as tm
from slam_sensor_fusion_tpu_torch.ops.cloud import Cloud
from slam_sensor_fusion_tpu_torch.utils import synthetic as tsyn
from torch_parity import t


def _vectors(seed, scale):
    rng = np.random.default_rng(seed)
    v = rng.normal(0, scale, (64, 3)).astype(np.float32)
    v[:4] *= 1e-7  # the small-angle branches
    v[4] = 0.0
    return v


@pytest.mark.parametrize("fn", ["skew", "so3_exp"])
@pytest.mark.parametrize("scale", [0.01, 1.0])
def test_so3_maps_match_jax(fn, scale):
    v = _vectors(0, scale)
    got = getattr(tg, fn)(t(v)).numpy()
    want = np.asarray(jax.jit(getattr(jg, fn))(jnp.asarray(v)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scale", [1e-4, 0.01, 1.0])
def test_so3_log_matches_jax(scale):
    R = np.asarray(jax.jit(jg.so3_exp)(jnp.asarray(_vectors(1, scale))))
    got = tg.so3_log(t(R)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jg.so3_log)(jnp.asarray(R))))


@pytest.mark.parametrize("scale", [1e-4, 0.01, 0.3])
def test_se3_exp_and_log_match_jax(scale):
    rng = np.random.default_rng(2)
    xi = rng.normal(0, scale, (32, 6)).astype(np.float32)
    xi[0, 3:] = 0.0
    exp_j = jax.jit(jg.se3_exp)
    T_j = np.stack([np.asarray(exp_j(jnp.asarray(x))) for x in xi])
    np.testing.assert_array_equal(tg.se3_exp(t(xi)).numpy(), T_j)
    if scale < 1e-3:
        # se3_log's (1 - cos theta) is 0 in float32 for 1e-6 < theta < ~3e-4
        # rad: both packages divide by it (an LIO frame turns ~5e-3 rad)
        return
    got = td.se3_log(t(T_j)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jd.se3_log)(jnp.asarray(T_j))))
    # V^-1's coefficient (1 - theta sin / (2 (1 - cos))) / theta^2 cancels:
    # it inverts exp to 1e-3 at 0.01 rad and to 1e-5 at 0.3 rad
    np.testing.assert_allclose(got, xi, rtol=0, atol=1e-3 if scale < 0.1 else 1e-5)


def _cloud(seed, n=3000, cap=4096, flat=True):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-20, 20, (cap, 3)).astype(np.float32)
    if flat:
        pts[:, 2] *= 0.05
    pts[::7] = pts[3]  # equal codes: the stable order decides
    mask = np.zeros(cap, bool)
    mask[rng.choice(cap, n, replace=False)] = True
    return pts, mask


@pytest.mark.parametrize("isotropic", [False, True])
def test_morton_codes_and_device_sort_equal_jax(isotropic):
    pts, mask = _cloud(3)
    lo_j, hi_j = jm.cloud_box(JCloud(jnp.asarray(pts), jnp.asarray(mask)), isotropic)
    lo_t, hi_t = tm.cloud_box(Cloud(t(pts), t(mask)), isotropic)
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j))
    codes_j = jm.morton_codes(jnp.asarray(pts), jnp.asarray(mask), lo_j, hi_j)
    codes_t = tm.morton_codes(t(pts), t(mask), lo_t, hi_t)
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    assert codes_t.dtype == torch.int32
    s_j = jm.sort_by_morton(JCloud(jnp.asarray(pts), jnp.asarray(mask)), isotropic)
    s_t = tm.sort_by_morton(Cloud(t(pts), t(mask)), isotropic)
    np.testing.assert_array_equal(s_t.points.numpy(), np.asarray(s_j.points))
    np.testing.assert_array_equal(s_t.mask.numpy(), np.asarray(s_j.mask))


def test_empty_cloud_box_matches_jax():
    pts, mask = _cloud(4)
    mask[:] = False
    for iso in (False, True):
        lo_j, hi_j = jm.cloud_box(JCloud(jnp.asarray(pts), jnp.asarray(mask)), iso)
        lo_t, hi_t = tm.cloud_box(Cloud(t(pts), t(mask)), iso)
        np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
        np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j))


@pytest.mark.parametrize("isotropic", [False, True])
def test_host_sort_order_equals_jax_package(isotropic):
    pts, _ = _cloud(5)
    np.testing.assert_array_equal(
        tm.sort_order_numpy(pts, isotropic), jm.sort_order_numpy(pts, isotropic)
    )
    np.testing.assert_array_equal(
        tm.sort_points_numpy(pts, isotropic), jm.sort_points_numpy(pts, isotropic)
    )
    assert tm.sort_order_numpy(np.zeros((0, 3)), isotropic).shape == (0,)


@pytest.mark.parametrize("tau_mode", ["random", "azimuth"])
def test_render_scan_skewed_bitwise(tau_mode):
    world = tsyn.make_world(np.random.default_rng(0), extent=40.0, n_buildings=8, n_poles=10)
    poses = tsyn.make_trajectory(3, speed_per_frame=0.4)
    got = tsyn.render_scan_skewed(world, poses[1], poses[2], np.random.default_rng(7),
                                  max_range=25.0, max_points=1500, tau_mode=tau_mode)
    want = jsyn.render_scan_skewed(world, poses[1], poses[2], np.random.default_rng(7),
                                   max_range=25.0, max_points=1500, tau_mode=tau_mode)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].dtype == np.float32 and len(got[0]) == 1500


def test_make_imu_bitwise():
    poses = tsyn.make_trajectory(6, speed_per_frame=0.2)
    kw = dict(gyro_bias=[0.01, 0.0, -0.02], accel_bias=[0.1, 0.0, 0.0], seed=4)
    for g, w in zip(tsyn.make_imu(poses, **kw), jsyn.make_imu(poses, **kw)):
        np.testing.assert_array_equal(g, w)


XI = np.array([0.3, -0.2, 0.05, 0.04, -0.02, 0.3], np.float32)
XI_STILL = np.array([0.1, 0.05, -0.02, 0.0, 0.0, 0.0], np.float32)


@pytest.mark.parametrize("xi", [XI, XI_STILL], ids=["turning", "no_rotation"])
def test_deskew_matches_jax(xi):
    rng = np.random.default_rng(6)
    pts = rng.uniform(-10, 10, (777, 3)).astype(np.float32)
    tau = rng.uniform(0, 1, 777).astype(np.float32)
    tau[:10] = 1.0  # angle 0: the series branch
    got = td.deskew(t(pts), t(tau), t(xi)).numpy()
    want = np.asarray(jax.jit(jd.deskew)(jnp.asarray(pts), jnp.asarray(tau), jnp.asarray(xi)))
    # bit-equal, the translation term too: k x r0 as the jitted fusion's
    # object code computes it (deskew._kxr_kkr)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_allclose(td.deskew_numpy(pts, tau, xi), jd.deskew_numpy(pts, tau, xi),
                               rtol=0, atol=0)
    np.testing.assert_allclose(td.deskew_numpy(pts, tau, xi), got, rtol=0, atol=1e-5)


def test_se3_log_numpy_twin():
    T = np.asarray(jg.se3_exp(jnp.asarray(XI)))
    np.testing.assert_array_equal(td.se3_log_numpy(T), jd.se3_log_numpy(T))
    np.testing.assert_allclose(td.se3_log_numpy(T), td.se3_log(t(T)).numpy(), rtol=0, atol=1e-6)
