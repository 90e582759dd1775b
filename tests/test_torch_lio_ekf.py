"""The error-state EKF of the PyTorch port (models/ekf) against the JAX
package, function by function, on the same NumPy inputs. States agree to
1e-6 absolute on p, v, R, biases; P to 1e-6 relative to its largest entry
(float32 matrix products summed in another order; the 6x6 and 3x3 inverses
by another LU); the GPS gate decision is EQUAL."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_sensor_fusion_tpu.models import ekf as je
from slam_sensor_fusion_tpu_torch.models import ekf as te
from slam_sensor_fusion_tpu_torch.utils.convert import ekf_state_from_numpy
from torch_parity import np_tree, t

CFG_J, CFG_T = je.EKFConfig(init_pos_std=0.3), te.EKFConfig(init_pos_std=0.3)


def _assert_state(got: te.EKFState, want: je.EKFState):
    for name in ("p", "v", "R", "bg", "ba"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-6, err_msg=name)
    P = np.asarray(want.P)
    np.testing.assert_allclose(got.P.numpy(), P, rtol=0, atol=1e-6 * np.abs(P).max(), err_msg="P")


def _packet(seed, K=10):
    rng = np.random.default_rng(seed)
    gyro = rng.normal(0, 0.2, (K, 3)).astype(np.float32)
    accel = (rng.normal(0, 0.5, (K, 3)) + [0, 0, 9.8]).astype(np.float32)
    return gyro, accel, np.full(K, 0.01, np.float32)


def _moved_state(seed=0):
    """A state after one packet, so R, v and the off-diagonal P are busy."""
    rng = np.random.default_rng(seed)
    p0, v0 = rng.normal(0, 5, 3).astype(np.float32), rng.normal(0, 1, 3).astype(np.float32)
    s_j = je.init_state(CFG_J, p0=jnp.asarray(p0), v0=jnp.asarray(v0))
    g, a, d = _packet(seed + 10)
    s_j = je.propagate_batch(s_j, jnp.asarray(g), jnp.asarray(a), jnp.asarray(d), CFG_J)
    return s_j, ekf_state_from_numpy(np_tree(s_j), "cpu")


def test_init_state_matches_jax():
    rng = np.random.default_rng(1)
    p0, v0 = rng.normal(0, 5, 3).astype(np.float32), rng.normal(0, 1, 3).astype(np.float32)
    R0 = np.asarray(je.geometry.so3_exp(jnp.asarray([0.1, -0.2, 0.3], jnp.float32)))
    _assert_state(te.init_state(CFG_T, t(p0), t(R0), t(v0), device="cpu"),
                  je.init_state(CFG_J, jnp.asarray(p0), jnp.asarray(R0), jnp.asarray(v0)))
    _assert_state(te.init_state(CFG_T, device="cpu"), je.init_state(CFG_J))


def test_propagate_matches_jax():
    s_j, s_t = _moved_state()
    g, a, d = _packet(2)
    _assert_state(te.propagate(s_t, t(g[0]), t(a[0]), t(d[0]), CFG_T),
                  je.propagate(s_j, jnp.asarray(g[0]), jnp.asarray(a[0]), jnp.asarray(d[0]), CFG_J))


def test_propagate_batch_skips_padding():
    """A 10-sample packet with two dt == 0 padding samples (no-ops)."""
    s_j, s_t = _moved_state(3)
    g, a, d = _packet(4)
    d[[3, 9]] = 0.0
    got = te.propagate_batch(s_t, t(g), t(a), t(d), CFG_T)
    _assert_state(got, je.propagate_batch(s_j, jnp.asarray(g), jnp.asarray(a), jnp.asarray(d), CFG_J))
    keep = d > 0
    dense = te.propagate_batch(s_t, t(g[keep]), t(a[keep]), t(d[keep]), CFG_T)
    for x, y in zip(got, dense):
        assert torch.equal(x, y)


def _measurement(s_j, seed):
    rng = np.random.default_rng(seed)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.asarray(s_j.R @ je.geometry.so3_exp(jnp.asarray(rng.normal(0, 0.02, 3), jnp.float32)))
    T[:3, 3] = np.asarray(s_j.p) + rng.normal(0, 0.05, 3)
    return T


def test_update_pose_matches_jax():
    s_j, s_t = _moved_state(5)
    T = _measurement(s_j, 6)
    _assert_state(te.update_pose(s_t, t(T), 0.03, 0.01),
                  je.update_pose(s_j, jnp.asarray(T), 0.03, 0.01))
    _assert_state(te.update_pose(s_t, t(T), torch.tensor(0.3), torch.tensor(0.02)),
                  je.update_pose(s_j, jnp.asarray(T), jnp.float32(0.3), jnp.float32(0.02)))


def test_update_pose_cov_matches_jax():
    s_j, s_t = _moved_state(7)
    T = _measurement(s_j, 8)
    A = np.random.default_rng(9).normal(0, 0.02, (6, 6)).astype(np.float32)
    Rm = A @ A.T + 1e-4 * np.eye(6, dtype=np.float32)
    _assert_state(te.update_pose_cov(s_t, t(T), t(Rm)),
                  je.update_pose_cov(s_j, jnp.asarray(T), jnp.asarray(Rm)))


@pytest.mark.parametrize("offset, accepted", [(0.2, True), (30.0, False)])
@pytest.mark.parametrize("full_cov", [False, True])
def test_update_gps_gate_matches_jax(offset, accepted, full_cov):
    s_j, s_t = _moved_state(10)
    meas = (np.asarray(s_j.p) + [offset, 0.0, 0.0]).astype(np.float32)
    cov = np.diag([0.25, 0.3, 0.5]).astype(np.float32) if full_cov else np.float32(0.25)
    want, acc_j = je.update_gps(s_j, jnp.asarray(meas), jnp.asarray(cov), CFG_J)
    got, acc_t = te.update_gps(s_t, t(meas), t(cov), CFG_T)
    assert bool(acc_t) == bool(acc_j) == accepted
    _assert_state(got, want)
    if not accepted:
        for x, y in zip(got, s_t):
            assert torch.equal(x, y)


@pytest.mark.parametrize("gps_valid", [True, False])
def test_lio_fusion_step_matches_jax(gps_valid):
    s_j, s_t = _moved_state(11)
    g, a, d = _packet(12)
    T = _measurement(s_j, 13)
    meas = (np.asarray(s_j.p) + [0.3, -0.2, 0.1]).astype(np.float32)
    want, acc_j = je.lio_fusion_step(
        s_j, jnp.asarray(g), jnp.asarray(a), jnp.asarray(d), jnp.asarray(T), jnp.float32(0.05),
        jnp.float32(0.01), jnp.asarray(meas), jnp.float32(0.25), jnp.bool_(gps_valid), CFG_J)
    got, acc_t = te.lio_fusion_step(
        s_t, t(g), t(a), t(d), t(T), 0.05, 0.01, t(meas), torch.tensor(0.25),
        torch.tensor(gps_valid), CFG_T)
    assert bool(acc_t) == bool(acc_j) == gps_valid
    _assert_state(got, want)
    np.testing.assert_allclose(te.pose_matrix(got).numpy(), np.asarray(je.pose_matrix(want)),
                               rtol=0, atol=1e-6)
