"""Error-state EKF for LiDAR-inertial-GPS fusion, native mode (port of the
JAX `models/ekf.py`).

A 15-state error-state EKF

    x = [p (3), v (3), theta (3), b_gyro (3), b_accel (3)]

with IMU strapdown propagation, SE(3) pose updates from scan registration,
and GPS position updates with chi-squared outlier gating. Plain functions
on tensors; every data-dependent choice (padding samples, the GPS gate) is
a `torch.where` select on device values, so a frame never waits for the
device.

Conventions: world-frame ENU position/velocity; R is body->world; the
accelerometer measures specific force f = R^T (a_w - g_w), g_w = (0,0,-g).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from slam_sensor_fusion_tpu_torch.ops import geometry, lapack_cpu
from slam_sensor_fusion_tpu_torch.ops import xla_math as xm

GRAVITY = 9.80665


class EKFConfig(NamedTuple):
    """Continuous-time noise densities and priors (static)."""

    gyro_noise: float = 1.7e-3  # rad/s/sqrt(Hz)
    accel_noise: float = 2.0e-2  # m/s^2/sqrt(Hz)
    gyro_bias_walk: float = 1.0e-5  # rad/s^2/sqrt(Hz)
    accel_bias_walk: float = 1.0e-4  # m/s^3/sqrt(Hz)
    init_pos_std: float = 1.0
    init_vel_std: float = 0.5
    init_att_std: float = 0.1
    init_gyro_bias_std: float = 0.02
    init_accel_bias_std: float = 0.2
    #: chi^2 gate for the 3-dof GPS position update (99% quantile ~ 11.34)
    gps_chi2_gate: float = 11.34


class EKFState(NamedTuple):
    p: torch.Tensor  # (3,) position, world
    v: torch.Tensor  # (3,) velocity, world
    R: torch.Tensor  # (3, 3) body->world
    bg: torch.Tensor  # (3,) gyro bias
    ba: torch.Tensor  # (3,) accel bias
    P: torch.Tensor  # (15, 15) error covariance


def _select(cond: torch.Tensor, a: EKFState, b: EKFState) -> EKFState:
    """Field-wise `where(cond, a, b)` for a scalar device condition."""
    return EKFState(*[torch.where(cond, x, y) for x, y in zip(a, b)])


def _blocks3(*values: float, device) -> torch.Tensor:
    """[v0, v0, v0, v1, v1, v1, ...] as a float32 vector."""
    return torch.tensor(values, dtype=torch.float32, device=device).repeat_interleave(3)


class _Constants(NamedTuple):
    g_w: torch.Tensor  # (3,) gravity, world
    eye3: torch.Tensor
    eye15: torch.Tensor
    q_rate: torch.Tensor  # (15,) process noise per second
    H_pose: torch.Tensor  # (6, 15) selects (p, theta)
    H_gps: torch.Tensor  # (3, 15) selects p
    imu: torch.Tensor  # (18,) g_w, q_rate: csrc/xla_math.cu's IMU constants


@functools.lru_cache(maxsize=None)
def _constants(config: EKFConfig, device: torch.device) -> _Constants:
    """The filter's constant tensors, uploaded once per (config, device): a
    tensor made from Python numbers inside a frame would wait for the
    device (its host-to-device copy is ordered after the queued kernels)."""
    f32 = {"dtype": torch.float32, "device": device}
    eye3 = torch.eye(3, **f32)
    H_pose = torch.zeros((6, 15), **f32)
    H_pose[0:3, 0:3] = eye3
    H_pose[3:6, 6:9] = eye3
    g_w = torch.tensor([0.0, 0.0, -GRAVITY], **f32)
    q_rate = _blocks3(
        0.0,
        config.accel_noise**2,
        config.gyro_noise**2,
        config.gyro_bias_walk**2,
        config.accel_bias_walk**2,
        device=device,
    )
    return _Constants(
        g_w=g_w,
        eye3=eye3,
        eye15=torch.eye(15, **f32),
        q_rate=q_rate,
        H_pose=H_pose,
        H_gps=H_pose[0:3].clone(),
        imu=torch.cat([g_w, q_rate]),
    )


def init_state(
    config: EKFConfig,
    p0: torch.Tensor | None = None,
    R0: torch.Tensor | None = None,
    v0: torch.Tensor | None = None,
    device: torch.device | str = torch.device("cuda"),
) -> EKFState:
    f32 = {"dtype": torch.float32, "device": device}
    p0 = torch.zeros(3, **f32) if p0 is None else p0.to(**f32)
    R0 = torch.eye(3, **f32) if R0 is None else R0.to(**f32)
    v0 = torch.zeros(3, **f32) if v0 is None else v0.to(**f32)
    P = torch.diag(
        _blocks3(
            config.init_pos_std**2,
            config.init_vel_std**2,
            config.init_att_std**2,
            config.init_gyro_bias_std**2,
            config.init_accel_bias_std**2,
            device=device,
        )
    )
    return EKFState(
        p=p0, v=v0, R=R0, bg=torch.zeros(3, **f32), ba=torch.zeros(3, **f32), P=P
    )


def propagate(
    state: EKFState,
    gyro: torch.Tensor,
    accel: torch.Tensor,
    dt: torch.Tensor,
    config: EKFConfig,
) -> EKFState:
    """One IMU strapdown step + covariance propagation, rounded as XLA
    compiles the JAX function's scan body on the CPU (ops/xla_math): the
    position and velocity updates as fused multiply-adds, the 3x3 products
    as fma chains, the 15 x 15 products in the library GEMM's order."""
    c = _constants(config, state.p.device)
    w = gyro - state.bg
    f = accel - state.ba
    a_w = xm.mv3(state.R, f) + c.g_w

    p_new = xm.fma32(a_w * (dt * 0.5), dt, xm.fma32(state.v, dt, state.p))
    v_new = xm.fma32(a_w, dt, state.v)
    R_new = xm.mm3(state.R, geometry.so3_exp(w * dt))

    # discrete error-state transition (first order)
    F = c.eye15.clone()
    F[0:3, 3:6] = c.eye3 * dt
    F[3:6, 6:9] = xm.mm3(-state.R, geometry.skew(f)) * dt
    F[3:6, 12:15] = -state.R * dt
    F[6:9, 6:9] = geometry.so3_exp(-w * dt)
    F[6:9, 9:12] = -c.eye3 * dt

    P_new = xm.mm_lanes(xm.mm_lanes(F, state.P), F.T) + torch.diag(c.q_rate * dt)
    return EKFState(p_new, v_new, R_new, state.bg, state.ba, P_new)


def propagate_batch(
    state: EKFState,
    gyro: torch.Tensor,
    accel: torch.Tensor,
    dt: torch.Tensor,
    config: EKFConfig,
) -> EKFState:
    """`propagate` over an IMU packet: gyro/accel (K, 3), dt (K,).

    Samples with dt == 0 are no-ops (padding), so fixed-size packets work.
    On the card the whole packet is one launch of csrc/xla_math.cu (one
    block: the covariance products a thread an entry, the mean on one
    thread), bit-equal to this loop, its plain version.
    """
    if xm.on_card(state.P):
        c = _constants(config, state.P.device)
        out = torch.empty(xm.IMU_STATE, dtype=torch.float32, device=state.P.device)
        xm.launch("propagate", [flat_state(state), imu_rows(gyro, accel, dt), c.imu],
                  [out], params=(gyro.shape[0],))
        return unflat_state(out)
    for k in range(gyro.shape[0]):
        new = propagate(state, gyro[k], accel[k], dt[k], config)
        state = _select(dt[k] > 0, new, state)
    return state


def flat_state(state: EKFState) -> torch.Tensor:
    """The state as csrc/xla_math.cu's IMU functions read it: p, v, R, bg,
    ba, P in one float32 vector of xla_math.IMU_STATE values."""
    return torch.cat([state.p, state.v, state.R.reshape(9), state.bg, state.ba,
                      state.P.reshape(225)])


def unflat_state(x: torch.Tensor) -> EKFState:
    return EKFState(x[0:3], x[3:6], x[6:15].view(3, 3), x[15:18], x[18:21], x[21:].view(15, 15))


def imu_rows(gyro: torch.Tensor, accel: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
    """IMU samples (..., 3), (..., 3), (...) as (n, 7) rows: gyro, accel, dt."""
    return torch.cat([gyro.reshape(-1, 3), accel.reshape(-1, 3), dt.reshape(-1, 1)], 1)


def _inject(state: EKFState, dx: torch.Tensor) -> EKFState:
    """Apply an error-state correction."""
    return EKFState(
        p=state.p + dx[0:3],
        v=state.v + dx[3:6],
        R=xm.mm3(state.R, geometry.so3_exp(dx[6:9])),
        bg=state.bg + dx[9:12],
        ba=state.ba + dx[12:15],
        P=state.P,
    )


def _mm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B for the filter's matrix products, rounded as XLA's CPU
    compiler does inside the JAX functions: the library GEMM's lane order
    (`xla_math.mm_lanes`) where 4 or more terms are summed, the inline fma
    chain (`xla_math.mm3`) over 3."""
    return xm.mm_lanes(A, B) if A.shape[-1] >= 4 else xm.mm3(A, B)


def _inv(S: torch.Tensor) -> torch.Tensor:
    """`torch.linalg.inv` on the card; on the CPU jaxlib's LAPACK, as the
    JAX function's jitted `jnp.linalg.inv` (ops/lapack_cpu)."""
    return lapack_cpu.inv(S) if S.device.type == "cpu" else torch.linalg.inv(S)


def _joseph(P: torch.Tensor, K: torch.Tensor, H: torch.Tensor, Rm: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(15, dtype=torch.float32, device=P.device)
    A = eye - _mm(K, H)
    return _mm(_mm(A, P), A.T) + _mm(_mm(K, Rm), K.T)


def update_pose_cov(state: EKFState, T_meas: torch.Tensor, Rm: torch.Tensor) -> EKFState:
    """Full-pose update with an explicit (6, 6) measurement covariance
    (e.g. the registration's own GN covariance, LIOConfig.icp_cov_mode
    "gn"). Its products round as the JAX function's do (`_mm`); the (6, 6)
    inverse is torch's LAPACK, not jaxlib's."""
    r_p = T_meas[:3, 3] - state.p
    r_th = geometry.so3_log(xm.mm3(state.R.T, T_meas[:3, :3]))
    r = torch.cat([r_p, r_th])

    H = _constants(EKFConfig(), state.p.device).H_pose
    S = _mm(_mm(H, state.P), H.T) + Rm
    K = _mm(_mm(state.P, H.T), _inv(S))
    dx = xm.mv3(K, r)
    new = _inject(state, dx)
    return new._replace(P=_joseph(state.P, K, H, Rm))


def update_pose(
    state: EKFState,
    T_meas: torch.Tensor,
    pos_std: float | torch.Tensor,
    rot_std: float | torch.Tensor,
) -> EKFState:
    """Full-pose update from scan registration (6-dof measurement)."""
    dev = state.p.device

    def var3(std):
        if isinstance(std, torch.Tensor):
            return (std.to(dev, torch.float32) ** 2).expand(3)
        return torch.full((3,), float(std) ** 2, dtype=torch.float32, device=dev)

    Rm = torch.diag(torch.cat([var3(pos_std), var3(rot_std)]))
    return update_pose_cov(state, T_meas, Rm)


def update_gps(
    state: EKFState,
    pos_meas: torch.Tensor,
    pos_cov: torch.Tensor | float,  # (3, 3) or scalar variance
    config: EKFConfig,
) -> tuple[EKFState, torch.Tensor]:
    """GPS position update with chi^2 gating; returns (state, accepted)."""
    c = _constants(config, state.p.device)
    if not isinstance(pos_cov, torch.Tensor) or pos_cov.ndim == 0:
        Rm = c.eye3 * pos_cov
    else:
        Rm = pos_cov.float()
    r = pos_meas - state.p
    H = c.H_gps
    S = _mm(_mm(H, state.P), H.T) + Rm
    S_inv = _inv(S)
    chi2 = xm.mv3(xm.mv3(S_inv.T, r)[None], r)[0]
    accept = chi2 <= config.gps_chi2_gate

    K = _mm(_mm(state.P, H.T), S_inv)
    dx = xm.mv3(K, r)
    updated = _inject(state, dx)._replace(P=_joseph(state.P, K, H, Rm))
    return _select(accept, updated, state), accept


def lio_fusion_step(
    state: EKFState,
    imu_gyro: torch.Tensor,  # (K, 3) packet since the last scan
    imu_accel: torch.Tensor,  # (K, 3)
    imu_dt: torch.Tensor,  # (K,) zeros = padding
    T_icp: torch.Tensor,  # (4, 4) registration pose measurement
    icp_pos_std: float | torch.Tensor,
    icp_rot_std: float | torch.Tensor,
    gps_pos: torch.Tensor,  # (3,)
    gps_var: torch.Tensor,  # () position variance
    gps_valid: torch.Tensor,  # () bool
    config: EKFConfig = EKFConfig(),
) -> tuple[EKFState, torch.Tensor]:
    """One fusion cycle: propagate IMU packet, ICP pose update, gated GPS
    update. Returns (state, gps_accepted)."""
    s = propagate_batch(state, imu_gyro, imu_accel, imu_dt, config)
    s = update_pose(s, T_icp, icp_pos_std, icp_rot_std)
    s_gps, accepted = update_gps(s, gps_pos, gps_var, config)
    s = _select(gps_valid, s_gps, s)
    return s, accepted & gps_valid


def pose_matrix(state: EKFState) -> torch.Tensor:
    return geometry.make_T(state.R, state.p)
