"""Scan deskewing (motion compensation): native-mode preprocessing (port
of the JAX `ops/deskew.py`).

LiDAR points within one sweep are measured at different times while the
sensor moves; each point is corrected by the fraction of the frame twist
elapsed at its timestamp, under a constant-velocity model:

    p_i' = exp((tau_i - 1) * xi) p_i,   xi = log(T_prev^-1 T_curr)

Everything is batched Rodrigues math, no per-point loop.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_sensor_fusion_tpu_torch.ops import geometry


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """Twist [rho, phi] of a rigid transform (inverse of geometry.se3_exp)."""
    phi = geometry.so3_log(T[..., :3, :3])
    theta2 = (phi * phi).sum(dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    K = geometry.skew(phi)
    # V^{-1} = I - K/2 + (1/theta^2)(1 - theta sin / (2(1-cos))) K^2
    a = torch.where(
        theta2 > 1e-12,
        (1.0 - theta * torch.sin(theta) / (2.0 * (1.0 - torch.cos(theta)))) / theta2,
        1.0 / 12.0,
    )
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(K.shape)
    V_inv = eye - 0.5 * K + a[..., None, None] * (K @ K)
    rho = torch.einsum("...ij,...j->...i", V_inv, T[..., :3, 3])
    return torch.cat([rho, phi], dim=-1)


def deskew(
    points: torch.Tensor,  # (..., N, 3) body-frame points at their measurement times
    tau: torch.Tensor,  # (..., N) in [0, 1]: fraction of the sweep elapsed
    frame_twist: torch.Tensor,  # (..., 6) = se3_log(T_prev^-1 @ T_curr)
) -> torch.Tensor:
    """Correct all points to the END-of-sweep frame; leading dimensions are
    frames, each with its own twist.

    A point measured at fraction tau sits in the frame exp((tau-1) * xi)
    relative to the sweep end; undo it. All per-point twists share ONE axis
    (xi_i = (tau_i - 1) * xi), so the exp collapses to fixed-axis Rodrigues:
    per point, two cross products against a constant axis and a handful of
    sin/cos terms.

        R(th) p = p + sin(th) (k x p) + (1 - cos(th)) k x (k x p)
        t(th)   = s [ r0 + (1-cos th)/th (k x r0)
                         + (th - sin th)/th  k x (k x r0) ],  s = tau - 1
    """
    rho0 = frame_twist[..., :3]
    phi0 = frame_twist[..., 3:]
    th0 = torch.sqrt(torch.clamp((phi0 * phi0).sum(dim=-1), min=1e-24))
    k = phi0 / th0[..., None]

    s = tau - 1.0  # (..., N) <= 0
    th = s * th0[..., None]  # signed angle about k
    sin = torch.sin(th)
    cos = torch.cos(th)
    # (1-cos th)/th and (th-sin th)/th, series-safe at th ~ 0
    small = th.abs() < 1e-4
    d = torch.where(small, 1.0, th)
    A = torch.where(small, 0.5 * th, (1.0 - cos) / d)
    B = torch.where(small, th * th / 6.0, (th - sin) / d)

    kp = k[..., None, :].expand(points.shape)
    kxp = torch.linalg.cross(kp, points)  # (..., N, 3)
    kkp = torch.linalg.cross(kp, kxp)
    Rp = points + sin[..., None] * kxp + (1.0 - cos)[..., None] * kkp

    kxr = torch.linalg.cross(k, rho0)  # fixed (..., 3)
    kkr = torch.linalg.cross(k, kxr)
    t = (
        s[..., None] * rho0[..., None, :]
        + (s * A)[..., None] * kxr[..., None, :]
        + (s * B)[..., None] * kkr[..., None, :]
    )
    return Rp + t


# ---------------------------------------------------------------------------
# Host-side (NumPy) twins, for loaders that stage deskewed scans on the host
# (the reference's upstream LIO publishes DESKEWED registered clouds,
# /cloud_registered_body, localization_node.cpp:80).
# ---------------------------------------------------------------------------


def se3_log_numpy(T: np.ndarray) -> np.ndarray:
    """Host twin of `se3_log` for one (4, 4) transform (float64)."""
    T = np.asarray(T, np.float64)
    R = T[:3, :3]
    cos_t = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = float(np.arccos(cos_t))
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    if theta < 1e-8:
        phi = 0.5 * w
    else:
        phi = (theta / (2.0 * np.sin(theta))) * w
    K = np.array([
        [0.0, -phi[2], phi[1]],
        [phi[2], 0.0, -phi[0]],
        [-phi[1], phi[0], 0.0],
    ])
    theta2 = float(phi @ phi)
    if theta2 > 1e-12:
        th = np.sqrt(theta2)
        a = (1.0 - th * np.sin(th) / (2.0 * (1.0 - np.cos(th)))) / theta2
    else:
        a = 1.0 / 12.0
    V_inv = np.eye(3) - 0.5 * K + a * (K @ K)
    rho = V_inv @ T[:3, 3]
    return np.concatenate([rho, phi])


def deskew_numpy(
    points: np.ndarray, tau: np.ndarray, frame_twist: np.ndarray
) -> np.ndarray:
    """Host twin of `deskew` (same fixed-axis Rodrigues form)."""
    points = np.asarray(points, np.float64)
    tau = np.asarray(tau, np.float64)
    xi = np.asarray(frame_twist, np.float64)
    rho0, phi0 = xi[:3], xi[3:]
    th0 = np.sqrt(max(float(phi0 @ phi0), 1e-24))
    k = phi0 / th0
    s = tau - 1.0
    th = s * th0
    sin, cos = np.sin(th), np.cos(th)
    small = np.abs(th) < 1e-4
    d = np.where(small, 1.0, th)
    A = np.where(small, 0.5 * th, (1.0 - cos) / d)
    B = np.where(small, th * th / 6.0, (th - sin) / d)
    kxp = np.cross(k[None, :], points)
    kkp = np.cross(k[None, :], kxp)
    Rp = points + sin[:, None] * kxp + (1.0 - cos)[:, None] * kkp
    kxr = np.cross(k, rho0)
    kkr = np.cross(k, kxr)
    t = (
        s[:, None] * rho0[None, :]
        + (s * A)[:, None] * kxr[None, :]
        + (s * B)[:, None] * kkr[None, :]
    )
    return (Rp + t).astype(np.float32)
