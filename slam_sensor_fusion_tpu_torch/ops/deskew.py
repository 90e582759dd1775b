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
from slam_sensor_fusion_tpu_torch.ops import xla_math as xm


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """Twist [rho, phi] of a rigid transform (inverse of geometry.se3_exp),
    rounded as XLA compiles the JAX function on the CPU (ops/xla_math):
    V^-1 = fma(a, K^2, fma(-1/2, K, I)) an entry, rho its fma chain with t.
    One launch of csrc/xla_math.cu on the card."""
    if xm.on_card(T):
        out = torch.empty(T.shape[:-2] + (6,), dtype=T.dtype, device=T.device)
        xm.launch("se3_log", [xm.rows(T, 16)], [out], n=out.numel() // 6)
        return out
    phi = geometry.so3_log(T[..., :3, :3])
    theta2 = xm.norm2(phi)
    theta = xm.sqrtf(torch.clamp(theta2, min=1e-24))
    K = geometry.skew(phi)
    sin, cos = xm.sincosf(theta)
    # V^{-1} = I - K/2 + (1/theta^2)(1 - theta sin / (2(1-cos))) K^2
    a = torch.where(
        theta2 > 1e-12,
        (1.0 - theta * sin / (2.0 * (1.0 - cos))) / theta2,
        1.0 / 12.0,
    )
    V_inv = xm.rodrigues(torch.full_like(a, -0.5), a, K, xm.mm3(K, K))
    rho = xm.mv3(V_inv, T[..., :3, 3])
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

    The arithmetic is the JAX function's as XLA compiles it on the CPU
    (ops/xla_math): glibc's sinf / cosf; each cross-product component
    fma(x, y, -(u v)), k x r0's as `_kxr_kkr`; R(th) p as fma(1 - cos, k x (k x p), fma(sin, k x p,
    p)); t as fma(sB, k x (k x r0), fma(s, r0, sA (k x r0))); divisions by
    constants as products. One launch of csrc/xla_math.cu on the card, a
    thread a point.
    """
    if xm.on_card(points):
        return _deskew_card(points, tau, frame_twist)
    rho0 = frame_twist[..., :3]
    phi0 = frame_twist[..., 3:]
    th0 = xm.sqrtf(torch.clamp(xm.norm2(phi0), min=1e-24))
    k = phi0 / th0[..., None]

    s = tau - 1.0  # (..., N) <= 0
    th = s * th0[..., None]  # signed angle about k
    sin, cos = xm.sincosf(th)
    # (1-cos th)/th and (th-sin th)/th, series-safe at th ~ 0
    small = th.abs() < 1e-4
    d = torch.where(small, 1.0, th)
    A = torch.where(small, 0.5 * th, (1.0 - cos) / d)
    B = torch.where(small, th * th * _SIXTH, (th - sin) / d)

    kc = [k[..., i, None] for i in range(3)]  # (..., 1) each
    pc = [points[..., i] for i in range(3)]  # (..., N) each
    kxp = xm.cross3(kc, pc)
    kkp = xm.cross3(kc, kxp)
    omc = 1.0 - cos
    Rp = [xm.fma32(omc, kkp[i], xm.fma32(sin, kxp[i], pc[i])) for i in range(3)]

    rc = [rho0[..., i, None] for i in range(3)]
    kxr, kkr = _kxr_kkr(kc, rc)  # fixed (..., 1) each
    sA, sB = s * A, s * B
    t = [xm.fma32(sB, kkr[i].expand_as(sB),
                  xm.fma32(s, rc[i].expand_as(s), sA * kxr[i])) for i in range(3)]
    return torch.stack([Rp[i] + t[i] for i in range(3)], dim=-1)


#: `th * th / 6.0` as XLA rewrites it: a product with the float32 1/6
_SIXTH = 1.0 / 6.0


def _kxr_kkr(k: list, r: list) -> tuple[tuple, tuple]:
    """k x r0 and k x (k x r0) as the jitted deskew's fusion computes them
    before its loop (its object code): each component fma(x, y, -(u v)),
    but (k x r0)_x as fma(-k2, r1, k1 r2) where the translation takes it,
    and that form in (k x (k x r0))_y; (k x (k x r0))_z takes the first."""
    f = xm.fma32
    k0, k1, k2 = k
    r0, r1, r2 = r
    x_a = f(k1, r2, -(k2 * r1))
    x_b = f(-k2, r1, k1 * r2)
    y = f(k2, r0, -(k0 * r2))
    z = f(k0, r1, -(k1 * r0))
    kkr = (f(k1, z, -(k2 * y)), f(k2, x_b, -(k0 * z)), f(k0, y, -(k1 * x_a)))
    return (x_b, y, z), kkr


def _deskew_card(points: torch.Tensor, tau: torch.Tensor, twist: torch.Tensor) -> torch.Tensor:
    """`deskew` on the card: points (..., N, 3), tau (..., N) and twists
    (..., 6) broadcast to one batch; one twist for every frame is read in
    place (stride 0)."""
    N = points.shape[-2]
    batch = torch.broadcast_shapes(points.shape[:-2], tau.shape[:-1], twist.shape[:-1])
    pts = xm.rows(points.expand(batch + (N, 3)), 3)
    ta = tau.expand(batch + (N,)).reshape(-1).contiguous()
    one = twist.numel() == 6
    tw = xm.rows(twist if one else twist.expand(batch + (6,)), 6)
    out = torch.empty(batch + (N, 3), dtype=points.dtype, device=points.device)
    xm.launch("deskew", [pts, ta, tw], [out], n=pts.shape[0], params=(N, 0 if one else 6))
    return out


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
