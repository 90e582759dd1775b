"""SE(3) primitives on torch tensors (port of the JAX `ops/geometry.py`).

Poses are (..., 4, 4) float32 homogeneous matrices, exactly like the
reference — the pipeline even blends them element-wise because the
reference does (localization_node.cpp:329).

`rot_z`, `so3_exp`, `so3_log` and `se3_exp` round as the JAX package's
jitted functions do on the CPU (ops/xla_math: glibc's sinf / cosf,
XLA's arccos, correctly rounded sqrt, XLA's fused multiply-adds). On the
card `so3_exp`, `so3_log` and `se3_exp` are one launch each of
csrc/xla_math.cu, bit-equal to the tensor ops below, which are their plain
versions on the CPU.
"""

from __future__ import annotations

import torch

from slam_sensor_fusion_tpu_torch.ops import xla_math as xm


def rot_z(yaw: torch.Tensor) -> torch.Tensor:
    """Rotation about +Z by ``yaw`` radians. Works on scalars or batches."""
    s, c = xm.sincosf(yaw)
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    return torch.stack(
        [
            torch.stack([c, -s, zero], dim=-1),
            torch.stack([s, c, zero], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )


def make_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble homogeneous transform(s) from rotation(s) and translation(s)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    T = torch.zeros(batch + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def inv_T(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid transform without a general 4x4 solve."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make_T(Rt, -xm.mv3(Rt, T[..., :3, 3]))


def transform_points(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply rigid transform(s) to (..., N, 3) points."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return torch.einsum("...ij,...nj->...ni", R, points) + t[..., None, :]


def quat_to_R(q: torch.Tensor) -> torch.Tensor:
    """(w, x, y, z) quaternion(s) to rotation matrix, normalizing first.

    Same math Eigen::Quaternionf::toRotationMatrix performs for the
    odometry messages (localization_node.cpp:94-102).
    """
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack(
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1
            ),
            torch.stack(
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1
            ),
            torch.stack(
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1
            ),
        ],
        dim=-2,
    )


def R_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix to (w, x, y, z) quaternion, branch-free.

    Uses the four-hypothesis construction (one per largest diagonal
    candidate) and selects the numerically safest; the first of equal
    scores wins, as in the JAX package.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def root(a):
        return torch.sqrt(torch.clamp(a, min=1e-12)) * 2.0

    s0 = root(tr + 1.0)
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], dim=-1)
    s1 = root(1.0 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], dim=-1)
    s2 = root(1.0 + m11 - m00 - m22)
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], dim=-1)
    s3 = root(1.0 + m22 - m00 - m11)
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], dim=-1)

    cands = torch.stack([q0, q1, q2, q3], dim=-2)
    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1)
    idx = torch.argmax(scores, dim=-1)
    q = torch.take_along_dim(cands, idx[..., None, None].expand(*idx.shape, 1, 4), dim=-2)[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def wrap_pi(angle: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to [-pi, pi)."""
    return torch.remainder(angle + torch.pi, 2 * torch.pi) - torch.pi


def compass_heading_to_yaw(heading_deg: torch.Tensor) -> torch.Tensor:
    """ArduPilot compass heading (deg, CW positive) -> ENU yaw (rad).

    Mirrors localization_node.cpp:66-77 / map_data_save_node.cpp:38-50.
    """
    return wrap_pi(torch.deg2rad(90.0 - heading_deg))


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [v]x of (..., 3) vectors."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


#: the series branches' divisions by constants, as XLA rewrites them:
#: multiplications by the float32 reciprocals
_SIXTH = 1.0 / 6.0
_TWENTYFOURTH = 1.0 / 24.0
_ONE_TWENTIETH = 1.0 / 120.0


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: exp of (..., 3) rotation vectors, stable near 0. The
    series branch's `theta2 / 6` is XLA's multiply by the float32 1/6."""
    if xm.on_card(w):
        out = torch.empty(w.shape[:-1] + (3, 3), dtype=w.dtype, device=w.device)
        xm.launch("so3_exp", [xm.rows(w, 3)], [out], n=out.numel() // 9)
        return out
    theta2 = xm.norm2(w)
    theta = xm.sqrtf(torch.clamp(theta2, min=1e-24))
    sin, cos = xm.sincosf(theta)
    a = torch.where(theta2 > 1e-12, sin / theta, 1.0 - theta2 * _SIXTH)
    b = torch.where(theta2 > 1e-12, (1.0 - cos) / theta2, 0.5 - theta2 * _TWENTYFOURTH)
    K = skew(w)
    return xm.rodrigues(a, b, K, xm.mm3(K, K))


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation vector of (..., 3, 3) rotations (principal branch)."""
    if xm.on_card(R):
        out = torch.empty(R.shape[:-1], dtype=R.dtype, device=R.device)
        xm.launch("so3_log", [xm.rows(R, 9)], [out], n=out.numel() // 3)
        return out
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = xm.acosf(cos_t)
    v = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    scale = torch.where(
        theta > 1e-6, theta / (2.0 * xm.sinf(torch.clamp(theta, min=1e-12))), 0.5
    )
    return v * scale[..., None]


def svd3x3(H: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full SVD of (..., 3, 3): (U, S, Vh). A thin wrapper, as the JAX
    package's is; the singular vectors' signs are the backend's (LAPACK on
    the CPU, cuSOLVER on the card), not necessarily the JAX package's."""
    U, S, Vh = torch.linalg.svd(H, full_matrices=True)
    return U, S, Vh


def kabsch(src: torch.Tensor, tgt: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted Kabsch/Umeyama rigid step: the best T with tgt ~= R src + t
    (icp_point_to_point.cpp:112-159): weighted centroids, cross-covariance
    H = src0^T diag(w) tgt0, 3x3 SVD, reflection fixed by flipping V's last
    column, t = c_tgt - R c_src. src, tgt (N, 3); weights (N,), 0 for
    masked-out rows. Returns (4, 4)."""
    w = weights.to(src.dtype)
    wsum = torch.clamp(w.sum(), min=1e-12)
    c_src = (src * w[:, None]).sum(dim=0) / wsum
    c_tgt = (tgt * w[:, None]).sum(dim=0) / wsum
    src0 = (src - c_src) * w[:, None]
    tgt0 = tgt - c_tgt
    H = src0.T @ tgt0
    U, _, Vh = svd3x3(H)
    V = Vh.T
    det = torch.linalg.det(V @ U.T)
    flip = torch.ones(3, dtype=H.dtype, device=H.device)
    flip[2] = torch.where(det < 0, -1.0, 1.0)
    R = (V * flip[None, :]) @ U.T
    return make_T(R, c_tgt - R @ c_src)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """exp of (..., 6) twists [rho, phi] -> (..., 4, 4) rigid transforms."""
    if xm.on_card(xi):
        out = torch.empty(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
        xm.launch("se3_exp", [xm.rows(xi, 6)], [out], n=out.numel() // 16)
        return out
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    theta2 = xm.norm2(phi)
    theta = xm.sqrtf(torch.clamp(theta2, min=1e-24))
    K = skew(phi)
    sin, cos = xm.sincosf(theta)
    b = torch.where(theta2 > 1e-12, (1.0 - cos) / theta2, 0.5 - theta2 * _TWENTYFOURTH)
    c = torch.where(
        theta2 > 1e-12,
        (theta - sin) / (theta2 * theta),
        _SIXTH - theta2 * _ONE_TWENTIETH,
    )
    V = xm.rodrigues(b, c, K, xm.mm3(K, K))
    return make_T(R, xm.mv3(V, rho))
