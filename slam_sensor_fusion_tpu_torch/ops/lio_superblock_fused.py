"""Whole-superblock LIO kernel K7 and its plain version (port of the JAX
`ops/lio_superblock_fused.py`): K frames of the LIO loop in one launch.

  per frame k:
    1. error-state EKF IMU propagation over the frame's packet: the mean in
       3x3 scalar math, the 15-state covariance as a zero-padded (16, 16)
       matrix, P <- F P F^T + Q dt a sample;
    2. scan-to-map point-to-plane GN against the block's anchor pages (K4's
       loop: pair-list association with 6-row xyz+normal pages, the 29
       Huber-weighted moments, unrolled 6x6 Cholesky, Taylor SE(3) step),
       indexed by the frame's pair list; the stats pass's UNDAMPED moments
       feed the measurement covariance;
    3. EKF pose update: residual against the propagated prior (small-angle
       asin series for the rotation), Kalman gain through a 6x6 inverse from
       six Cholesky solves, Joseph-form covariance; `icp_cov_mode="gn"`
       takes sigma^2 (JtJ)^-1 adjoint-mapped to (position, body attitude),
       floored, plus the block-start pose covariance (`gn_anchor_cov`);
    4. chi^2-gated GPS position update with a 3x3 adjugate inverse; a
       rejected fix leaves the state and P unchanged;
    5. predicated state update for invalid (tail-padding) frames.

The ring insert and the anchor refresh stay outside (models/lio.
run_lio_superblocks): within a block the anchor is frozen.

`lio_superblock` launches the CUDA kernel (csrc/lio_superblock_fused.cu)
for tensors on the card and runs `lio_superblock_plain` for CPU tensors.
The plain version is written from the Pallas kernel, not from
models/ekf.py: the Taylor-series rotation exponential, the asin-series
log, the 16x16 padded covariance and the Cholesky-built inverse are the
kernel's. It rounds as the JAX kernel does when XLA compiles it for the
CPU (ops/p2p_fused's scalar tail): the (16, 16) and (16, 6) products in
the library GEMM's order (`xla_math.mm_lanes`), the matrix-vector and
3-term products as fma chains from k = 0 (`xla_math.mv3`, `xla_math.mm3`),
the 3x3 scalar math contracted as LLVM contracts it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from slam_sensor_fusion_tpu_torch.models.ekf import GRAVITY, EKFConfig
from slam_sensor_fusion_tpu_torch.ops import cuda_lib
from slam_sensor_fusion_tpu_torch.ops import xla_math as xm
from slam_sensor_fusion_tpu_torch.ops.icp_fused import _associate_first
from slam_sensor_fusion_tpu_torch.ops.p2p_fused import (
    _P2PParams,
    _adjugate_k,
    _chol6_solve,
    _fma,
    _gn_passes_plain,
    _jtj_from_tri,
    _mm3k,
    _mv3k,
    _params,
    _se3_exp_taylor,
    _sum3,
)
from slam_sensor_fusion_tpu_torch.ops.point_to_plane import PointToPlaneConfig

#: rows of the (position, attitude) pose measurement in the 15-state
_POSE6 = [0, 1, 2, 6, 7, 8]


class LIOSuperblockParams(NamedTuple):
    """Static kernel parameters."""

    p2p: PointToPlaneConfig
    ekf: EKFConfig
    icp_pos_std: float = 0.3
    icp_rot_std: float = 0.01
    #: "constant" = diag(icp_pos_std, icp_rot_std); "gn" = adjoint-mapped
    #: sigma^2 (JtJ)^-1 from the final GN moments + std floors
    icp_cov_mode: str = "constant"
    gn_cov_scale: float = 1.0
    gn_pos_std_floor: float = 0.02
    gn_rot_std_floor: float = 0.005
    #: gn mode: add the block-start pose covariance (the anchor ring was
    #: PLACED with that uncertainty)
    gn_anchor_cov: bool = True
    #: slack-violation observability: per-frame budget on |realized prior
    #: - dead-reckoned prediction| is slack * k + slack_base
    superstep_slack: float = 0.05
    slack_base: float = 0.05


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _mm_k3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(M, 3) @ (3, 3) as XLA's CPU code emits the Kalman gain's product
    (its loop vectorized by LLVM): columns 0 and 1 the three products
    added in order, column 2 the fma chain from k = 0."""
    P = [A[:, k, None] * B[None, k, :2] for k in range(3)]
    chain = _fma(A[:, 2], B[2, 2], _fma(A[:, 1], B[1, 2], A[:, 0] * B[0, 2]))
    return torch.cat([(P[0] + P[1]) + P[2], chain[:, None]], dim=1)


def _so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rotation part of the Taylor-series SE(3) exp."""
    return _se3_exp_taylor(phi * 0.0, phi)[0]


def _so3_log_small(R_err: torch.Tensor) -> torch.Tensor:
    """Small-angle so3_log by the asin series: theta = asin(|s|),
    s = vee(R - R^T) / 2; exact to ~2e-6 rad for |theta| < 0.3."""
    s = 0.5 * torch.stack(
        [R_err[2, 1] - R_err[1, 2], R_err[0, 2] - R_err[2, 0], R_err[1, 0] - R_err[0, 1]]
    )
    m2 = _sum3(s[0], s[0], s[1], s[1], s[2], s[2])
    fac = _fma(m2, _fma(m2, _fma(m2, 15.0 / 336.0, 3.0 / 40.0), 1.0 / 6.0), 1.0)
    return s * fac


def _inv6_cholesky(A: torch.Tensor) -> torch.Tensor:
    """(6, 6) SPD inverse from six Cholesky solves, one a unit vector (the
    lower triangle is read)."""
    eye = torch.eye(6, dtype=torch.float32, device=A.device)
    return torch.stack([torch.stack(_chol6_solve(A, eye[e])) for e in range(6)], dim=1)


def _skew(v: torch.Tensor) -> torch.Tensor:
    z = v[0] * 0.0
    return torch.stack(
        [torch.stack([z, -v[2], v[1]]), torch.stack([v[2], z, -v[0]]), torch.stack([-v[1], v[0], z])]
    )


def _meas_var(params: LIOSuperblockParams) -> list[float]:
    """The pose measurement variances: the std floors in gn mode, the
    constant stds otherwise."""
    if params.icp_cov_mode == "gn":
        return [params.gn_pos_std_floor**2] * 3 + [params.gn_rot_std_floor**2] * 3
    return [params.icp_pos_std**2] * 3 + [params.icp_rot_std**2] * 3


def _q_rates(e: EKFConfig) -> list[float]:
    """The continuous process-noise diagonal of the padded 16-state."""
    return (
        [0.0] * 3 + [e.accel_noise**2] * 3 + [e.gyro_noise**2] * 3
        + [e.gyro_bias_walk**2] * 3 + [e.accel_bias_walk**2] * 3 + [0.0]
    )


def _kernel_plain(
    pair_start, pair_cnt, pair_tgt, valid, gyro, accel, dts, gps_pos, gps_var, gps_valid,
    pred_t, vec0, center, pose0, P0, src_pages, tgt_pages, params: LIOSuperblockParams,
):
    """The Pallas kernel's body on the kernel's inputs (valid and gps_valid
    int32, gyro and accel (K, Ki * 3), vec0 = [v, bg, ba], P0 (16, 16)):
    returns (poses (K, 4, 4), stats (K, 128), pose (4, 4), P (16, 16), vec
    (1, 128))."""
    dev = src_pages.device
    f32 = {"dtype": torch.float32, "device": dev}
    p2p, e = params.p2p, params.ekf
    K, Ki = dts.shape
    eye3, eye16 = torch.eye(3, **f32), torch.eye(16, **f32)
    q_base = torch.diag(torch.tensor(_q_rates(e), **f32))
    g_w = torch.tensor([0.0, 0.0, -GRAVITY], **f32)
    pose_idx = torch.tensor(_POSE6, device=dev)
    meas = torch.diag(torch.tensor(_meas_var(params), **f32))
    start_all, cnt_all = pair_start.tolist(), pair_cnt.tolist()

    # the anchor was refreshed at block start: its world uncertainty IS the
    # block-start pose covariance
    S_anchor = P0[pose_idx][:, pose_idx]
    p_c, v_c, R_c = pose0[:3, 3], vec0[0:3], pose0[:3, :3]
    bg_c, ba_c, P_c = vec0[3:6], vec0[6:9], P0
    poses, stats = [], []
    for k in range(K):
        vld = valid[k] != 0
        # 1) IMU propagation (models/ekf.py:89-121)
        p, v, R, P = p_c, v_c, R_c, P_c
        for j in range(Ki):
            d = dts[k, j]
            w = gyro[k, 3 * j : 3 * j + 3] - bg_c
            f = accel[k, 3 * j : 3 * j + 3] - ba_c
            a_w = _mv3k(R, f) + g_w
            p_n = _fma((0.5 * d) * d, a_w, _fma(v, d, p))
            v_n = _fma(a_w, d, v)
            R_n = _mm3k(R, _so3_exp(w * d))
            F = eye16.clone()
            F[0:3, 3:6] = eye3 * d
            F[3:6, 6:9] = _mm3k(R, _skew(f)) * (-d)
            F[3:6, 12:15] = R * (-d)
            F[6:9, 6:9] = eye3 + (_so3_exp(w * (-d)) - eye3)
            F[6:9, 9:12] = eye3 * (-d)
            P = _fma(q_base, d, xm.mm_lanes(xm.mm_lanes(F, P), F.T))
            p, v, R = p_n, v_n, R_n

        # the pair list was built at the dead-reckoned prediction with
        # slack * k + base dilation
        dp = p - pred_t[k]
        slack_dist = xm.sqrtf(_sum3(dp[0], dp[0], dp[1], dp[1], dp[2], dp[2]))
        budget = _fma(torch.tensor(params.superstep_slack, **f32), float(k), params.slack_base)
        slack_viol = slack_dist > budget

        # 2) GN registration in the anchor-rebased frame
        src = src_pages[k]
        start, cnt = start_all[k], cnt_all[k]

        def assoc(R_, t_, src=src, start=start, cnt=cnt, k=k):
            d2, qn = _associate_first(src, R_, t_, start, cnt, pair_tgt[k], tgt_pages)
            return d2[:, None, :], qn

        if p2p.fixed_correspondences:
            fixed = assoc(R, p - center)
            matched = lambda R_, t_, fixed=fixed: fixed  # noqa: E731
        else:
            matched = assoc
        R_icp, t_reb, tot = _gn_passes_plain(R, p - center, src, matched, p2p)
        W, wr2 = tot[27], tot[28]
        rmse = xm.sqrtf(wr2 / torch.clamp(W, min=1.0))
        enough = W >= 3.0
        R_meas = torch.where(enough, R_icp, R)
        t_meas = torch.where(enough, t_reb + center, p)
        t_meas_reb = torch.where(enough, t_reb, p - center)

        # 3) EKF pose update (models/ekf.py:162-184)
        r6 = torch.cat([t_meas - p, _so3_log_small(_mm3k(R.T, R_meas))])
        if params.icp_cov_mode == "gn":
            # sigma^2 (JtJ)^-1, mapped from the left-perturbation frame to
            # (dp, dtheta_body): dp = rho + phi x t, dtheta_body = R^T phi
            sigma2 = (wr2 / torch.clamp(W - 6.0, min=1.0)) * params.gn_cov_scale
            Sg = sigma2 * _inv6_cholesky(_jtj_from_tri(tot[:21]) + torch.eye(6, **f32) * 1e-6)
            C = torch.zeros((6, 6), **f32)
            C[0:3, 0:3] = eye3
            C[0:3, 3:6] = -_skew(t_meas_reb)
            C[3:6, 3:6] = R_meas.T
            # XLA emits these two 6 x 6 products inline (fma chains from k = 0)
            Rm = xm.mm3(xm.mm3(C, Sg), C.T) + meas
            if params.gn_anchor_cov:
                Rm = Rm + S_anchor
        else:
            Rm = meas
        PE = P[:, pose_idx]  # (16, 6)
        S_inv = _inv6_cholesky(PE[pose_idx] + Rm)
        Kk = xm.mm_lanes(PE, S_inv)  # (16, 6)
        dx = xm.mv3(Kk, r6)
        p2, v2 = p + dx[0:3], v + dx[3:6]
        R2 = _mm3k(R, _so3_exp(dx[6:9]))
        bg2, ba2 = bg_c + dx[9:12], ba_c + dx[12:15]
        KE = torch.zeros((16, 16), **f32)
        KE[:, pose_idx] = Kk
        A = eye16 - KE
        P2 = (xm.mm_lanes(xm.mm_lanes(A, P), A.T)
              + xm.mm_lanes(xm.mm_lanes(Kk, Rm), Kk.T))

        # 4) chi^2-gated GPS update (models/ekf.py:187-211)
        gv = gps_valid[k] != 0
        var = gps_var[k]
        r3 = gps_pos[k] - p2
        S3 = P2[0:3, 0:3] + eye3 * var
        S3_inv, _ = _adjugate_k(S3)
        q3 = _mv3k(S3_inv, r3)
        chi2 = _sum3(r3[0], q3[0], r3[1], q3[1], r3[2], q3[2])
        acc = ((chi2 <= e.gps_chi2_gate) & gv).float()
        K3 = _mm_k3(P2[:, 0:3], S3_inv)  # (16, 3)
        dx3 = xm.mv3(K3, r3)
        p3, v3 = p2 + acc * dx3[0:3], v2 + acc * dx3[3:6]
        R3 = _mm3k(R2, _so3_exp(acc * dx3[6:9]))
        bg3, ba3 = bg2 + acc * dx3[9:12], ba2 + acc * dx3[12:15]
        KE3 = torch.zeros((16, 16), **f32)
        KE3[:, 0:3] = K3
        A3 = eye16 - acc * KE3
        P3 = _fma(acc * var, xm.mm3(K3, K3.T), xm.mm_lanes(xm.mm_lanes(A3, P2), A3.T))

        # 5) predicated state update + outputs
        p_c = torch.where(vld, p3, p_c)
        v_c = torch.where(vld, v3, v_c)
        R_c = torch.where(vld, R3, R_c)
        bg_c = torch.where(vld, bg3, bg_c)
        ba_c = torch.where(vld, ba3, ba_c)
        P_c = torch.where(vld, P3, P_c)
        vf = vld.float()
        T = eye16[:4, :4].clone()
        T[:3, :3], T[:3, 3] = R_c, p_c
        poses.append(T)
        row = torch.zeros(128, **f32)
        row[:9] = vf * torch.stack(
            [
                rmse, W, acc * gv.float(), chi2, slack_viol.float(), slack_dist,
                xm.sqrtf(torch.clamp(Rm[0, 0], min=0.0)),
                xm.sqrtf(torch.clamp(Rm[1, 1], min=0.0)),
                xm.sqrtf(torch.clamp(Rm[2, 2], min=0.0)),
            ]
        )
        stats.append(row)
    T = eye16[:4, :4].clone()
    T[:3, :3], T[:3, 3] = R_c, p_c
    vec = torch.zeros((1, 128), **f32)
    vec[0, :9] = torch.cat([v_c, bg_c, ba_c])
    return torch.stack(poses), torch.stack(stats), T, P_c, vec


# ---------------------------------------------------------------------------
# host and kernel wrapper
# ---------------------------------------------------------------------------


class _LIOParams(ctypes.Structure):
    """Mirrors `struct LioParams` in csrc/lio_superblock_fused.cu."""

    _fields_ = [
        ("p2p", _P2PParams),
        ("q_rate", ctypes.c_float * 16),
        ("meas_var", ctypes.c_float * 6),
        ("gps_chi2_gate", ctypes.c_float),
        ("gn_cov_scale", ctypes.c_float),
        ("superstep_slack", ctypes.c_float),
        ("slack_base", ctypes.c_float),
        ("cov_gn", ctypes.c_int),
        ("gn_anchor_cov", ctypes.c_int),
    ]


def _lio_params(params: LIOSuperblockParams) -> _LIOParams:
    return _LIOParams(
        p2p=_params(params.p2p),
        q_rate=(ctypes.c_float * 16)(*_q_rates(params.ekf)),
        meas_var=(ctypes.c_float * 6)(*_meas_var(params)),
        gps_chi2_gate=params.ekf.gps_chi2_gate,
        gn_cov_scale=params.gn_cov_scale,
        superstep_slack=params.superstep_slack,
        slack_base=params.slack_base,
        cov_gn=int(params.icp_cov_mode == "gn"),
        gn_anchor_cov=int(params.gn_anchor_cov),
    )


def _padded_inputs(valid, gyro, accel, gps_valid, v0, bg0, ba0, P0):
    """The kernel's layout of the host arguments: (valid i32, gyro
    (K, Ki*3), accel, gps_valid i32, vec0 (9,) = [v, bg, ba], P0 padded to
    (16, 16))."""
    K, Ki = gyro.shape[0], gyro.shape[1]
    P0_pad = torch.nn.functional.pad(P0.float(), (0, 1, 0, 1))
    vec0 = torch.cat([v0.float(), bg0.float(), ba0.float()])
    return (
        valid.to(torch.int32), gyro.reshape(K, Ki * 3).contiguous(),
        accel.reshape(K, Ki * 3).contiguous(), gps_valid.to(torch.int32), vec0, P0_pad,
    )


def _outputs(poses, stats, pose_n, P_n, vec_n):
    """(poses, stats, pose, v, bg, ba, P (15, 15)) from the kernel's
    outputs."""
    return poses, stats, pose_n, vec_n[0, 0:3], vec_n[0, 3:6], vec_n[0, 6:9], P_n[:15, :15]


def lio_superblock_plain(
    pair_start, pair_cnt, pair_tgt, valid, gyro, accel, dts, gps_pos, gps_var, gps_valid,
    pred_t, pose0, v0, bg0, ba0, P0, center, src_pages, tgt_pages,
    params: LIOSuperblockParams,
):
    """K7 as plain PyTorch; same arguments and outputs as `lio_superblock`."""
    valid_i, gy, ac, gok, vec0, P0_pad = _padded_inputs(
        valid, gyro, accel, gps_valid, v0, bg0, ba0, P0
    )
    out = _kernel_plain(
        pair_start, pair_cnt, pair_tgt, valid_i, gy, ac, dts, gps_pos, gps_var, gok, pred_t,
        vec0, center, pose0, P0_pad, src_pages, tgt_pages, params,
    )
    return _outputs(*out)


def lio_superblock(
    pair_start: torch.Tensor,  # (K, nSt) i32 per-src-tile offsets into pair_tgt
    pair_cnt: torch.Tensor,  # (K, nSt) i32 per-src-tile admitted-tile counts
    pair_tgt: torch.Tensor,  # (K, max_pairs) i32 flat row-major target tiles
    valid: torch.Tensor,  # (K,) bool
    gyro: torch.Tensor,  # (K, Ki, 3)
    accel: torch.Tensor,  # (K, Ki, 3)
    dts: torch.Tensor,  # (K, Ki)
    gps_pos: torch.Tensor,  # (K, 3)
    gps_var: torch.Tensor,  # (K,)
    gps_valid: torch.Tensor,  # (K,) bool
    pred_t: torch.Tensor,  # (K, 3) dead-reckoned translations
    pose0: torch.Tensor,  # (4, 4)
    v0: torch.Tensor,  # (3,)
    bg0: torch.Tensor,
    ba0: torch.Tensor,
    P0: torch.Tensor,  # (15, 15)
    center: torch.Tensor,  # (3,)
    src_pages: torch.Tensor,  # (K, nSt, 3, TM) body frame, invalid -> +1e7
    tgt_pages: torch.Tensor,  # (nTt, 6, TN) anchor xyz (rebased) + normals
    params: LIOSuperblockParams,
):
    """One launch for a whole K-frame LIO block (K7).

    Returns (poses (K, 4, 4), stats (K, 128), pose (4, 4), v, bg, ba,
    P (15, 15)); stats lanes: [rmse, n_corr, gps_accepted, gps_chi2,
    slack_violation, slack_dist, x_std_used, y_std_used, z_std_used] (the
    *_std_used lanes are sqrt of the measurement covariance diagonal fed to
    the pose update). CPU tensors run the plain version; CUDA tensors
    launch the kernel or raise."""
    dev = src_pages.device
    K, nSt, _, TM = src_pages.shape
    nTt, _, TN = tgt_pages.shape
    Ki = dts.shape[1]
    max_pairs = pair_tgt.shape[1]
    f32, i32 = torch.float32, torch.int32
    valid_i, gy, ac, gok, vec0, P0_pad = _padded_inputs(
        valid, gyro, accel, gps_valid, v0, bg0, ba0, P0
    )
    args = [
        (pair_start, "pair_start", i32, (K, nSt)),
        (pair_cnt, "pair_cnt", i32, (K, nSt)),
        (pair_tgt, "pair_tgt", i32, (K, max_pairs)),
        (valid_i, "valid", i32, (K,)),
        (gy, "gyro", f32, (K, Ki * 3)),
        (ac, "accel", f32, (K, Ki * 3)),
        (dts, "dts", f32, (K, Ki)),
        (gps_pos, "gps_pos", f32, (K, 3)),
        (gps_var, "gps_var", f32, (K,)),
        (gok, "gps_valid", i32, (K,)),
        (pred_t, "pred_t", f32, (K, 3)),
        (vec0, "vec0", f32, (9,)),
        (center, "center", f32, (3,)),
        (pose0, "pose0", f32, (4, 4)),
        (P0_pad, "P0", f32, (16, 16)),
        (src_pages, "src_pages", f32, (K, nSt, 3, TM)),
        (tgt_pages, "tgt_pages", f32, (nTt, 6, TN)),
    ]
    for t, name, dtype, shape in args:
        cuda_lib.require(t, name, dtype, shape, dev)
    if dev.type == "cpu":
        return _outputs(*_kernel_plain(*[t for t, *_ in args], params))
    if dev.type != "cuda":
        raise ValueError(f"lio_superblock: unsupported device {dev}")
    cuda_lib.check_tile_src("lio_superblock", TM)
    poses = torch.empty((K, 4, 4), dtype=f32, device=dev)
    stats = torch.empty((K, 128), dtype=f32, device=dev)
    pose_n = torch.empty((4, 4), dtype=f32, device=dev)
    P_n = torch.empty((16, 16), dtype=f32, device=dev)
    vec_n = torch.empty((1, 128), dtype=f32, device=dev)
    # the matched set (7 floats a point) in a global buffer, as K4's
    best_d2 = torch.empty((nSt, 1, TM), dtype=f32, device=dev)
    best_qn = torch.empty((nSt, 6, TM), dtype=f32, device=dev)
    # an association round's per-slot winners from the grid's workers,
    # reused frame after frame (the rounds are serial)
    slot_d2 = torch.empty((max_pairs, TM), dtype=f32, device=dev)
    slot_row = torch.empty((max_pairs, TM), dtype=i32, device=dev)
    ctl = cuda_lib.control_block(dev)
    prm = _lio_params(params)
    err = cuda_lib.lib().sfk_lio_superblock(
        *[t.data_ptr() for t, *_ in args],
        poses.data_ptr(), stats.data_ptr(), pose_n.data_ptr(), P_n.data_ptr(),
        vec_n.data_ptr(), best_d2.data_ptr(), best_qn.data_ptr(), slot_d2.data_ptr(),
        slot_row.data_ptr(), ctl.data_ptr(),
        K, Ki, nSt, TM, TN, max_pairs, ctypes.addressof(prm), cuda_lib.stream_ptr(src_pages),
    )
    cuda_lib.check(err, "lio_superblock")
    lio_superblock.launches += 1
    return _outputs(poses, stats, pose_n, P_n, vec_n)


#: kernel launches made by `lio_superblock` (CUDA tensors only)
lio_superblock.launches = 0


def kernel_grid(n_src_tiles: int, tile_src: int) -> dict:
    """K7's cooperative grid on the current card for these tiles: blocks,
    threads a block and the blocks a multiprocessor could hold."""
    return cuda_lib.grid_shape(cuda_lib.lib().sfk_lio_grid, n_src_tiles, tile_src)
