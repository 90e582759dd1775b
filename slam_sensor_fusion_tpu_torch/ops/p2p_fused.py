"""Whole-GN fused point-to-plane kernels K4, K5, K6, their plain versions
and their hosts (port of the JAX `ops/p2p_fused.py`): the native LIO fast
path.

One K4 launch runs a WHOLE point-to-plane registration on prebuilt pages
and a tile-major pair list:

  per GN iteration:
    1. associate: per source tile, direct (t - s)^2 distances to each
       admitted target tile under the CURRENT (R, t); target pages carry
       SIX rows (xyz + normal), so the winner brings its normal along. The
       FIRST row wins exact ties within a tile, a strict `<` keeps the
       earlier tile (K3's rule, ops/icp_fused.py);
    2. reduce: residuals r = n.(p' - q), Huber weights, Jacobian rows
       J = [n, p' x n], and the 21 + 6 unique JtJ / Jtr moments, W and
       sum w r^2;
    3. solve: 6x6 Cholesky, fully unrolled;
    4. update: T <- exp(dx) T with a 4-term Taylor SE(3) exponential and
       one Newton-polar step to pin orthogonality.

The iteration count is FIXED (no early exit); a trailing stats pass takes
the moments at the final transform without a step. Invalid normals are
ZERO vectors in the pages: they contribute nothing to the moments and are
excluded from the correspondence count by the |n|^2 > 0.5 test. With
`fixed_correspondences` the association runs once, at the prior.

K5 is K4's association alone (its winners are the outputs), K6 is K4's GN
on a given matched set; K6(K5(x)) equals K4 with fixed correspondences,
which is how the map-sharded registration (parallel/map_shard.sp_p2p_align)
combines per-shard winners.

`_p2p_core`, `_p2p_associate` and `_p2p_gn_corr` launch the CUDA kernels
(csrc/p2p_fused.cu; K4 a cooperative grid of one block on each SM, K5 a
scan over every SM and a combine, K6 a thread-block cluster) for
tensors on the card and run the plain versions
(`_p2p_core_plain`, `_p2p_associate_plain`, `_p2p_gn_corr_plain`) for CPU
tensors. The plain versions follow the kernels' arithmetic (direct
differences, tile-major walk, Taylor exp, unrolled Cholesky), not
`point_to_plane_align`'s.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from slam_sensor_fusion_tpu_torch.ops import cuda_lib
from slam_sensor_fusion_tpu_torch.ops import geometry
from slam_sensor_fusion_tpu_torch.ops import xla_math as xm
from slam_sensor_fusion_tpu_torch.ops.icp_fused import (
    SOURCE_SENTINEL,
    TARGET_SENTINEL,
    _associate_first,
    _shifts,
)
from slam_sensor_fusion_tpu_torch.ops.morton import tile_bboxes
from slam_sensor_fusion_tpu_torch.ops.nn_gated import pair_tiles
from slam_sensor_fusion_tpu_torch.ops.nn_pallas import _build_tile_pair_list, make_pages
from slam_sensor_fusion_tpu_torch.ops.point_to_plane import (
    _REDUCE_WINDOW,
    PointToPlaneConfig,
    PointToPlaneResult,
    pose_covariance_from_jtj,
)

# ---------------------------------------------------------------------------
# scalar tail (the plain versions' arithmetic; the card kernels in
# csrc/p2p_fused.cu round each operation alone and are held to these within
# 3e-4)
#
# The JAX kernels run on the CPU as XLA compiles them, and the plain
# versions follow that order so the two agree bit for bit (XLA's optimized
# HLO and the object code of its fusions, read off `--xla_dump_to`):
# - LLVM contracts a product that feeds a sum or a difference into a fused
#   multiply-add: `a b + c d + e f` is fma(e, f, fma(a, b, c d)) (`_sum3`),
#   `a b - c d` is fma(a, b, -(c d)), `s - a b` is fma(-a, b, s); the GN
#   step's translation, whose operands are negated, the fma chain from the
#   first product (`xla_math.mv3`) in rows 0 and 2, `_sum3` in row 1;
# - XLA rewrites a division by a constant as a product with its float32
#   reciprocal, `(a / b) / c` as `a / (b c)` and `sqrt(d) sqrt(d)` as `d`;
#   a constant divided by a tensor is a true division (`_over`);
# - the 29 moment sums are XLA's tree reduction (`_tree_sum`).
# ---------------------------------------------------------------------------


def _fma(a, b, c) -> torch.Tensor:
    """RN(a b + c) in float32 (scalars become tensors like `a`)."""
    ref = next(x for x in (a, b, c) if isinstance(x, torch.Tensor))
    a, b, c = (x if isinstance(x, torch.Tensor) else ref.new_tensor(x) for x in (a, b, c))
    return xm.fma32(a, b, c)


def _over(c: float, x: torch.Tensor) -> torch.Tensor:
    """c / x rounded once, as XLA divides: torch's `c / x` of a Python
    number multiplies by x's reciprocal, two roundings that part by an ulp
    (the Huber weights of K4, K6 and K7's plain versions did)."""
    return torch.full_like(x, c) / x


def _sum3(a0, b0, a1, b1, a2, b2) -> torch.Tensor:
    """a0 b0 + a1 b1 + a2 b2 as XLA's CPU code contracts it."""
    return _fma(a2, b2, _fma(a0, b0, a1 * b1))


def _mm3k(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """3x3 @ 3x3, each entry `_sum3` along k."""
    return torch.stack([torch.stack([_sum3(A[r, 0], B[0, c], A[r, 1], B[1, c], A[r, 2], B[2, c])
                                     for c in range(3)]) for r in range(3)])


def _mv3k(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """3x3 @ 3, each entry `_sum3` along k."""
    return torch.stack([_sum3(M[r, 0], v[0], M[r, 1], v[1], M[r, 2], v[2]) for r in range(3)])


def _adjugate_k(X: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """X^-T of a 3x3 by its cofactors over the determinant, contracted as
    XLA's CPU code computes them; returns (X^-T, det)."""
    a, b, c = X[0, 0], X[0, 1], X[0, 2]
    d, e, f = X[1, 0], X[1, 1], X[1, 2]
    g, h, i = X[2, 0], X[2, 1], X[2, 2]

    def m(p, q, r, s):
        return _fma(p, q, -(r * s))

    A, B, C = m(e, i, f, h), m(f, g, d, i), m(d, h, e, g)
    cof = torch.stack([A, B, C, m(c, h, b, i), m(a, i, c, g), m(b, g, a, h),
                       m(b, f, c, e), m(c, d, a, f), m(a, e, b, d)]).reshape(3, 3)
    det = _fma(c, C, _fma(a, A, b * B))
    return cof / det, det


def _chol6_solve(A, b) -> list[torch.Tensor]:
    """Solve (6x6 SPD) A x = b by fully unrolled scalar Cholesky, pivots
    floored at sqrt(1e-12); `A` indexable as A[i][j], `b` as b[i]; returns
    6 scalars. The last unknown is its numerator over the last pivot's
    radicand, as XLA rewrites (y5 / L55) / L55."""
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            s = A[i][j]
            for k in range(j):
                s = _fma(-L[i][k], L[j][k], s)
            if i == j:
                radicand = torch.clamp(s, min=1e-12)
                L[i][j] = xm.sqrtf(radicand)
            else:
                L[i][j] = s / L[j][j]
    y = [None] * 6
    for i in range(6):  # forward substitution L y = b
        s = b[i]
        for k in range(i):
            s = _fma(-L[i][k], y[k], s)
        y[i] = s / L[i][i]
    y5_num = s
    x = [None] * 6
    for i in reversed(range(6)):  # back substitution L^T x = y
        s = y[i]
        for k in range(i + 1, 6):
            s = _fma(-L[k][i], x[k], s)
        x[i] = y5_num / radicand if i == 5 else s / L[i][i]
    return x


def _recip32(d: float) -> float:
    """The float32 reciprocal of a float32 constant, as XLA folds it."""
    return float(torch.tensor(1.0) / torch.tensor(d))


#: the three series' divisors, as their float32 reciprocals
_SERIES = {name: tuple(_recip32(d) for d in ds) for name, ds in
           {"A": (6.0, 20.0, 42.0), "B": (12.0, 30.0, 56.0), "C": (20.0, 42.0, 72.0)}.items()}
_SIXTH = float(torch.tensor(1.0 / 6.0))


def _taylor(t2: torch.Tensor, which: str) -> torch.Tensor:
    """1 - t2 / d0 (1 - t2 / d1 (1 - t2 / d2)) of series `which`, each
    division by a constant a product with its float32 reciprocal."""
    r0, r1, r2 = _SERIES[which]
    x = _fma(-t2, r2, 1.0)
    x = _fma(-(t2 * r1), x, 1.0)
    return _fma(-(t2 * r0), x, 1.0)


def _se3_exp_taylor(rho: torch.Tensor, phi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """exp([phi]x, rho) -> (R, t) via nested 4-term Taylor series of
    A = sin(th)/th, B = (1-cos th)/th^2, C = (1-A)/th^2 (relative truncation
    error < 1e-6 for |th| < 0.5 rad, far beyond any sane GN step)."""
    t2 = _sum3(phi[0], phi[0], phi[1], phi[1], phi[2], phi[2])
    A = _taylor(t2, "A")
    B = 0.5 * _taylor(t2, "B")
    C = _SIXTH * _taylor(t2, "C")
    wx, wy, wz = phi[0], phi[1], phi[2]
    zero = 0.0 * wx
    K = torch.stack(
        [torch.stack([zero, -wz, wy]), torch.stack([wz, zero, -wx]), torch.stack([-wy, wx, zero])]
    )
    K2 = _mm3k(K, K)
    eye = torch.eye(3, dtype=torch.float32, device=phi.device)
    R = _fma(B, K2, _fma(A, K, eye))
    V = _fma(C, K2, _fma(B, K, eye))
    # t = V rho as the interpreted kernels' scalar code contracts it: rows 0
    # and 2 the fma chain from the first product, row 1 `_sum3` (read off
    # the kernels' outputs at 256 and 2048 source rows; no input tried
    # tells row 2's two forms apart)
    t = xm.mv3(V, rho)
    t1 = _sum3(V[1, 0], rho[0], V[1, 1], rho[1], V[1, 2], rho[2])
    return R, torch.stack([t[0], t1, t[2]])


def _polar_polish(R: torch.Tensor) -> torch.Tensor:
    """One Newton-polar step X <- (X + X^-T)/2: restores orthogonality of a
    nearly-orthogonal matrix to ~machine precision."""
    R_invT, _ = _adjugate_k(R)
    return 0.5 * (R + R_invT)


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """x (C, A, B) summed over A and B as XLA's CPU code sums it: while a
    reduced dimension exceeds 32, a reduce-window of min(dim, 32) strided
    elements (SAME padding, the padding skipped), each window summed in
    order from 0 (rows outer, lanes inner); then the rest in order."""
    W = _REDUCE_WINDOW
    while x.shape[1] > W or x.shape[2] > W:
        C, A, B = x.shape
        wa, wb = min(A, W), min(B, W)
        oa, ob = -(-A // wa), -(-B // wb)
        pa, pb = oa * wa - A, ob * wb - B
        # zero padding: skipped by XLA, added here as +0.0, which changes
        # only the sign of a -0.0 sum
        xp = torch.nn.functional.pad(x, (pb // 2, pb - pb // 2, pa // 2, pa - pa // 2))
        xw = xp.reshape(C, oa, wa, ob, wb).permute(0, 1, 3, 2, 4).reshape(C, oa, ob, wa * wb)
        acc = torch.zeros((C, oa, ob), dtype=x.dtype, device=x.device)
        for k in range(wa * wb):
            acc = acc + xw[..., k]
        x = acc
    flat = x.reshape(x.shape[0], -1)
    acc = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for k in range(flat.shape[1]):
        acc = acc + flat[:, k]
    return acc


def _gn_moments_plain(src_pages, R, t, d2, qn, config: PointToPlaneConfig) -> torch.Tensor:
    """The 29 moments of one GN pass at (R, t) on the matched set (d2
    (nSt, 1, TM), qn (nSt, 6, TM)), XLA's tree reduction of the stacked
    (29, nSt, TM) planes."""
    sx, sy, sz = src_pages[:, 0], src_pages[:, 1], src_pages[:, 2]
    px, py, pz = (_sum3(R[a, 0], sx, R[a, 1], sy, R[a, 2], sz) + t[a] for a in range(3))
    qx, qy, qz = qn[:, 0], qn[:, 1], qn[:, 2]
    nx, ny, nz = qn[:, 3], qn[:, 4], qn[:, 5]
    # invalid normals are stored as 0-vectors -> |n|^2 < 0.5
    w_in = (
        (d2[:, 0] < config.max_correspondence_dist_sq)
        & (_sum3(nx, nx, ny, ny, nz, nz) > 0.5)
    ).float()
    r = _sum3(nx, px - qx, ny, py - qy, nz, pz - qz)
    w = w_in * torch.clamp(_over(config.huber_delta, torch.clamp(r.abs(), min=1e-12)), max=1.0)
    # J = [n, p' x n]
    J = (nx, ny, nz, _fma(py, nz, -(pz * ny)), _fma(pz, nx, -(px * nz)),
         _fma(px, ny, -(py * nx)))
    wJ = [w * J[a] for a in range(6)]
    planes = (
        [wJ[a] * J[b] for a in range(6) for b in range(a + 1)]
        + [wJ[a] * r for a in range(6)]
        + [w_in, w_in * r * r]
    )
    return _tree_sum(torch.stack(planes))  # (29,)


#: lanes of the diagonal in the row-major lower triangle
_DIAG_LANES = [a * (a + 1) // 2 + a for a in range(6)]


@functools.lru_cache(maxsize=None)
def _tri_lanes(device: torch.device) -> torch.Tensor:
    """(6, 6) lane of entry (a, b) in the row-major lower triangle, uploaded
    once per device (an index made inside a frame would wait for the
    device)."""
    lanes = [[max(a, b) * (max(a, b) + 1) // 2 + min(a, b) for b in range(6)] for a in range(6)]
    return torch.tensor(lanes, device=device)


def _jtj_from_tri(tri: torch.Tensor) -> torch.Tensor:
    """Symmetric (6, 6) from its 21 lower-triangle entries."""
    return tri[_tri_lanes(tri.device)]


def _damped(tot: torch.Tensor, config: PointToPlaneConfig) -> torch.Tensor:
    """The 21 JtJ lanes of the moments with the damping on the diagonal
    (added after the reduction)."""
    damp = torch.zeros(21, dtype=torch.float32, device=tot.device)
    damp[_DIAG_LANES] = config.damping
    return tot[:21] + damp


def _gn_passes_plain(R, t, src_pages, matched, config: PointToPlaneConfig):
    """The GN iterations from (R, t), then the trailing stats pass.
    `matched(R, t)` gives the matched set (d2, qn) of a pass: a fresh
    association, or the set held fixed. Returns (R, t, the stats pass's 29
    UNDAMPED moments)."""
    for _ in range(config.num_iterations):
        tot = _gn_moments_plain(src_pages, R, t, *matched(R, t), config)
        x = torch.stack(_chol6_solve(_jtj_from_tri(_damped(tot, config)), tot[21:27]))
        # a starved frame must not step
        step = -x * (tot[27] >= 3.0).float()
        R_step, t_step = _se3_exp_taylor(step[:3], step[3:])
        R_step = _polar_polish(R_step)
        R, t = _mm3k(R_step, R), _mv3k(R_step, t) + t_step
    return R, t, _gn_moments_plain(src_pages, R, t, *matched(R, t), config)


def _gn_drive_plain(T0, src_pages, matched, config: PointToPlaneConfig):
    """The GN iterations + the trailing stats pass + output packing.
    Returns (T_out (4, 4), stats (1, 128) = [rmse, W, iters, 21 damped JtJ,
    wr2, 0...])."""
    dev = src_pages.device
    R, t, tot = _gn_passes_plain(T0[:3, :3], T0[:3, 3], src_pages, matched, config)
    tri, W, wr2 = _damped(tot, config), tot[27], tot[28]
    rmse = xm.sqrtf(wr2 / torch.clamp(W, min=1.0))
    stats = torch.zeros((1, 128), dtype=torch.float32, device=dev)
    stats[0, 0] = rmse
    stats[0, 1] = W
    stats[0, 2] = config.num_iterations
    stats[0, 3:24] = tri
    stats[0, 24] = wr2
    return geometry.make_T(R, t), stats


# ---------------------------------------------------------------------------
# K4, K5, K6: plain versions and kernel wrappers
# ---------------------------------------------------------------------------


def _p2p_associate_plain(src_pages, tgt_pages, pair_start, pair_cnt, pair_tgt, T0_rebased):
    """K5 as plain PyTorch; same arguments and outputs as `_p2p_associate`."""
    d2, qn = _associate_first(
        src_pages, T0_rebased[:3, :3], T0_rebased[:3, 3],
        pair_start.tolist(), pair_cnt.tolist(), pair_tgt, tgt_pages,
    )
    return d2[:, None, :], qn


def _p2p_gn_corr_plain(T0_rebased, src_pages, best_d2, best_qn, config: PointToPlaneConfig):
    """K6 as plain PyTorch; same arguments and outputs as `_p2p_gn_corr`."""
    return _gn_drive_plain(T0_rebased, src_pages, lambda R, t: (best_d2, best_qn), config)


def _p2p_core_plain(
    src_pages, tgt_pages, pair_start, pair_cnt, pair_tgt, T0_rebased,
    config: PointToPlaneConfig,
):
    """K4 as plain PyTorch; same arguments and outputs as `_p2p_core`: with
    fixed correspondences K5's plain version then K6's, else K6's loop with
    a fresh association in every pass."""
    if config.fixed_correspondences:
        d2, qn = _p2p_associate_plain(
            src_pages, tgt_pages, pair_start, pair_cnt, pair_tgt, T0_rebased
        )
        return _p2p_gn_corr_plain(T0_rebased, src_pages, d2, qn, config)
    start, cnt = pair_start.tolist(), pair_cnt.tolist()

    def fresh(R, t):
        d2, qn = _associate_first(src_pages, R, t, start, cnt, pair_tgt, tgt_pages)
        return d2[:, None, :], qn

    return _gn_drive_plain(T0_rebased, src_pages, fresh, config)


class _P2PParams(ctypes.Structure):
    """Mirrors `struct P2PParams` in csrc/p2p_fused.cu."""

    _fields_ = [
        ("gate", ctypes.c_float),
        ("huber_delta", ctypes.c_float),
        ("damping", ctypes.c_float),
        ("num_iterations", ctypes.c_int),
        ("fixed", ctypes.c_int),
    ]


def _params(config: PointToPlaneConfig) -> _P2PParams:
    return _P2PParams(
        gate=config.max_correspondence_dist_sq,
        huber_delta=config.huber_delta,
        damping=config.damping,
        num_iterations=config.num_iterations,
        fixed=int(config.fixed_correspondences),
    )


def _check(what: str, dev: torch.device, specs, TM: int) -> bool:
    """Validate a wrapper's tensors (a kernel reads raw pointers); True when
    the kernel is to be launched, False for CPU tensors."""
    for x, name, dtype, shape in specs:
        cuda_lib.require(x, name, dtype, shape, dev)
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    cuda_lib.check_tile_src(what, TM)
    return True


def _pair_specs(src_pages, tgt_pages, pair_start, pair_cnt, pair_tgt, T0_rebased):
    nSt, _, TM = src_pages.shape
    nTt, _, TN = tgt_pages.shape
    f32, i32 = torch.float32, torch.int32
    return [
        (src_pages, "src_pages", f32, (nSt, 3, TM)),
        (tgt_pages, "tgt_pages", f32, (nTt, 6, TN)),
        (pair_start, "pair_start", i32, (nSt,)),
        (pair_cnt, "pair_cnt", i32, (nSt,)),
        (pair_tgt, "pair_tgt", i32, (pair_tgt.shape[0],)),
        (T0_rebased, "T0_rebased", f32, (4, 4)),
    ]


def _p2p_core(
    src_pages: torch.Tensor,  # (nSt, 3, TM) sensor frame, +1e7 sentinels
    tgt_pages: torch.Tensor,  # (nTt, 6, TN) rebased xyz (-1e7), normals (0 invalid)
    pair_start: torch.Tensor,  # (nSt,) int32 offsets into pair_tgt
    pair_cnt: torch.Tensor,  # (nSt,) int32 admitted target tiles
    pair_tgt: torch.Tensor,  # (max_pairs,) int32 flat row-major target tiles
    T0_rebased: torch.Tensor,  # (4, 4) prior, rebased frame
    config: PointToPlaneConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One whole point-to-plane registration (K4): (T_out (4, 4) in the
    rebased frame, stats (1, 128) = [rmse, n_correspondences, iterations,
    21 damped JtJ entries (row-major lower triangle), wr2, 0...]). CPU
    tensors run the plain version; CUDA tensors launch the kernel or
    raise."""
    dev = src_pages.device
    nSt, _, TM = src_pages.shape
    TN = tgt_pages.shape[2]
    specs = _pair_specs(src_pages, tgt_pages, pair_start, pair_cnt, pair_tgt, T0_rebased)
    if not _check("_p2p_core", dev, specs, TM):
        return _p2p_core_plain(
            src_pages, tgt_pages, pair_start, pair_cnt, pair_tgt, T0_rebased, config
        )
    T_out = torch.empty((4, 4), dtype=torch.float32, device=dev)
    stats = torch.empty((1, 128), dtype=torch.float32, device=dev)
    # the matched set, 7 floats a point (224 KiB at 16 x 512): more than an
    # SM's shared memory, so it stays in a global buffer in L2, in K5's
    # output layout; each thread touches only its own points
    best_d2 = torch.empty((nSt, 1, TM), dtype=torch.float32, device=dev)
    best_qn = torch.empty((nSt, 6, TM), dtype=torch.float32, device=dev)
    # an association round's per-slot winners (best d2, winning row) from
    # the grid's workers, combined by the leader into best_d2 / best_qn
    max_pairs = pair_tgt.shape[0]
    slot_d2 = torch.empty((max_pairs, TM), dtype=torch.float32, device=dev)
    slot_row = torch.empty((max_pairs, TM), dtype=torch.int32, device=dev)
    ctl = cuda_lib.control_block(dev)
    prm = _params(config)
    err = cuda_lib.lib().sfk_p2p_fused(
        *[x.data_ptr() for x, *_ in specs],
        T_out.data_ptr(), stats.data_ptr(), best_d2.data_ptr(), best_qn.data_ptr(),
        slot_d2.data_ptr(), slot_row.data_ptr(), ctl.data_ptr(),
        nSt, TM, TN, ctypes.addressof(prm), cuda_lib.stream_ptr(src_pages),
    )
    cuda_lib.check(err, "_p2p_core")
    _p2p_core.launches += 1
    return T_out, stats


def _p2p_associate(
    src_pages, tgt_pages, pair_start, pair_cnt, pair_tgt, T0_rebased
) -> tuple[torch.Tensor, torch.Tensor]:
    """One association pass at the prior (K5): (best d2 (nSt, 1, TM),
    matched point + normal pages (nSt, 6, TM)), rebased frame. Arguments as
    `_p2p_core`. CPU tensors run the plain version; CUDA tensors launch the
    kernel or raise."""
    dev = src_pages.device
    nSt, _, TM = src_pages.shape
    TN = tgt_pages.shape[2]
    specs = _pair_specs(src_pages, tgt_pages, pair_start, pair_cnt, pair_tgt, T0_rebased)
    if not _check("_p2p_associate", dev, specs, TM):
        return _p2p_associate_plain(
            src_pages, tgt_pages, pair_start, pair_cnt, pair_tgt, T0_rebased
        )
    best_d2 = torch.empty((nSt, 1, TM), dtype=torch.float32, device=dev)
    best_qn = torch.empty((nSt, 6, TM), dtype=torch.float32, device=dev)
    # the scan's per-slot winners (best d2, first winning row), combined in
    # slot order into best_d2 / best_qn by the second launch
    max_pairs = pair_tgt.shape[0]
    slot_d2 = torch.empty((max_pairs, TM), dtype=torch.float32, device=dev)
    slot_row = torch.empty((max_pairs, TM), dtype=torch.int32, device=dev)
    err = cuda_lib.lib().sfk_p2p_associate(
        *[x.data_ptr() for x, *_ in specs],
        best_d2.data_ptr(), best_qn.data_ptr(), slot_d2.data_ptr(), slot_row.data_ptr(),
        nSt, TM, TN, max_pairs, cuda_lib.stream_ptr(src_pages),
    )
    cuda_lib.check(err, "_p2p_associate")
    _p2p_associate.launches += 1
    return best_d2, best_qn


def _p2p_gn_corr(
    T0_rebased: torch.Tensor,  # (4, 4) prior, rebased frame
    src_pages: torch.Tensor,  # (nSt, 3, TM)
    best_d2: torch.Tensor,  # (nSt, 1, TM)
    best_qn: torch.Tensor,  # (nSt, 6, TM)
    config: PointToPlaneConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed-correspondence GN on a given matched set (K6): outputs as
    `_p2p_core`. CPU tensors run the plain version; CUDA tensors launch the
    kernel or raise."""
    dev = src_pages.device
    nSt, _, TM = src_pages.shape
    f32 = torch.float32
    specs = [
        (T0_rebased, "T0_rebased", f32, (4, 4)),
        (src_pages, "src_pages", f32, (nSt, 3, TM)),
        (best_d2, "best_d2", f32, (nSt, 1, TM)),
        (best_qn, "best_qn", f32, (nSt, 6, TM)),
    ]
    if not _check("_p2p_gn_corr", dev, specs, TM):
        return _p2p_gn_corr_plain(T0_rebased, src_pages, best_d2, best_qn, config)
    T_out = torch.empty((4, 4), dtype=f32, device=dev)
    stats = torch.empty((1, 128), dtype=f32, device=dev)
    prm = _params(config)
    err = cuda_lib.lib().sfk_p2p_gn_corr(
        *[x.data_ptr() for x, *_ in specs], T_out.data_ptr(), stats.data_ptr(),
        nSt, TM, ctypes.addressof(prm), cuda_lib.stream_ptr(src_pages),
    )
    cuda_lib.check(err, "_p2p_gn_corr")
    _p2p_gn_corr.launches += 1
    return T_out, stats


#: kernel launches made by each wrapper (CUDA tensors only)
_p2p_core.launches = 0
_p2p_associate.launches = 0
_p2p_gn_corr.launches = 0


def kernel_grid(n_src_tiles: int, tile_src: int) -> dict:
    """K4's cooperative grid on the current card for these tiles: blocks,
    threads a block and the blocks a multiprocessor could hold."""
    return cuda_lib.grid_shape(cuda_lib.lib().sfk_p2p_grid, n_src_tiles, tile_src)


def assoc_grid(tile_src: int, max_pairs: int) -> dict:
    """K5's scan grid on the current card for a list of `max_pairs` slots:
    blocks, threads a block and the blocks a multiprocessor could hold."""
    return cuda_lib.grid_shape(cuda_lib.lib().sfk_p2p_assoc_grid, tile_src, max_pairs)


def gn_cluster(n_src_tiles: int, tile_src: int) -> dict:
    """K6's thread-block cluster on the current card for these tiles: CTAs,
    threads a CTA and the shared memory (bytes) a CTA stages the matched
    set in (0: read from global memory each pass)."""
    return cuda_lib.grid_shape(cuda_lib.lib().sfk_p2p_gn_cluster, n_src_tiles, tile_src,
                               keys=("ctas", "threads", "smem_bytes"))


# ---------------------------------------------------------------------------
# hosts
# ---------------------------------------------------------------------------


class CachedP2PTarget(NamedTuple):
    """Target-side structures reused across frames until the anchor
    refreshes (the LIO ring's Morton re-sort + normal re-estimation)."""

    pages: torch.Tensor  # (nTt, 6, TN) xyz rebased by `center` + normals
    lo: torch.Tensor  # (nTt, 3) tile bbox minima (original frame)
    hi: torch.Tensor
    center: torch.Tensor  # (3,)
    #: optional FINE gating sub-boxes (nTt * qt, 3), row-major per tile
    #: (ops/nn_gated.subtile_pair_dist2)
    sub_lo: torch.Tensor | None = None
    sub_hi: torch.Tensor | None = None


def build_cached_p2p_target(
    target: torch.Tensor,
    target_mask: torch.Tensor,
    normals: torch.Tensor,
    normals_valid: torch.Tensor,
    center: torch.Tensor,
    tile_tgt: int,
    gate_sub: int | None = None,
) -> CachedP2PTarget:
    """Pack xyz+normal 6-row pages and per-tile bboxes once per anchor.

    `gate_sub` (points per gating sub-box, divides tile_tgt) additionally
    stores fine sub-boxes for sub-tile pair culling."""
    xyz_pages = make_pages(target, target_mask, center, tile_tgt, sentinel=TARGET_SENTINEL)
    n_safe = torch.where((target_mask & normals_valid)[:, None], normals.float(), 0.0)
    n = target.shape[0]
    nrm_pages = n_safe.reshape(n // tile_tgt, tile_tgt, 3).transpose(1, 2)
    pages = torch.cat([xyz_pages, nrm_pages], dim=1).contiguous()  # (nTt, 6, TN)
    lo, hi, _ = tile_bboxes(target, target_mask, tile_tgt)
    sub_lo = sub_hi = None
    if gate_sub is not None:
        sub_lo, sub_hi, _ = tile_bboxes(target, target_mask, gate_sub)
    return CachedP2PTarget(
        pages=pages, lo=lo, hi=hi, center=center.contiguous(), sub_lo=sub_lo, sub_hi=sub_hi
    )


def p2p_inputs(
    source: torch.Tensor,
    source_mask: torch.Tensor,
    cached: CachedP2PTarget,
    initial_T: torch.Tensor,
    config: PointToPlaneConfig,
) -> tuple[tuple, torch.Tensor, torch.Tensor]:
    """The per-call prologue of `point_to_plane_align_fused` and
    `associate_p2p_fused`: (the kernels' arguments (src_pages, tgt_pages,
    pair_start, pair_cnt, pair_tgt, T0_rebased), the shift back out of the
    rebased frame, pair demand () int32: the admissible tile pairs before
    the list's capacity clips them).

    The pair list is built ONCE at the prior with `reassoc_margin`
    dilation and holds `max_pairs_factor` pairs a source tile; what does
    not fit is dropped nearest-first per tile and not reported, as in the
    JAX package."""
    TM = config.tile_src
    nSt = source.shape[0] // TM
    search_r2 = (math.sqrt(config.max_correspondence_dist_sq) + config.reassoc_margin) ** 2
    pts0 = geometry.transform_points(initial_T, source)
    lo_s, hi_s, cnt_s = tile_bboxes(pts0, source_mask, TM)
    visits, counts, _ = pair_tiles(
        lo_s, hi_s, cnt_s, cached.lo, cached.hi, search_r2, config.max_visits
    )
    pairs = _build_tile_pair_list(visits, counts, nSt * config.max_pairs_factor)
    # SOURCE pages stay unrebased: the kernel applies the whole current
    # transform, and the rebase enters through T0
    src_pages = make_pages(source, source_mask, cached.center * 0, TM, sentinel=SOURCE_SENTINEL)
    shift, unshift = _shifts(cached.center)
    core = (src_pages, cached.pages, *pairs, unshift @ initial_T)
    return core, shift, counts.sum(dtype=torch.int32)


def _result_from_kernel_outputs(
    T_out: torch.Tensor, stats: torch.Tensor, shift: torch.Tensor
) -> PointToPlaneResult:
    """Rebuild the (damped) JtJ of the final stats pass from the 21 packed
    lower-triangle lanes; the GN ran in the REBASED frame, so the
    covariance mapping uses the PRE-shift transform."""
    return PointToPlaneResult(
        transformation=shift @ T_out,
        rmse=stats[0, 0],
        n_correspondences=stats[0, 1].to(torch.int32),
        cov_pose=pose_covariance_from_jtj(_jtj_from_tri(stats[0, 3:24]), T_out),
        wr2=stats[0, 24],
    )


def point_to_plane_align_fused(
    source: torch.Tensor,
    source_mask: torch.Tensor,
    cached: CachedP2PTarget,
    initial_T: torch.Tensor,
    config: PointToPlaneConfig = PointToPlaneConfig(),
) -> PointToPlaneResult:
    """Whole-GN point-to-plane registration in one K4 launch.

    Semantics match `point_to_plane_align` (fixed iteration count, Huber
    weights, damped 6x6 solve, trailing stats pass; fresh correspondences
    per iteration unless `fixed_correspondences`)."""
    core, shift, _ = p2p_inputs(source, source_mask, cached, initial_T, config)
    T_out, stats = _p2p_core(*core, config)
    return _result_from_kernel_outputs(T_out, stats, shift)


def associate_p2p_fused(
    source: torch.Tensor,
    source_mask: torch.Tensor,
    cached: CachedP2PTarget,
    initial_T: torch.Tensor,
    config: PointToPlaneConfig = PointToPlaneConfig(),
) -> tuple[torch.Tensor, torch.Tensor]:
    """One association pass at `initial_T` against the cached target (K5).

    Returns (best_d2 (nSt, 1, TM), best_qn (nSt, 6, TM)): squared distances
    and matched point+normal pages in the frame REBASED by `cached.center`.
    Same prologue and association as `point_to_plane_align_fused`; winners
    from disjoint targets can be min-combined elementwise (map sharding)."""
    core, _, _ = p2p_inputs(source, source_mask, cached, initial_T, config)
    return _p2p_associate(*core)


def p2p_gn_from_correspondences(
    source: torch.Tensor,
    source_mask: torch.Tensor,
    best_d2: torch.Tensor,
    best_qn: torch.Tensor,
    initial_T: torch.Tensor,
    center: torch.Tensor,
    config: PointToPlaneConfig = PointToPlaneConfig(),
) -> PointToPlaneResult:
    """Fixed-correspondence GN on a precomputed matched set (K6).

    `best_d2`/`best_qn` are association winners in the frame rebased by
    `center` (from `associate_p2p_fused`, possibly min-combined across map
    shards). Equals `point_to_plane_align_fused` with
    `fixed_correspondences=True` whose association produced the same
    winners."""
    src_pages = make_pages(
        source, source_mask, center * 0, config.tile_src, sentinel=SOURCE_SENTINEL
    )
    shift, unshift = _shifts(center)
    T_out, stats = _p2p_gn_corr(unshift @ initial_T, src_pages, best_d2, best_qn, config)
    return _result_from_kernel_outputs(T_out, stats, shift)
