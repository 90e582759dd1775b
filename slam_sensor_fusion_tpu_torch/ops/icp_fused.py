"""Whole-ICP fused kernel K3, its plain version and its hosts (port of the
JAX `ops/icp_fused.py`), plus the cached ICP target and the 3x3 solver
helpers K1 shares.

One K3 launch runs a WHOLE point-to-point ICP on prebuilt pages and a
tile-major pair list (ops/nn_pallas._build_tile_pair_list):

  per iteration:
    1. associate: per source tile, direct (t - s)^2 distances to each
       admitted target tile under the CURRENT (R, t); the FIRST row wins
       exact ties within a tile, a strict `<` keeps the earlier tile;
    2. reduce: the gated Kabsch moments (W, sum s, sum t, sum s t^T,
       sum |s' - t|);
    3. solve: a Kabsch step by Newton polar (no SVD).

Two variants: fresh (`lazy=False`, the native fast mode) re-associates
every iteration; lazy (`lazy=True`, the reference's exact control flow,
icp_point_to_point.cpp:185-254) associates once at the prior, lets the
alive set only shrink, and re-associates only on an error plateau that is
not a hit.

`_fused_core` launches the CUDA kernel (csrc/icp_fused.cu, a cooperative
grid of one block on each SM) for tensors on the card and runs
`_fused_core_plain` for CPU tensors. `icp_align_fused`
(per-frame fast mode, the lite pipeline) builds the pages and the pair
list around one launch; `icp_align_fused_paged` takes host-paged frames
(the per-frame branch of models/pipeline_fast).

The 3x3 helpers are the plain twins of the device functions in
csrc/icp_fused.cuh, written as the same scalar expressions in the same
operand order.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from slam_sensor_fusion_tpu_torch.ops import cuda_lib
from slam_sensor_fusion_tpu_torch.ops import geometry
from slam_sensor_fusion_tpu_torch.ops.icp import ICPResult, _icp_xla
from slam_sensor_fusion_tpu_torch.ops.morton import tile_bboxes
from slam_sensor_fusion_tpu_torch.ops.nn_gated import pair_tiles
from slam_sensor_fusion_tpu_torch.ops.nn_pallas import (
    _build_tile_pair_list,
    _tile_chunk,
    make_pages,
)
from slam_sensor_fusion_tpu_torch.utils.config import ICPConfig

_BIG = 3.0e38
#: source pages' sentinel for invalid points
SOURCE_SENTINEL = 1.0e7
#: target pages' sentinel: the opposite of the source pages' +1e7, so two
#: invalid points never match at distance zero
TARGET_SENTINEL = -1.0e7


class CachedTarget(NamedTuple):
    """Target-side structures, valid until the map re-crops."""

    pages: torch.Tensor  # (nTt, 3, TN) rebased by `center`, -1e7 sentinels
    lo: torch.Tensor  # (nTt, 3) tile bbox minima (original frame)
    hi: torch.Tensor  # (nTt, 3)
    center: torch.Tensor  # (3,) the rebase point (crop pose translation)
    #: fine gating sub-boxes (nTt * q, 3), original frame (ops/nn_gated)
    sub_lo: torch.Tensor | None = None
    sub_hi: torch.Tensor | None = None


def build_cached_target(
    target: torch.Tensor,
    target_mask: torch.Tensor,
    center: torch.Tensor,
    tile_tgt: int,
    gate_sub: int | None = None,
) -> CachedTarget:
    pages = make_pages(target, target_mask, center, tile_tgt, sentinel=TARGET_SENTINEL)
    lo, hi, _ = tile_bboxes(target, target_mask, tile_tgt)
    sub_lo = sub_hi = None
    if gate_sub is not None:
        sub_lo, sub_hi, _ = tile_bboxes(target, target_mask, gate_sub)
    return CachedTarget(
        pages=pages, lo=lo, hi=hi, center=center.contiguous(),
        sub_lo=sub_lo, sub_hi=sub_hi,
    )


# ---------------------------------------------------------------------------
# 3x3 helpers (plain twins of csrc/icp_fused.cuh)
# ---------------------------------------------------------------------------


def _adjugate_transpose_over_det(X: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """X^{-T} for 3x3 via the adjugate; returns (X^{-T}, det)."""
    a, b, c = X[0, 0], X[0, 1], X[0, 2]
    d, e, f = X[1, 0], X[1, 1], X[1, 2]
    g, h, i = X[2, 0], X[2, 1], X[2, 2]
    A = e * i - f * h
    B = f * g - d * i
    C = d * h - e * g
    D = c * h - b * i
    E = a * i - c * g
    F = b * g - a * h
    G = b * f - c * e
    H = c * d - a * f
    I = a * e - b * d
    det = a * A + b * B + c * C
    cof = torch.stack([A, B, C, D, E, F, G, H, I]).reshape(3, 3)
    return cof / det, det


def _mv3(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """3x3 @ 3 as scalar sums in a fixed order."""
    return torch.stack(
        [M[r, 0] * v[0] + M[r, 1] * v[1] + M[r, 2] * v[2] for r in range(3)]
    )


def _mm3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """3x3 @ 3x3 as scalar sums in a fixed order."""
    return torch.stack(
        [
            torch.stack(
                [A[r, 0] * B[0, c] + A[r, 1] * B[1, c] + A[r, 2] * B[2, c] for c in range(3)]
            )
            for r in range(3)
        ]
    )


def _newton_polar(H: torch.Tensor, steps: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """Orthogonal polar factor of a 3x3 matrix by Newton iteration.

    Returns (R, ok): ok is False for a (near-)singular H, where Newton
    diverges (all correspondences on a plane or line) and callers must
    skip the step."""
    ss = H.new_zeros(())
    for m in range(9):
        ss = ss + H.reshape(9)[m] * H.reshape(9)[m]
    X = H / torch.sqrt(torch.clamp(ss, min=1e-20))
    _, det0 = _adjugate_transpose_over_det(X)
    ok = det0.abs() > 1e-6
    for _ in range(steps):
        X_invT, det = _adjugate_transpose_over_det(X)
        X = torch.where(det.abs() > 1e-12, 0.5 * (X + X_invT), X)
    return X, ok & torch.isfinite(X).all()


def _sum_all(x2d: torch.Tensor) -> torch.Tensor:
    """Full reduction of a 2-D array as staged axis sums (rows, then the
    column of row sums), the JAX package's order."""
    return x2d.sum(dim=1, keepdim=True).sum(dim=0)[0]


# ---------------------------------------------------------------------------
# plain ICP (K3's plain version; K1's runs the same loop per frame)
# ---------------------------------------------------------------------------


def _associate_first(src, R, t, start, cnt, pair_tgt, tgt_pages):
    """K3's tile-major association: per source tile, direct (t - s)^2
    distances to each admitted target tile; within a tile the FIRST row of
    an exact d2 tie wins (icp_fused.py:205-214), across tiles a strict `<`
    keeps the earlier tile. Returns best d2 (nSt, TM) and the winner's
    page rows (nSt, rows, TM): its coordinates, and for K4's 6-row pages
    (ops/p2p_fused.py) its normal; a tile with no admitted pair gets zeros."""
    nSt, _, TM = src.shape
    rows, TN = tgt_pages.shape[1], tgt_pages.shape[2]
    dev = src.device
    chunk = _tile_chunk(TN, TM)
    cols = torch.arange(TM, device=dev)
    best_all, xyz_all = [], []
    for i in range(nSt):
        px, py, pz = src[i, 0], src[i, 1], src[i, 2]
        sx = R[0, 0] * px + R[0, 1] * py + R[0, 2] * pz + t[0]
        sy = R[1, 0] * px + R[1, 1] * py + R[1, 2] * pz + t[1]
        sz = R[2, 0] * px + R[2, 1] * py + R[2, 2] * pz + t[2]
        best = torch.full((TM,), _BIG, dtype=torch.float32, device=dev)
        bxyz = torch.zeros((rows, TM), dtype=torch.float32, device=dev)
        for c0 in range(0, cnt[i], chunk):
            js = pair_tgt[start[i] + c0 : start[i] + min(cnt[i], c0 + chunk)].long()
            tt = tgt_pages[js]  # (C, rows, TN)
            dx = tt[:, 0, :, None] - sx
            dy = tt[:, 1, :, None] - sy
            dz = tt[:, 2, :, None] - sz
            d2 = dx * dx + dy * dy + dz * dz  # (C, TN, TM)
            tile_min, arg = d2.min(dim=1)  # first row on ties
            cmin, carg = tile_min.min(dim=0)  # first tile on ties
            better = cmin < best
            best = torch.where(better, cmin, best)
            win = tt[carg, :, arg[carg, cols]].T  # (rows, TM)
            bxyz = torch.where(better[None], win, bxyz)
        best_all.append(best)
        xyz_all.append(bxyz)
    return torch.stack(best_all), torch.stack(xyz_all)


def _moments(src, R, t, txyz, w):
    """Gated Kabsch moments (W, Ss, St, Mst, Eabs) of the transformed
    source against the matched targets, weights w (nSt, TM)."""
    px, py, pz = src[:, 0], src[:, 1], src[:, 2]
    sp = [
        R[a, 0] * px + R[a, 1] * py + R[a, 2] * pz + t[a] for a in range(3)
    ]
    tb = [txyz[:, 0], txyz[:, 1], txyz[:, 2]]
    W = _sum_all(w)
    Ss = torch.stack([_sum_all(sp[a] * w) for a in range(3)])
    St = torch.stack([_sum_all(tb[a] * w) for a in range(3)])
    Mst = torch.stack(
        [torch.stack([_sum_all(sp[a] * w * tb[b]) for b in range(3)]) for a in range(3)]
    )
    dx, dy, dz = sp[0] - tb[0], sp[1] - tb[1], sp[2] - tb[2]
    Eabs = _sum_all(w * torch.sqrt(dx * dx + dy * dy + dz * dz))
    return W, Ss, St, Mst, Eabs


def _solve_step(W, Ss, St, Mst):
    """Kabsch step from the moments by Newton polar (icp_fused.py:285-295)."""
    Wc = torch.clamp(W, min=1.0)
    c_s = Ss / Wc
    c_t = St / Wc
    Hm = Mst - W * torch.outer(c_s, c_t)
    R_step, polar_ok = _newton_polar(Hm.T)
    _, detH = _adjugate_transpose_over_det(Hm)
    t_step = c_t - _mv3(R_step, c_s)
    return R_step, t_step, bool(polar_ok), detH


def _icp_plain(src, R, t, pairs, tgt_pages, icp: ICPConfig, lazy: bool, associate=_associate_first):
    """One ICP in the rebased frame with the JAX kernels' semantics for
    both variants. `pairs` = (pair_start, pair_cnt) as lists and the flat
    pair_tgt; `associate` is the kernel's tie rule. Returns (R, t, err,
    n_corr, iters, det_min). Adds the tile pairs each association visits to
    `_icp_plain.pairs_visited` (each pair is TM x TN distances)."""
    gate = icp.max_correspondence_dist_sq
    acc, eps = icp.acceptable_mean_error, icp.transformation_epsilon
    big = torch.tensor(_BIG, dtype=torch.float32, device=src.device)
    err_prev, det_min, iters = big, big, 0

    def assoc(R, t):
        _icp_plain.pairs_visited += sum(pairs[1])
        return associate(src, R, t, *pairs, tgt_pages)

    if lazy:
        d2, txyz = assoc(R, t)
        alive = (d2 < gate).float()
        n_corr = int(_sum_all(alive))
        live = n_corr >= icp.min_correspondences
    else:
        n_corr, live = 0, True
    for _ in range(icp.num_iterations):
        if not live:
            break
        if lazy:
            W, Ss, St, Mst, Eabs = _moments(src, R, t, txyz, alive)
            err = Eabs / torch.clamp(W, min=1.0)
            hit = bool(err < acc)
            if not hit and bool((err_prev - err).abs() < eps):
                # plateau: re-associate; the alive set only shrinks
                d2, txyz = assoc(R, t)
                alive = alive * (d2 < gate).float()
                W, Ss, St, Mst, _ = _moments(src, R, t, txyz, alive)
            R_step, t_step, ok, detH = _solve_step(W, Ss, St, Mst)
            stop = hit or not ok
        else:
            d2, txyz = assoc(R, t)
            w = (d2 < gate).float()
            W, Ss, St, Mst, Eabs = _moments(src, R, t, txyz, w)
            err = torch.where(
                W >= icp.min_correspondences, Eabs / torch.clamp(W, min=1.0), big
            )
            R_step, t_step, ok, detH = _solve_step(W, Ss, St, Mst)
            stop = bool(err < acc) or bool((err_prev - err).abs() < eps) or not ok
            n_corr = int(W)
        if not stop:
            R, t = _mm3(R_step, R), _mv3(R_step, t) + t_step
            iters += 1
        err_prev = err
        det_min = torch.minimum(det_min, detH)
        live = not stop
    return R, t, err_prev, n_corr, iters, det_min


#: tile pairs visited by the plain ICP's associations (for lower bounds)
_icp_plain.pairs_visited = 0


# ---------------------------------------------------------------------------
# K3: plain version and kernel wrapper
# ---------------------------------------------------------------------------


class _K3Params(ctypes.Structure):
    """Mirrors `struct K3Params` in csrc/icp_fused.cu."""

    _fields_ = [
        ("gate", ctypes.c_float),
        ("eps", ctypes.c_float),
        ("acc", ctypes.c_float),
        ("num_iterations", ctypes.c_int),
        ("min_corr", ctypes.c_int),
        ("lazy", ctypes.c_int),
    ]


def _pack_result(R, t, err, n_corr, iters, det_min, dev):
    """(T_out (4,4), stats (1,128) = [err, iters, n_corr, det_min, 0...])."""
    stats = torch.zeros((1, 128), dtype=torch.float32, device=dev)
    stats[0, 0] = err
    stats[0, 1] = iters
    stats[0, 2] = n_corr
    stats[0, 3] = det_min
    return geometry.make_T(R, t), stats


def _fused_core_plain(
    src_pages, tgt_pages, pair_start, pair_cnt, pair_tgt, T0_rebased,
    config: ICPConfig, lazy: bool = False,
):
    """K3 as plain PyTorch; same arguments and outputs as `_fused_core`."""
    R, t, err, n_corr, iters, det_min = _icp_plain(
        src_pages, T0_rebased[:3, :3], T0_rebased[:3, 3],
        (pair_start.tolist(), pair_cnt.tolist(), pair_tgt), tgt_pages, config, lazy,
    )
    return _pack_result(R, t, err, n_corr, iters, det_min, src_pages.device)


def _fused_core(
    src_pages: torch.Tensor,  # (nSt, 3, TM) rebased frame, +1e7 sentinels
    tgt_pages: torch.Tensor,  # (nTt, 3, TN) rebased frame, -1e7 sentinels
    pair_start: torch.Tensor,  # (nSt,) int32 offsets into pair_tgt
    pair_cnt: torch.Tensor,  # (nSt,) int32 admitted target tiles
    pair_tgt: torch.Tensor,  # (max_pairs,) int32 flat row-major target tiles
    T0_rebased: torch.Tensor,  # (4, 4) initial transform, rebased frame
    config: ICPConfig,
    lazy: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One whole ICP on prebuilt pages: (T_out (4,4) in the rebased frame,
    stats (1,128) = [mean error, iterations, n_correspondences, det_min,
    0...]). n_correspondences is the final gated count in fresh mode and the
    INITIAL alive count in lazy mode (icp_point_to_point.cpp). CPU tensors
    run the plain version; CUDA tensors launch K3 or raise."""
    dev = src_pages.device
    nSt, _, TM = src_pages.shape
    nTt, _, TN = tgt_pages.shape
    f32, i32 = torch.float32, torch.int32
    args = [
        (src_pages, "src_pages", f32, (nSt, 3, TM)),
        (tgt_pages, "tgt_pages", f32, (nTt, 3, TN)),
        (pair_start, "pair_start", i32, (nSt,)),
        (pair_cnt, "pair_cnt", i32, (nSt,)),
        (pair_tgt, "pair_tgt", i32, (pair_tgt.shape[0],)),
        (T0_rebased, "T0_rebased", f32, (4, 4)),
    ]
    for x, name, dtype, shape in args:
        cuda_lib.require(x, name, dtype, shape, dev)
    if dev.type == "cpu":
        return _fused_core_plain(
            src_pages, tgt_pages, pair_start, pair_cnt, pair_tgt, T0_rebased, config, lazy
        )
    if dev.type != "cuda":
        raise ValueError(f"_fused_core: unsupported device {dev}")
    cuda_lib.check_tile_src("_fused_core", TM)
    T_out = torch.empty((4, 4), dtype=f32, device=dev)
    stats = torch.empty((1, 128), dtype=f32, device=dev)
    # per-point scratch (matched x, y, z and the gate/alive weight): too big
    # for shared memory at 128 source tiles, it stays in L2
    scratch = torch.empty((nSt, TM, 4), dtype=f32, device=dev)
    # an association round's per-slot winners (the tile's best d2 and first
    # winning row), combined by the grid's leader
    max_pairs = pair_tgt.shape[0]
    slot_d2 = torch.empty((max_pairs, TM), dtype=f32, device=dev)
    slot_row = torch.empty((max_pairs, TM), dtype=i32, device=dev)
    ctl = cuda_lib.control_block(dev)
    prm = _K3Params(
        gate=config.max_correspondence_dist_sq,
        eps=config.transformation_epsilon,
        acc=config.acceptable_mean_error,
        num_iterations=config.num_iterations,
        min_corr=config.min_correspondences,
        lazy=int(lazy),
    )
    err = cuda_lib.lib().sfk_icp_fused(
        *[x.data_ptr() for x, *_ in args],
        T_out.data_ptr(), stats.data_ptr(), scratch.data_ptr(), slot_d2.data_ptr(),
        slot_row.data_ptr(), ctl.data_ptr(),
        nSt, TM, TN, ctypes.addressof(prm), cuda_lib.stream_ptr(src_pages),
    )
    cuda_lib.check(err, "_fused_core")
    _fused_core.launches += 1
    return T_out, stats


#: kernel launches made by `_fused_core` (CUDA tensors only)
_fused_core.launches = 0


def kernel_grid(n_src_tiles: int, tile_src: int) -> dict:
    """K3's cooperative grid on the current card for these tiles: blocks,
    threads a block and the blocks a multiprocessor could hold."""
    return cuda_lib.grid_shape(cuda_lib.lib().sfk_icp_grid, n_src_tiles, tile_src)


# ---------------------------------------------------------------------------
# hosts
# ---------------------------------------------------------------------------


def _shifts(center: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(shift, unshift): translations by +center and -center."""
    eye3 = torch.eye(3, dtype=torch.float32, device=center.device)
    return geometry.make_T(eye3, center), geometry.make_T(eye3, -center)


def _fused_result(
    T_out: torch.Tensor,
    stats: torch.Tensor,
    shift: torch.Tensor,
    initial_T: torch.Tensor,
    config: ICPConfig,
    pair_overflow: torch.Tensor,
) -> ICPResult:
    err = stats[0, 0]
    iters = stats[0, 1].to(torch.int32)
    n_corr = stats[0, 2].to(torch.int32)
    enough = n_corr >= config.min_correspondences
    return ICPResult(
        transformation=torch.where(enough, shift @ T_out, initial_T),
        error=torch.where(enough, err, 1e6),
        iterations=torch.where(enough, iters, 0),
        has_converged=enough & (err < config.acceptable_mean_error),
        n_correspondences=n_corr,
        pair_overflow=pair_overflow,
        det_min=stats[0, 3],
    )


def icp_align_fused_paged(
    src_pages: torch.Tensor,
    pair_start: torch.Tensor,
    pair_cnt: torch.Tensor,
    pair_tgt: torch.Tensor,
    initial_T: torch.Tensor,
    cached_target: CachedTarget,
    config: ICPConfig,
    pair_overflow: torch.Tensor | None = None,
    lazy: bool = False,
) -> ICPResult:
    """K3 on host-prebuilt source pages (sensor frame, +1e7 sentinels) and a
    precomputed pair list: the kernel plus result assembly. lazy=True runs
    the reference's exact lazy-re-association control flow."""
    shift, unshift = _shifts(cached_target.center)
    T_out, stats = _fused_core(
        src_pages, cached_target.pages, pair_start, pair_cnt, pair_tgt,
        unshift @ initial_T, config, lazy,
    )
    if pair_overflow is None:
        pair_overflow = torch.zeros((), dtype=torch.bool, device=src_pages.device)
    return _fused_result(T_out, stats, shift, initial_T, config, pair_overflow)


def fused_inputs(
    source: torch.Tensor,
    source_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    initial_T: torch.Tensor,
    config: ICPConfig,
    cached_target: CachedTarget | None = None,
) -> tuple[tuple, torch.Tensor, torch.Tensor]:
    """`icp_align_fused`'s per-call prologue: (K3's arguments (src_pages,
    tgt_pages, pair_start, pair_cnt, pair_tgt, T0_rebased), the shift back
    out of the rebased frame, pair_overflow)."""
    M, N = source.shape[0], target.shape[0]
    TM, TN = config.tile_src, config.tile_tgt
    if M % TM or N % TN:
        raise ValueError(
            f"icp_align_fused: source {M} / target {N} points are not multiples of "
            f"the tiles {TM} / {TN}"
        )
    nSt = M // TM
    search_r2 = (math.sqrt(config.max_correspondence_dist_sq) + config.reassoc_margin) ** 2
    if cached_target is None:
        cached_target = build_cached_target(target, target_mask, initial_T[:3, 3], TN)
    pts0 = geometry.transform_points(initial_T, source)
    lo_s, hi_s, cnt_s = tile_bboxes(pts0, source_mask, TM)
    visits, counts, v_overflow = pair_tiles(
        lo_s, hi_s, cnt_s, cached_target.lo, cached_target.hi, search_r2, config.max_visits
    )
    max_pairs = nSt * config.max_pairs_factor
    pair_start, pair_cnt, pair_tgt = _build_tile_pair_list(visits, counts, max_pairs)
    pair_overflow = v_overflow | (counts.sum() > max_pairs)
    # SOURCE pages stay unrebased: the kernel applies the whole current
    # transform, and the rebase enters through T (conjugation by the centre)
    src_pages = make_pages(
        source, source_mask, cached_target.center * 0, TM, sentinel=SOURCE_SENTINEL
    )
    shift, unshift = _shifts(cached_target.center)
    core = (src_pages, cached_target.pages, pair_start, pair_cnt, pair_tgt, unshift @ initial_T)
    return core, shift, pair_overflow


def icp_align_fused(
    source: torch.Tensor,
    source_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    initial_T: torch.Tensor,
    config: ICPConfig = ICPConfig(),
    cached_target: CachedTarget | None = None,
) -> ICPResult:
    """Fresh-correspondence point-to-point ICP in one K3 launch.

    Capacities that are not multiples of the tiles fall back to the dense
    ICP (ops/icp._icp_xla), as the JAX function does. Passing
    `cached_target` (build_cached_target) skips the target page and bbox
    construction — the pipeline caches it per re-crop."""
    if source.shape[0] % config.tile_src or target.shape[0] % config.tile_tgt:
        return _icp_xla(source, source_mask, target, target_mask, initial_T, config)
    core, shift, pair_overflow = fused_inputs(
        source, source_mask, target, target_mask, initial_T, config, cached_target
    )
    T_out, stats = _fused_core(*core, config)
    return _fused_result(T_out, stats, shift, initial_T, config, pair_overflow)
