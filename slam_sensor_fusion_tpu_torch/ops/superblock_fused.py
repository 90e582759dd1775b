"""Whole-superblock fine loop: K1 and its plain version (port of the JAX
`ops/superblock_fused.py`).

One call runs the fine loop of K frames (localization_node.cpp:263-374):

  per frame k:
    1. odometry prediction pose @ (odom_prev^-1 @ odom_k) (:89-110);
    2. covariance-weighted ELEMENT-WISE 4x4 blend with the GPS pose
       (:151-179, :329);
    3. stochastic filter: transition queue push + z-score gate, with the
       reference's quirks (ops/stochastic_filter.py);
    4. ICP in the frame rebased on the crop centre: the reference's lazy
       control flow (parity mode) or fresh correspondences every
       iteration (fast mode), tile-major association over the frame's pair
       list, Kabsch moments and a Newton-polar solve;
    5. predicated state update for invalid frames (:269-276).

Pose state lives in the ORIGINAL map frame; only the ICP shifts
translations by the crop centre (the target pages' rebase point).

`superblock_fine` launches the CUDA kernel (csrc/superblock_fused.cu, a
cooperative grid of one block on each SM) for tensors on the card and runs
`superblock_fine_plain` for CPU tensors. The kernel takes any number of
source tiles of up to 4096 rows: up to 8 tiles of up to 1024 rows its
leader keeps each point in registers, past that in a global buffer (the
global layout, which `_superblock_fine` can also be asked for at the
register layout's shapes; both give the same bits there). The
plain version is written as the per-frame path (ops/stochastic_filter.py
plus a plain ICP with K1's association tie rule), the role the JAX
package's per-frame scan plays for its kernel.
"""

from __future__ import annotations

import ctypes
import math

import torch

from slam_sensor_fusion_tpu_torch.ops import cuda_lib
from slam_sensor_fusion_tpu_torch.ops import geometry as geo
from slam_sensor_fusion_tpu_torch.ops import stochastic_filter as sf
from slam_sensor_fusion_tpu_torch.ops.icp_fused import _icp_plain
from slam_sensor_fusion_tpu_torch.ops.nn_pallas import _tile_chunk
from slam_sensor_fusion_tpu_torch.utils.config import LocalizationConfig

_BIG = 3.0e38


class _SBParams(ctypes.Structure):
    """Mirrors `struct SBParams` in csrc/superblock_fused.cu."""

    _fields_ = [
        ("gate", ctypes.c_float),
        ("eps", ctypes.c_float),
        ("acc", ctypes.c_float),
        ("mad_lo", ctypes.c_float),
        ("mad_hi", ctypes.c_float),
        ("z_thr", ctypes.c_float),
        ("num_iterations", ctypes.c_int),
        ("min_corr", ctypes.c_int),
        ("Q", ctypes.c_int),
        ("fixed_gains", ctypes.c_int),
        ("lazy", ctypes.c_int),
    ]


def _params(config: LocalizationConfig) -> _SBParams:
    icp, filt = config.icp, config.filter
    return _SBParams(
        gate=icp.max_correspondence_dist_sq,
        eps=icp.transformation_epsilon,
        acc=icp.acceptable_mean_error,
        mad_lo=filt.min_distance_per_scan,
        mad_hi=filt.max_distance_per_scan / 3.0,
        z_thr=filt.z_score_threshold,
        num_iterations=icp.num_iterations,
        min_corr=icp.min_correspondences,
        Q=filt.queue_size,
        fixed_gains=int(config.fixed_gains),
        lazy=int(icp.mode == "parity"),
    )


def _queue_weights(Q: int, device: torch.device) -> torch.Tensor:
    """The filter queue's (Q,) weights exp(i - Q), normalized in double and
    then rounded to f32, as the JAX kernel's Python-float constants are;
    copied from pinned memory without a sync (the launch's stream orders
    it)."""
    if Q < 1:
        raise ValueError(f"superblock_fine: queue_size {Q} < 1")
    wq = [math.exp(i - Q) for i in range(Q)]
    s = sum(wq)
    host = torch.tensor([w / s for w in wq], dtype=torch.float32).pin_memory()
    return host.to(device, non_blocking=True)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _associate(src, R, t, start, cnt, pair_tgt, tgt_pages):
    """K1's tile-major association for one frame: per source tile, direct
    (t - s)^2 distances to each admitted target tile; within a tile exact
    d2 ties AVERAGE their coordinates (superblock_fused.py:199-216); across
    tiles a strict `<` keeps the earlier tile. Returns best d2 (nSt, TM)
    and the winner coordinates (nSt, 3, TM)."""
    nSt, _, TM = src.shape
    TN = tgt_pages.shape[2]
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
        bxyz = torch.zeros((3, TM), dtype=torch.float32, device=dev)
        for c0 in range(0, cnt[i], chunk):
            js = pair_tgt[start[i] + c0 : start[i] + min(cnt[i], c0 + chunk)].long()
            tt = tgt_pages[js]  # (C, 3, TN)
            dx = tt[:, 0, :, None] - sx
            dy = tt[:, 1, :, None] - sy
            dz = tt[:, 2, :, None] - sz
            d2 = dx * dx + dy * dy + dz * dz  # (C, TN, TM)
            tile_min = d2.amin(dim=1)  # (C, TM)
            sel = (d2 == tile_min[:, None, :]).float()
            tt4 = torch.cat([tt, torch.ones_like(tt[:, :1])], dim=1)
            coords = torch.bmm(tt4, sel)  # (C, 4, TM): summed coords, tie count
            inv = 1.0 / torch.clamp(coords[:, 3], min=1.0)
            cxyz = coords[:, :3] * inv[:, None]
            cmin, carg = tile_min.min(dim=0)  # first tile on ties
            better = cmin < best
            best = torch.where(better, cmin, best)
            bxyz = torch.where(better[None], cxyz[carg, :, cols].T, bxyz)
        best_all.append(best)
        xyz_all.append(bxyz)
    return torch.stack(best_all), torch.stack(xyz_all)


def _rigid(T: torch.Tensor) -> torch.Tensor:
    """(R, t) of T repacked with the exact [0, 0, 0, 1] bottom row, as K1
    packs every pose it outputs."""
    return geo.make_T(T[..., :3, :3], T[..., :3, 3])


def superblock_fine_plain(
    src_pages, pair_start, pair_cnt, pair_tgt, valid, odom_T, gps_T, odom_tr,
    gps_tr, pose, odom_prev, filt_trans, filt_count, filt_prev, center,
    tgt_pages, config: LocalizationConfig,
):
    """K1 as plain PyTorch; same arguments and 9-tuple as `superblock_fine`."""
    K = src_pages.shape[0]
    dev = src_pages.device
    icp = config.icp
    lazy = icp.mode == "parity"
    filt = sf.FilterState(filt_trans, filt_count, filt_prev)
    poses, priors, preds = [], [], []
    stats = torch.zeros((K, 128), dtype=torch.float32, device=dev)
    zeros44 = torch.zeros((4, 4), dtype=torch.float32, device=dev)
    starts, cnts = pair_start.tolist(), pair_cnt.tolist()
    for k, v in enumerate(valid.tolist()):
        map_T_sensor_odom = pose @ (geo.inv_T(odom_prev) @ odom_T[k])
        if config.fixed_gains:
            og, gg = 0.95, 0.05
        else:
            tot = odom_tr[k] + gps_tr[k]
            og, gg = gps_tr[k] / tot, odom_tr[k] / tot
        prior = og * map_T_sensor_odom + gg * gps_T[k]
        filt_new = sf.add_pose(filt, prior, config.filter)
        prior = sf.apply_gate(filt_new, pose, prior, config.filter)
        Rg, tg = prior[:3, :3], prior[:3, 3]
        if v:
            R, t, err, n_corr, iters, det_min = _icp_plain(
                src_pages[k], Rg, tg - center,
                (starts[k], cnts[k], pair_tgt[k]), tgt_pages, icp, lazy, _associate,
            )
            enough = n_corr >= icp.min_correspondences
            if enough:
                pose = geo.make_T(R, t + center)
            else:
                pose = geo.make_T(Rg, tg)
            conv = enough and bool(err < icp.acceptable_mean_error)
            stats[k, 0] = err if enough else 1.0e6
            stats[k, 1] = iters if enough else 0
            stats[k, 2] = n_corr
            stats[k, 3] = float(conv)
            stats[k, 4] = det_min
            odom_prev = odom_T[k]
            filt = filt_new
        poses.append(pose)
        priors.append(geo.make_T(Rg, tg) if v else zeros44)
        preds.append(_rigid(map_T_sensor_odom) if v else zeros44)
    return (
        torch.stack(poses),
        torch.stack(priors),
        torch.stack(preds),
        stats,
        _rigid(pose),
        _rigid(odom_prev),
        _rigid(filt.transitions),
        filt.count.clone(),
        _rigid(filt.previous_pose),
    )


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def superblock_fine(
    src_pages: torch.Tensor,  # (K, nSt, 3, TM)
    pair_start: torch.Tensor,  # (K, nSt) per-src-tile offsets into pair_tgt
    pair_cnt: torch.Tensor,  # (K, nSt) per-src-tile admitted-tile counts
    pair_tgt: torch.Tensor,  # (K, max_pairs) flat row-major target tiles
    valid: torch.Tensor,  # (K,) bool
    odom_T: torch.Tensor,  # (K, 4, 4)
    gps_T: torch.Tensor,  # (K, 4, 4)
    odom_tr: torch.Tensor,  # (K,)
    gps_tr: torch.Tensor,  # (K,)
    pose: torch.Tensor,  # (4, 4)
    odom_prev: torch.Tensor,  # (4, 4)
    filt_trans: torch.Tensor,  # (Q, 4, 4)
    filt_count: torch.Tensor,  # () int32
    filt_prev: torch.Tensor,  # (4, 4)
    center: torch.Tensor,  # (3,)
    tgt_pages: torch.Tensor,  # (nTt, 3, TN)
    config: LocalizationConfig,
):
    """One launch for a whole superblock's fine loop. Returns (poses
    (K,4,4), priors, odom_preds, stats (K,128) = [err, iters, n_corr, conv,
    det_min, 0...], new_pose, new_odom_prev, new_filt_trans,
    new_filt_count, new_filt_prev) — the JAX function's 9-tuple."""
    return _superblock_fine(
        src_pages, pair_start, pair_cnt, pair_tgt, valid, odom_T, gps_T, odom_tr,
        gps_tr, pose, odom_prev, filt_trans, filt_count, filt_prev, center,
        tgt_pages, config,
    )


def _superblock_fine(*inputs, global_layout: bool = False):
    """`superblock_fine`'s body; `global_layout` launches K1 with its
    leader's points in the global buffer at any shape (the layout it takes
    by itself past 8 source tiles or 1024 rows)."""
    (src_pages, pair_start, pair_cnt, pair_tgt, valid, odom_T, gps_T, odom_tr,
     gps_tr, pose, odom_prev, filt_trans, filt_count, filt_prev, center,
     tgt_pages, config) = inputs
    dev = src_pages.device
    K, nSt, _, TM = src_pages.shape
    nTt, _, TN = tgt_pages.shape
    Q = config.filter.queue_size
    max_pairs = pair_tgt.shape[1]
    f32, i32 = torch.float32, torch.int32
    valid_i = valid.to(i32)
    count_i = filt_count.to(i32).reshape(())
    args = [
        (src_pages, "src_pages", f32, (K, nSt, 3, TM)),
        (pair_start, "pair_start", i32, (K, nSt)),
        (pair_cnt, "pair_cnt", i32, (K, nSt)),
        (pair_tgt, "pair_tgt", i32, (K, max_pairs)),
        (valid_i, "valid", i32, (K,)),
        (odom_T, "odom_T", f32, (K, 4, 4)),
        (gps_T, "gps_T", f32, (K, 4, 4)),
        (odom_tr, "odom_tr", f32, (K,)),
        (gps_tr, "gps_tr", f32, (K,)),
        (pose, "pose", f32, (4, 4)),
        (odom_prev, "odom_prev", f32, (4, 4)),
        (filt_trans, "filt_trans", f32, (Q, 4, 4)),
        (count_i, "filt_count", i32, ()),
        (filt_prev, "filt_prev", f32, (4, 4)),
        (center, "center", f32, (3,)),
        (tgt_pages, "tgt_pages", f32, (nTt, 3, TN)),
    ]
    for t, name, dtype, shape in args:
        cuda_lib.require(t, name, dtype, shape, dev)
    if dev.type == "cpu":
        return superblock_fine_plain(
            src_pages, pair_start, pair_cnt, pair_tgt, valid, odom_T, gps_T,
            odom_tr, gps_tr, pose, odom_prev, filt_trans, filt_count,
            filt_prev, center, tgt_pages, config,
        )
    if dev.type != "cuda":
        raise ValueError(f"superblock_fine: unsupported device {dev}")
    cuda_lib.check_tile_src("superblock_fine", TM)
    if TN % 32:
        raise ValueError(f"superblock_fine: tile_tgt {TN} not a multiple of 32")
    if TN * 16 + 4096 > 227 * 1024:
        raise ValueError(f"superblock_fine: tile_tgt {TN} exceeds shared memory")
    if nSt < 1:
        raise ValueError("superblock_fine: no source tile")
    poses = torch.empty((K, 4, 4), dtype=f32, device=dev)
    priors = torch.empty((K, 4, 4), dtype=f32, device=dev)
    odom_preds = torch.empty((K, 4, 4), dtype=f32, device=dev)
    stats = torch.empty((K, 128), dtype=f32, device=dev)
    state = torch.empty((Q + 3, 4, 4), dtype=f32, device=dev)
    count_out = torch.empty((1, 128), dtype=f32, device=dev)
    # an association round's per-slot winners (tile minimum d2, averaged
    # x, y, z), reused frame after frame; it stays in L2
    scratch = torch.empty((max_pairs, 4, TM), dtype=f32, device=dev)
    # the global layout's points: matched x, y, z and the alive weight
    point_state = torch.empty((nSt, TM, 4), dtype=f32, device=dev)
    # the leader's filter queue and its next state (any queue size)
    wq = _queue_weights(Q, dev)
    qbuf = torch.empty((2, Q, 12), dtype=f32, device=dev)
    ctl = cuda_lib.control_block(dev)
    prm = _params(config)
    err = cuda_lib.lib().sfk_superblock_fine(
        *[t.data_ptr() for t, *_ in args],
        poses.data_ptr(), priors.data_ptr(), odom_preds.data_ptr(),
        stats.data_ptr(), state.data_ptr(), count_out.data_ptr(),
        scratch.data_ptr(), point_state.data_ptr(), wq.data_ptr(), qbuf.data_ptr(), ctl.data_ptr(),
        K, nSt, TM, TN, max_pairs, int(global_layout), ctypes.addressof(prm),
        cuda_lib.stream_ptr(src_pages),
    )
    cuda_lib.check(err, "superblock_fine")
    superblock_fine.launches += 1
    superblock_fine.scratch_bytes = max(superblock_fine.scratch_bytes, scratch.nbytes)
    return (
        poses,
        priors,
        odom_preds,
        stats,
        state[0],
        state[1],
        state[3 : 3 + Q],
        count_out[0, 0].to(i32),
        state[2],
    )


#: kernel launches made by `superblock_fine` (CUDA tensors only)
superblock_fine.launches = 0
#: the largest per-slot scratch (bytes) a launch has allocated since this
#: was last set to 0
superblock_fine.scratch_bytes = 0


def kernel_grid(n_src_tiles: int, tile_src: int, tile_tgt: int) -> dict:
    """K1's cooperative grid on the current card for these tiles: blocks,
    threads a block and the blocks a multiprocessor could hold."""
    return cuda_lib.grid_shape(
        cuda_lib.lib().sfk_superblock_grid, n_src_tiles, tile_src, tile_tgt)
