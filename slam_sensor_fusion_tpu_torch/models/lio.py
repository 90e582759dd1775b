"""LiDAR-inertial odometry with a rolling local map, native mode (port of
the JAX `models/lio.py`, per-frame loops).

Deskewed scans register against a local map by point-to-plane Gauss-Newton,
fused with IMU propagation through the error-state EKF (models/ekf.py).
Everything is fixed-shape:

* the local map is a RING of the last `window` keyframes' downsampled
  scans (window x slot_points); insertion writes one slot;
* target normals, the Morton sort and the fused-kernel target cache are
  refreshed only when the anchor refreshes, every `refresh_every` frames;
* per frame: EKF-propagated prior -> (deskew) -> point-to-plane GN against
  the anchored map (one K4 launch with `nn_backend="fused"`) -> EKF pose
  update (+ gated GPS update) -> scan inserted into the ring.

`lio_step` is one frame with the amortized refresh; `run_lio_chunk` loops
it; `run_lio_blocks` is the per-frame throughput loop with the refresh
hoisted to block boundaries; `run_lio_superblocks` is the whole-block
loop: one K7 launch (ops/lio_superblock_fused.py) runs the EKF, the GN and
both Kalman updates of `refresh_every` frames, around a batched prologue
and ring insert. The ring slot and the frame counter advance by amounts
the host knows, so they are Python ints and the refresh test costs no wait
for the device; every other data-dependent choice is a select on device
values.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from slam_sensor_fusion_tpu_torch.models import ekf
from slam_sensor_fusion_tpu_torch.models.pipeline_fast import _transformed_tile_boxes
from slam_sensor_fusion_tpu_torch.ops import cloud as cl
from slam_sensor_fusion_tpu_torch.ops import geometry
from slam_sensor_fusion_tpu_torch.ops import xla_math as xm
from slam_sensor_fusion_tpu_torch.ops.deskew import deskew, se3_log
from slam_sensor_fusion_tpu_torch.ops.icp_fused import SOURCE_SENTINEL
from slam_sensor_fusion_tpu_torch.ops.lio_superblock_fused import (
    LIOSuperblockParams,
    lio_superblock,
)
from slam_sensor_fusion_tpu_torch.ops.morton import sort_by_morton, tile_bboxes
from slam_sensor_fusion_tpu_torch.ops.nn_gated import (
    pair_demand_from_d2,
    pair_tiles_from_d2,
    subtile_pair_dist2,
)
from slam_sensor_fusion_tpu_torch.ops.nn_pallas import _build_tile_pair_list
from slam_sensor_fusion_tpu_torch.ops.p2p_fused import (
    CachedP2PTarget,
    build_cached_p2p_target,
    point_to_plane_align_fused,
)
from slam_sensor_fusion_tpu_torch.ops.point_to_plane import (
    PointToPlaneConfig,
    estimate_normals,
    estimate_normals_cells,
    estimate_normals_tiled,
    point_to_plane_align,
)


class LIOConfig(NamedTuple):
    scan_capacity: int = 16384
    #: ring slots and points per slot: local map = window * slot_points
    window: int = 16
    slot_points: int = 4096
    #: refresh the registration anchor (Morton sort + normals) every N frames
    refresh_every: int = 8
    p2p: PointToPlaneConfig = PointToPlaneConfig()
    ekf: ekf.EKFConfig = ekf.EKFConfig()
    icp_pos_std: float = 0.03
    icp_rot_std: float = 0.01
    #: "constant" = fixed stds above; "gn" = the registration's own
    #: sigma^2 (JtJ)^-1 covariance (adjoint-mapped to (dp, dtheta_body)),
    #: floored below
    icp_cov_mode: str = "constant"
    gn_cov_scale: float = 1.0
    gn_pos_std_floor: float = 0.02
    gn_rot_std_floor: float = 0.005
    #: gn mode: add the anchor-refresh-time pose covariance to the
    #: measurement covariance: the ring was PLACED with that uncertainty,
    #: so registration against it is never more absolutely accurate than
    #: the ring itself
    gn_anchor_cov: bool = True
    #: kept for the JAX package's field set; the loop is chosen by calling
    #: `run_lio_superblocks` (whole-block kernel) or `run_lio_blocks`
    block_kernel: bool = False
    #: superblock loop only: per-frame dilation of the block pair-search
    #: radius, plus its base
    superstep_slack: float = 0.05
    slack_base: float = 0.05
    #: superblock loop only: pair-list capacity = (scan tiles) * this
    #: factor. The per-frame loops take `p2p.max_pairs_factor`.
    max_pairs_factor: int = 64
    #: superblock loop only: register on every k-th point of the
    #: (Morton-pre-sorted) scan. The per-frame loops register every point.
    reg_subsample: int = 1
    #: build the registration target pages from every k-th anchor point
    #: (normals stay full-quality: estimated on the full ring, then
    #: subsampled alongside). Halves association work at k=2.
    anchor_subsample: int = 1
    #: points per FINE gating sub-box (ops/nn_gated.subtile_pair_dist2);
    #: the target's sub-boxes are stored with the anchor cache, the
    #: superblock loop reads both
    gate_sub_src: int = 16
    gate_sub_tgt: int = 32
    normal_voxel: float = 0.75
    #: "voxel" = voxel-cell PCA (sort + scatter + eigh, exact cells);
    #: "cells" = the same cell semantics on truncated-Morton runs
    #: (estimate_normals_cells); "tiled" = fixed Morton-chunk PCA
    normal_est: str = "voxel"
    normal_chunk: int = 32
    #: "cells" only: drop crease cells (lam_min >= ratio * lam_mid); None
    #: keeps every populated cell like the voxel estimator
    normal_planarity: float | None = None
    #: superblock loop only: scan masks are PACKED prefixes
    packed_scans: bool = True


class LIOState(NamedTuple):
    ekf_state: ekf.EKFState
    ring: torch.Tensor  # (window * slot_points, 3) world-frame map points
    ring_mask: torch.Tensor  # (window * slot_points,)
    slot: int  # next ring slot (host counter)
    frame: int  # frame counter (host counter)
    anchor_points: torch.Tensor  # Morton-sorted snapshot used as GN target
    anchor_mask: torch.Tensor
    anchor_normals: torch.Tensor
    anchor_normals_valid: torch.Tensor
    #: fused-kernel target cache (6-row xyz+normal pages + tile bboxes),
    #: rebuilt with the anchor; unused by the xla/pallas backends
    anchor_cache: CachedP2PTarget
    #: (6, 6) pose block of the EKF covariance AT anchor refresh: the
    #: ring's own world uncertainty (used by icp_cov_mode="gn")
    anchor_P6: torch.Tensor


def _pose_cov6(P: torch.Tensor) -> torch.Tensor:
    """(position, attitude) block of the 15-state covariance."""
    rows = torch.cat([P[0:3], P[6:9]], dim=0)
    return torch.cat([rows[:, 0:3], rows[:, 6:9]], dim=1)


class LIOOutput(NamedTuple):
    world_T_body: torch.Tensor
    rmse: torch.Tensor
    n_correspondences: torch.Tensor
    refreshed: torch.Tensor
    gps_accepted: torch.Tensor
    #: superblock-only observability (None on the per-frame loops)
    slack_violation: torch.Tensor | None = None
    slack_dist: torch.Tensor | None = None
    pair_overflow: torch.Tensor | None = None
    pair_demand: torch.Tensor | None = None
    icp_std_xyz: torch.Tensor | None = None


def _refresh_anchor(
    ring: torch.Tensor, ring_mask: torch.Tensor, center: torch.Tensor, config: LIOConfig
):
    """Morton sort + normal estimation + fused-kernel cache for the
    current ring contents. Returns the four anchor arrays + the cache."""
    # isotropic box: the "cells" estimator's truncated-Morton cells must
    # be metrically cubic AND contiguous in this sort order
    anchor = sort_by_morton(cl.Cloud(ring, ring_mask), isotropic=config.normal_est == "cells")
    if config.normal_est == "cells":
        normals, nvalid = estimate_normals_cells(
            anchor.points, anchor.mask, config.normal_voxel,
            max_planarity=config.normal_planarity,
        )
    elif config.normal_est == "tiled":
        normals, nvalid = estimate_normals_tiled(anchor.points, anchor.mask, config.normal_chunk)
    else:
        normals, nvalid = estimate_normals(anchor.points, anchor.mask, config.normal_voxel)
    # registration pages from every k-th anchor point (Morton-sorted =>
    # spatially uniform), with full-quality normals riding along
    asub = config.anchor_subsample
    cache = build_cached_p2p_target(
        anchor.points[::asub], anchor.mask[::asub], normals[::asub],
        nvalid[::asub], center, config.p2p.tile_tgt,
        gate_sub=config.gate_sub_tgt,
    )
    return anchor.points, anchor.mask, normals, nvalid, cache


def _with_anchor(state: LIOState, anchor: tuple, P6: torch.Tensor) -> LIOState:
    a_pts, a_msk, a_nrm, a_nvl, cache = anchor
    return state._replace(
        anchor_points=a_pts,
        anchor_mask=a_msk,
        anchor_normals=a_nrm,
        anchor_normals_valid=a_nvl,
        anchor_cache=cache,
        anchor_P6=P6,
    )


def init_state(
    config: LIOConfig,
    first_scan: torch.Tensor,
    first_scan_mask: torch.Tensor,
    world_T_body0: torch.Tensor,
) -> LIOState:
    """Seed the map ring and anchor with the first scan; the state lives
    on the scan's device."""
    dev = first_scan.device
    n = config.window * config.slot_points
    pts0 = geometry.transform_points(world_T_body0, first_scan)
    seeded = cl.sample_to_capacity(cl.Cloud(pts0, first_scan_mask), config.slot_points)
    ring = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    ring_mask = torch.zeros((n,), dtype=torch.bool, device=dev)
    ring[: config.slot_points] = seeded.points
    ring_mask[: config.slot_points] = seeded.mask

    e0 = ekf.init_state(
        config.ekf, p0=world_T_body0[:3, 3], R0=world_T_body0[:3, :3], device=dev
    )
    state = LIOState(
        ekf_state=e0, ring=ring, ring_mask=ring_mask, slot=1, frame=1,
        anchor_points=None, anchor_mask=None, anchor_normals=None,
        anchor_normals_valid=None, anchor_cache=None, anchor_P6=None,
    )
    anchor = _refresh_anchor(ring, ring_mask, world_T_body0[:3, 3].float(), config)
    return _with_anchor(state, anchor, _pose_cov6(e0.P))


def _prior_and_scan(
    state: LIOState,
    scan_points: torch.Tensor,
    imu_gyro: torch.Tensor,
    imu_accel: torch.Tensor,
    imu_dt: torch.Tensor,
    config: LIOConfig,
    scan_tau: torch.Tensor | None,
) -> tuple[ekf.EKFState, torch.Tensor, torch.Tensor]:
    """A frame's first half: IMU propagation gives the registration prior;
    with `scan_tau` (the fraction of the sweep elapsed at each point's
    measurement time) the scan is deskewed by the IMU-propagated
    between-frame twist. Returns (propagated EKF state, prior_T, scan)."""
    e = ekf.propagate_batch(state.ekf_state, imu_gyro, imu_accel, imu_dt, config.ekf)
    prior_T = ekf.pose_matrix(e)
    if scan_tau is not None:
        prev_T = ekf.pose_matrix(state.ekf_state)
        xi = se3_log(xm.mm3(geometry.inv_T(prev_T), prior_T))
        scan_points = deskew(scan_points, scan_tau, xi)
    return e, prior_T, scan_points


def _frame_step(
    state: LIOState,
    scan_points: torch.Tensor,
    scan_mask: torch.Tensor,
    imu_gyro: torch.Tensor,
    imu_accel: torch.Tensor,
    imu_dt: torch.Tensor,
    gps_pos: torch.Tensor,
    gps_var: torch.Tensor,
    gps_valid: torch.Tensor,
    config: LIOConfig,
    scan_tau: torch.Tensor | None = None,
) -> tuple[LIOState, LIOOutput, torch.Tensor]:
    """Propagate + register + fuse + ring insert: everything EXCEPT the
    anchor refresh (the loops decide when to refresh)."""
    dev = scan_points.device
    # 1) the prior, and the deskewed scan
    e, prior_T, scan_points = _prior_and_scan(
        state, scan_points, imu_gyro, imu_accel, imu_dt, config, scan_tau
    )

    # 2) scan-to-map point-to-plane GN
    if config.p2p.nn_backend == "fused":
        reg = point_to_plane_align_fused(
            scan_points, scan_mask, state.anchor_cache, prior_T, config.p2p
        )
    else:
        reg = point_to_plane_align(
            scan_points, scan_mask, state.anchor_points, state.anchor_mask,
            state.anchor_normals, state.anchor_normals_valid, prior_T, config.p2p,
        )

    # 3) EKF fusion: registration pose update + gated GPS
    if config.icp_cov_mode == "gn" and reg.cov_pose is not None:
        # measurement covariance from the GN system itself: residual
        # variance x (JtJ)^-1 mapped to (dp, dtheta_body), floored
        sigma2 = (
            reg.wr2 / torch.clamp(reg.n_correspondences.float() - 6.0, min=1.0)
        ) * config.gn_cov_scale
        floor = torch.diag(
            torch.cat(
                [
                    torch.full((3,), config.gn_pos_std_floor**2, device=dev),
                    torch.full((3,), config.gn_rot_std_floor**2, device=dev),
                ]
            )
        )
        Rm = xm.fma32(sigma2, reg.cov_pose, floor)  # XLA contracts it
        if config.gn_anchor_cov:
            Rm = Rm + state.anchor_P6
        e = ekf.update_pose_cov(e, reg.transformation, Rm)
    else:
        e = ekf.update_pose(e, reg.transformation, config.icp_pos_std, config.icp_rot_std)
    e_gps, accepted = ekf.update_gps(e, gps_pos, gps_var, config.ekf)
    e = ekf._select(gps_valid, e_gps, e)
    world_T_body = ekf.pose_matrix(e)

    # 4) insert the registered scan into a copy of the ring (the previous
    # state stays valid, as a run restarted from it expects)
    pts_world = geometry.transform_points(world_T_body, scan_points)
    slot_cloud = cl.sample_to_capacity(cl.Cloud(pts_world, scan_mask), config.slot_points)
    offset = (state.slot % config.window) * config.slot_points
    ring, ring_mask = state.ring.clone(), state.ring_mask.clone()
    ring[offset : offset + config.slot_points] = slot_cloud.points
    ring_mask[offset : offset + config.slot_points] = slot_cloud.mask

    new_state = state._replace(
        ekf_state=e, ring=ring, ring_mask=ring_mask,
        slot=state.slot + 1, frame=state.frame + 1,
    )
    out = LIOOutput(
        world_T_body=world_T_body,
        rmse=reg.rmse,
        n_correspondences=reg.n_correspondences,
        refreshed=torch.zeros((), dtype=torch.bool, device=dev),
        gps_accepted=accepted & gps_valid,
    )
    return new_state, out, world_T_body


def lio_step(
    state: LIOState,
    scan_points: torch.Tensor,  # (scan_capacity, 3) body-frame points
    scan_mask: torch.Tensor,
    imu_gyro: torch.Tensor,  # (K, 3)
    imu_accel: torch.Tensor,  # (K, 3)
    imu_dt: torch.Tensor,  # (K,)
    gps_pos: torch.Tensor,  # (3,) world position (rebased), used when gps_valid
    gps_var: torch.Tensor,
    gps_valid: torch.Tensor,
    config: LIOConfig = LIOConfig(),
    scan_tau: torch.Tensor | None = None,  # (scan_capacity,) sweep fractions
) -> tuple[LIOState, LIOOutput]:
    """One LIO frame: propagate, register, fuse, map-update, and the
    amortized anchor refresh (the reference's re-crop cadence,
    localization_node.cpp:299-305). `run_lio_blocks` is the throughput
    loop: it hoists the refresh out of the frame loop."""
    new_state, out, world_T_body = _frame_step(
        state, scan_points, scan_mask, imu_gyro, imu_accel, imu_dt,
        gps_pos, gps_var, gps_valid, config, scan_tau,
    )
    # 5) anchor refresh (amortized): Morton sort + normals + fused cache
    refresh = state.frame % config.refresh_every == 0
    if refresh:
        anchor = _refresh_anchor(
            new_state.ring, new_state.ring_mask, world_T_body[:3, 3], config
        )
        new_state = _with_anchor(new_state, anchor, _pose_cov6(new_state.ekf_state.P))
    return new_state, out._replace(refreshed=torch.full_like(out.refreshed, refresh))


def _stack_outputs(outs: list[LIOOutput]) -> LIOOutput:
    """Per-frame outputs stacked along a leading time axis."""
    return LIOOutput(
        *[None if xs[0] is None else torch.stack(xs) for xs in zip(*outs)]
    )


def _frames(frame_fn, state, arrays, scan_tau, lo, hi):
    """Run `frame_fn` over frames lo..hi of the (T, ...) arrays."""
    outs = []
    for k in range(lo, hi):
        tau = None if scan_tau is None else scan_tau[k]
        state, out = frame_fn(state, *[a[k] for a in arrays], tau)
        outs.append(out)
    return state, outs


def run_lio_chunk(
    state: LIOState,
    scan_points: torch.Tensor,  # (T, S, 3)
    scan_mask: torch.Tensor,  # (T, S)
    imu_gyro: torch.Tensor,  # (T, K, 3)
    imu_accel: torch.Tensor,  # (T, K, 3)
    imu_dt: torch.Tensor,  # (T, K)
    gps_pos: torch.Tensor,  # (T, 3)
    gps_var: torch.Tensor,  # (T,)
    gps_valid: torch.Tensor,  # (T,)
    config: LIOConfig = LIOConfig(),
    scan_tau: torch.Tensor | None = None,  # (T, S)
) -> tuple[LIOState, LIOOutput]:
    """`lio_step` over a chunk of frames; outputs stacked over time."""
    arrays = (scan_points, scan_mask, imu_gyro, imu_accel, imu_dt, gps_pos, gps_var, gps_valid)

    def frame(s, *args):
        *core, tau = args
        return lio_step(s, *core, config, tau)

    state, outs = _frames(frame, state, arrays, scan_tau, 0, scan_points.shape[0])
    return state, _stack_outputs(outs)


def run_lio_blocks(
    state: LIOState,
    scan_points: torch.Tensor,  # (T, S, 3)
    scan_mask: torch.Tensor,  # (T, S)
    imu_gyro: torch.Tensor,  # (T, K, 3)
    imu_accel: torch.Tensor,  # (T, K, 3)
    imu_dt: torch.Tensor,  # (T, K)
    gps_pos: torch.Tensor,  # (T, 3)
    gps_var: torch.Tensor,  # (T,)
    gps_valid: torch.Tensor,  # (T,)
    config: LIOConfig = LIOConfig(),
    scan_tau: torch.Tensor | None = None,  # (T, S)
) -> tuple[LIOState, LIOOutput]:
    """Throughput loop: frames in blocks of `refresh_every` (and a tail
    block), with the anchor refresh at the BLOCK boundary.

    Cadence equivalence with `run_lio_chunk`: the anchor is refreshed
    every `refresh_every` frames either way; here the refresh sees the
    ring one frame earlier (block start vs post-insert), which shifts the
    target map by one scan out of `window`: trajectories agree to well
    under the registration noise floor.
    """
    T = scan_points.shape[0]
    arrays = (scan_points, scan_mask, imu_gyro, imu_accel, imu_dt, gps_pos, gps_var, gps_valid)

    def frame(s, *args):
        *core, tau = args
        new_state, out, _ = _frame_step(s, *core, config, tau)
        return new_state, out

    outs = []
    for lo in range(0, T, config.refresh_every):
        anchor = _refresh_anchor(state.ring, state.ring_mask, state.ekf_state.p, config)
        state = _with_anchor(state, anchor, _pose_cov6(state.ekf_state.P))
        state, block = _frames(
            frame, state, arrays, scan_tau, lo, min(lo + config.refresh_every, T)
        )
        outs += block
    return state, _stack_outputs(outs)


def _dead_reckon(
    e0: ekf.EKFState, gyro: torch.Tensor, accel: torch.Tensor, dts: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean-only IMU integration over a block's packets (gyro, accel
    (K, Ki, 3), dts (K, Ki)): the poses (R (K, 3, 3), t (K, 3)) at each frame
    boundary, biases frozen at block start, Rodrigues `geometry.so3_exp`,
    rounded as `ekf.propagate`'s mean is (ops/xla_math).

    The block's pair prologue builds its lists at these predictions; the
    kernel's propagation starts from each frame's POSTERIOR, so the realized
    prior differs by the accumulated GN/GPS corrections, which the per-frame
    `superstep_slack` dilation budgets. The sample loop issues a few small
    operations a sample and reads nothing back; on the card it is one launch
    of csrc/xla_math.cu (one thread's chain), bit-equal to it."""
    if xm.on_card(e0.R):
        K = dts.shape[0]
        Rs = torch.empty((K, 3, 3), dtype=torch.float32, device=e0.R.device)
        ts = torch.empty((K, 3), dtype=torch.float32, device=e0.R.device)
        consts = ekf._constants(ekf.EKFConfig(), e0.p.device).imu
        xm.launch("dead_reckon", [ekf.flat_state(e0), ekf.imu_rows(gyro, accel, dts), consts],
                  [Rs, ts], params=(K, dts.shape[1]))
        return Rs, ts
    g_w = ekf._constants(ekf.EKFConfig(), e0.p.device).g_w
    # every sample's rotation increment at once; the chain stays sequential
    steps = geometry.so3_exp((gyro - e0.bg) * dts[..., None])
    f = accel - e0.ba
    p, v, R = e0.p, e0.v, e0.R
    Rs, ts = [], []
    for k in range(dts.shape[0]):
        for j in range(dts.shape[1]):
            dd = dts[k, j]
            a_w = xm.mv3(R, f[k, j]) + g_w
            p = xm.fma32(a_w * (dd * 0.5), dd, xm.fma32(v, dd, p))
            v = xm.fma32(a_w, dd, v)
            R = xm.mm3(R, steps[k, j])
        Rs.append(R)
        ts.append(p)
    return torch.stack(Rs), torch.stack(ts)


def _superblock_params(config: LIOConfig) -> LIOSuperblockParams:
    return LIOSuperblockParams(
        p2p=config.p2p,
        ekf=config.ekf,
        icp_pos_std=config.icp_pos_std,
        icp_rot_std=config.icp_rot_std,
        icp_cov_mode=config.icp_cov_mode,
        gn_cov_scale=config.gn_cov_scale,
        gn_pos_std_floor=config.gn_pos_std_floor,
        gn_rot_std_floor=config.gn_rot_std_floor,
        gn_anchor_cov=config.gn_anchor_cov,
        superstep_slack=config.superstep_slack,
        slack_base=config.slack_base,
    )


def _block_prologue(st: LIOState, cache: CachedP2PTarget, sp, sm, tau, gy, ac, dt, vld,
                    radius2, config: LIOConfig):
    """Steps 2-4 of a block: dead reckoning, deskew twists, the
    registration rows' source pages and the pair lists. Returns (pred_t,
    twists or None, src_pages, (pair_start, pair_cnt, pair_tgt), pair
    demand, pair overflow)."""
    e0 = st.ekf_state
    R = sp.shape[0]
    TM, rsub = config.p2p.tile_src, config.reg_subsample
    pred_R, pred_t = _dead_reckon(e0, gy, ac, dt)
    # deskew twists from the dead-reckoned between-frame motion. Deskew is
    # per point, so it runs after subset selection (select-then-deskew ==
    # deskew-then-select): only the ::rsub registration rows and the ring
    # sample are ever corrected
    xi = None
    if tau is not None:
        prev_R = torch.cat([e0.R[None], pred_R[:-1]])
        prev_t = torch.cat([e0.p[None], pred_t[:-1]])
        prev_Rt = prev_R.transpose(-1, -2)
        rel_R = xm.mm3(prev_Rt, pred_R)
        rel_t = xm.mv3(prev_Rt, pred_t - prev_t)
        xi = se3_log(geometry.make_T(rel_R, rel_t))  # (R, 6)
    # registration on every rsub-th point of the (Morton-pre-sorted) scan;
    # FINE sub-box gating against the cache's sub-boxes
    rp, rm = sp[:, ::rsub], sm[:, ::rsub]
    if xi is not None:
        rp = deskew(rp, tau[:, ::rsub], xi)
    nSt = rp.shape[1] // TM
    src_pages = (
        torch.where(rm[..., None], rp.float(), SOURCE_SENTINEL)
        .reshape(R, nSt, TM, 3).transpose(2, 3).contiguous()
    )
    _, _, cnt_b = tile_bboxes(rp, rm, TM)
    slo_b, shi_b, _ = tile_bboxes(rp, rm, config.gate_sub_src)
    slo_w, shi_w = _transformed_tile_boxes(geometry.make_T(pred_R, pred_t), slo_b, shi_b)
    d2_tiles = subtile_pair_dist2(
        slo_w, shi_w, cache.sub_lo, cache.sub_hi, nSt, cache.pages.shape[0]
    )
    visits, counts, v_ovf = pair_tiles_from_d2(d2_tiles, cnt_b, radius2, config.p2p.max_visits)
    max_pairs = nSt * config.max_pairs_factor
    pairs = _build_tile_pair_list(visits, counts, max_pairs)
    demand = pair_demand_from_d2(d2_tiles, cnt_b, radius2)
    overflow = vld & (v_ovf | (demand > max_pairs))
    return pred_t, xi, src_pages, pairs, demand, overflow


def _ring_sample(sp, sm, tau, xi, config: LIOConfig) -> cl.Cloud:
    """The K scans sampled to slot width and deskewed: (K, slot_points, 3)
    points and their mask."""
    SP = config.slot_points
    if config.packed_scans:
        # indices from the mask alone: gather slot-width rows of the RAW
        # scan, then deskew only those
        ridx, smask = cl.packed_sample_indices(sm, SP)
        spts = torch.gather(sp, 1, ridx[..., None].expand(-1, -1, 3))
        if xi is not None:
            spts = deskew(spts, torch.gather(tau, 1, ridx), xi)
        return cl.Cloud(spts, smask)
    # arbitrary masks: the generic per-frame compaction
    sp_full = deskew(sp, tau, xi) if xi is not None else sp
    clouds = [cl.sample_to_capacity(cl.Cloud(p, m), SP) for p, m in zip(sp_full, sm)]
    return cl.Cloud(torch.stack([c.points for c in clouds]), torch.stack([c.mask for c in clouds]))


def run_lio_superblocks(
    state: LIOState,
    scan_points: torch.Tensor,  # (T, S, 3)
    scan_mask: torch.Tensor,  # (T, S)
    imu_gyro: torch.Tensor,  # (T, K, 3)
    imu_accel: torch.Tensor,  # (T, K, 3)
    imu_dt: torch.Tensor,  # (T, K)
    gps_pos: torch.Tensor,  # (T, 3)
    gps_var: torch.Tensor,  # (T,)
    gps_valid: torch.Tensor,  # (T,)
    config: LIOConfig = LIOConfig(),
    scan_tau: torch.Tensor | None = None,  # (T, S) sweep fractions for deskew
    valid: torch.Tensor | None = None,  # (T,) tail-padding no-op frames
) -> tuple[LIOState, LIOOutput]:
    """Whole-block loop: ONE K7 launch (ops/lio_superblock_fused.py: EKF
    propagation, point-to-plane GN, pose and GPS Kalman updates) per
    `refresh_every` frames, with the anchor refresh, deskew, pair prologue
    and ring inserts batched per block:

      1. anchor refresh from the ring (as run_lio_blocks);
      2. mean-only IMU dead reckoning -> predicted per-frame poses;
      3. deskew with the dead-reckoned between-frame twists;
      4. pair prologue: predicted-pose source sub-boxes against the anchor's
         sub-boxes, radius dilated by `slack_base + superstep_slack * k`;
      5. the K7 launch;
      6. the K registered scans' ring inserts (within a block the anchor is
         frozen, so deferring them to the block's end equals
         run_lio_blocks' per-frame inserts: they only become visible at the
         next refresh).

    T need not be a multiple of `refresh_every`: the last block is padded
    with no-op frames. Invalid frames must be TRAILING (the ring slots
    assume valid frames are contiguous from the start); a `valid` tensor
    costs one wait for the device a call, to count them. Scans should come
    Morton-PRE-SORTED from the loader (ops/morton.sort_order_numpy(
    isotropic=True), deskew taus riding along), or the pair lists inflate;
    `pair_overflow` shows it."""
    R = config.refresh_every
    T = scan_points.shape[0]
    dev = scan_points.device
    n_valid = T if valid is None else int(valid.sum())
    if valid is None:
        valid = torch.ones((T,), dtype=torch.bool, device=dev)
    arrays = [scan_points, scan_mask, imu_gyro, imu_accel, imu_dt, gps_pos, gps_var]
    if scan_tau is not None:
        arrays.append(scan_tau)
    pad = (-T) % R
    if pad:  # repeat the last frame
        arrays = [torch.cat([a, a[-1:].expand((pad,) + a.shape[1:])]) for a in arrays]
        no = torch.zeros((pad,), dtype=torch.bool, device=dev)
        gps_valid, valid = torch.cat([gps_valid, no]), torch.cat([valid, no])
    sp_all, sm_all, gy_all, ac_all, dt_all, gp_all, gv_all = arrays[:7]
    tau_all = arrays[7] if scan_tau is not None else None

    # the pair-list dilation covers the FULL slack budget the kernel's
    # violation check tolerates: slack_base + slack * k at frame k
    base_r = math.sqrt(config.p2p.max_correspondence_dist_sq) + config.p2p.reassoc_margin
    ks = torch.arange(R, dtype=torch.float32, device=dev)
    radius2 = (base_r + config.slack_base + config.superstep_slack * ks) ** 2
    params = _superblock_params(config)
    SP, window = config.slot_points, config.window

    st = state
    outs = []
    for lo in range(0, T + pad, R):
        blk = slice(lo, lo + R)
        sp, sm, gy, ac, dt = sp_all[blk], sm_all[blk], gy_all[blk], ac_all[blk], dt_all[blk]
        tau = None if tau_all is None else tau_all[blk]
        vld = valid[blk]
        nv = min(max(n_valid - lo, 0), R)

        # 1) anchor refresh
        anchor = _refresh_anchor(st.ring, st.ring_mask, st.ekf_state.p, config)
        cache = anchor[4]
        # 2-4) dead reckoning, deskew, source pages, pair lists
        pred_t, xi, src_pages, pairs, demand, overflow = _block_prologue(
            st, cache, sp, sm, tau, gy, ac, dt, vld, radius2, config
        )
        # 5) the whole-block kernel
        e0 = st.ekf_state
        poses, stats, pose_n, v_n, bg_n, ba_n, P_n = lio_superblock(
            *pairs, vld, gy, ac, dt, gp_all[blk], gv_all[blk], gps_valid[blk], pred_t,
            ekf.pose_matrix(e0), e0.v, e0.bg, e0.ba, e0.P, cache.center, src_pages,
            cache.pages, params,
        )
        # 6) ring inserts of the valid frames, in slot order, into a copy of
        # the ring (the previous state stays valid); with more frames than
        # slots later frames overwrite earlier ones, as one at a time would
        sampled = _ring_sample(sp, sm, tau, xi, config)
        world = (
            torch.einsum("kij,knj->kni", poses[:, :3, :3], sampled.points)
            + poses[:, None, :3, 3]
        )
        ring, ring_mask = st.ring.clone(), st.ring_mask.clone()
        for i in range(nv):
            off = ((st.slot + i) % window) * SP
            ring[off : off + SP] = world[i]
            ring_mask[off : off + SP] = sampled.mask[i]

        st = _with_anchor(
            st._replace(
                ekf_state=ekf.EKFState(
                    p=pose_n[:3, 3], v=v_n, R=pose_n[:3, :3], bg=bg_n, ba=ba_n, P=P_n
                ),
                ring=ring, ring_mask=ring_mask, slot=st.slot + nv, frame=st.frame + nv,
            ),
            anchor,
            _pose_cov6(e0.P),
        )
        outs.append(
            LIOOutput(
                world_T_body=poses,
                rmse=stats[:, 0],
                n_correspondences=stats[:, 1].to(torch.int32),
                refreshed=torch.arange(R, device=dev) == 0,
                gps_accepted=stats[:, 2] > 0.5,
                slack_violation=vld & (stats[:, 4] > 0.5),
                slack_dist=stats[:, 5],
                pair_overflow=overflow,
                pair_demand=demand,
                icp_std_xyz=stats[:, 6:9],
            )
        )
    return st, LIOOutput(*[torch.cat(xs)[:T] for xs in zip(*outs)])
