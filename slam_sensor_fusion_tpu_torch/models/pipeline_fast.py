"""Steady-state pipeline: host-paged frames + K-frame superblocks (port of
the JAX `models/pipeline_fast.py`).

* All per-frame scan preprocessing — uniform subsample in original scan
  order (localization_node.cpp:292), 10 m radius crop, Morton sort,
  (nSt, 3, TM) page packing with +1e7 sentinels, per-tile bboxes — happens
  once in the host loader (`build_paged_frames`).
* The map re-crop check runs once per K-frame SUPERBLOCK, triggered by the
  odometry-PREDICTED end-of-block pose (a conservative superset of the
  per-frame trigger, localization_node.cpp:299-305).
* The tile-pair lists of all K frames come from ONE vectorized prologue on
  odometry-predicted poses, dilated per frame (`superstep_slack`) plus the
  exactly known GPS-blend pull; `_slack_check` flags any frame whose
  realized prior left that budget.
* The fine loop of the superblock is ONE K1 launch
  (ops/superblock_fused.superblock_fine) with `block_kernel=True`, else a
  per-frame loop with one K3 launch a valid frame
  (ops/icp_fused.icp_align_fused_paged; lazy ICP in parity mode).

The re-crop branch reads its condition back to the host (one sync per
superblock, where the JAX package used `lax.cond`); the per-frame loop
reads the block's valid flags once.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from slam_sensor_fusion_tpu_torch.models.localization import (
    PipelineState,
    StepOutput,
    _pose_gains,
    _prior,
    join_outputs,
    recrop,
    skipped_output,
)
from slam_sensor_fusion_tpu_torch.ops import cloud as cl
from slam_sensor_fusion_tpu_torch.ops import geometry as geo
from slam_sensor_fusion_tpu_torch.ops import morton
from slam_sensor_fusion_tpu_torch.ops import stochastic_filter as sf
from slam_sensor_fusion_tpu_torch.ops.icp_fused import CachedTarget, icp_align_fused_paged
from slam_sensor_fusion_tpu_torch.ops.nn_gated import (
    bbox_pair_dist2,
    pair_demand_from_d2,
    pair_tiles_from_d2,
    subtile_pair_dist2,
)
from slam_sensor_fusion_tpu_torch.ops.nn_pallas import _build_tile_pair_list
from slam_sensor_fusion_tpu_torch.ops.superblock_fused import superblock_fine
from slam_sensor_fusion_tpu_torch.utils.config import LocalizationConfig

_FAR = 1.0e7  # sentinel for invalid source points (see ops/nn_pallas.py)


class PagedFrames(NamedTuple):
    """Host-prestaged per-frame inputs in page layout."""

    src_pages: torch.Tensor  # (T, nSt, 3, TM) sensor frame, invalid -> +_FAR
    src_lo: torch.Tensor  # (T, nSt, 3) per-tile bbox minima (sensor frame)
    src_hi: torch.Tensor  # (T, nSt, 3)
    src_cnt: torch.Tensor  # (T, nSt) int32 valid points per tile
    odom_T_sensor: torch.Tensor  # (T, 4, 4)
    map_T_sensor_gps: torch.Tensor  # (T, 4, 4)
    odom_cov_trace: torch.Tensor  # (T,)
    gps_cov_trace: torch.Tensor  # (T,)
    valid: torch.Tensor  # (T,) bool


def build_paged_frames(
    config: LocalizationConfig,
    scans: list[np.ndarray],
    odom_T_sensor: np.ndarray,
    map_T_sensor_gps: np.ndarray,
    odom_cov_trace: np.ndarray,
    gps_cov_trace: np.ndarray,
    valid: np.ndarray,
    device: torch.device | str = torch.device("cuda"),
) -> PagedFrames:
    """Prestage frames: subsample -> 10 m crop -> Morton sort -> pages.

    The subsample keeps every k-th point in ORIGINAL scan order; the crop
    keeps d2 <= r^2 around the sensor origin. Every array is cast to f32
    (int32, bool) on the host before it moves to `device`."""
    S = config.capacity.cropped_scan
    TM = config.icp.tile_src
    if S % TM:
        raise ValueError(f"cropped_scan capacity {S} not divisible by tile {TM}")
    nSt = S // TM
    T = len(scans)
    r2 = config.cloud_crop_radius * config.cloud_crop_radius

    pages = np.full((T, nSt, 3, TM), _FAR, np.float32)
    lo = np.zeros((T, nSt, 3), np.float32)
    hi = np.zeros((T, nSt, 3), np.float32)
    cnt = np.zeros((T, nSt), np.int32)
    row = np.arange(TM)
    for i, sc in enumerate(scans):
        sc = np.asarray(sc, np.float32).reshape(-1, 3)
        if len(sc) >= config.scan_subsample_step:
            sc = sc[:: config.scan_subsample_step]
        sc = sc[np.einsum("ij,ij->i", sc, sc) <= r2]
        sc = morton.sort_points_numpy(sc)
        n = min(len(sc), S)
        buf = np.full((S, 3), _FAR, np.float32)
        buf[:n] = sc[:n]
        pages[i] = buf.reshape(nSt, TM, 3).transpose(0, 2, 1)
        c = np.clip(n - np.arange(nSt) * TM, 0, TM).astype(np.int32)
        cnt[i] = c
        tiles = buf.reshape(nSt, TM, 3)
        vrow = (row[None, :] < c[:, None])[:, :, None]
        lo[i] = np.where(vrow, tiles, np.inf).min(axis=1)
        hi[i] = np.where(vrow, tiles, -np.inf).max(axis=1)
        # empty tiles: a degenerate point box (filtered by cnt == 0 anyway;
        # finite values keep the corner transform NaN-free)
        lo[i, c == 0] = 0.0
        hi[i, c == 0] = 0.0

    def dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return PagedFrames(
        src_pages=dev(pages, np.float32),
        src_lo=dev(lo, np.float32),
        src_hi=dev(hi, np.float32),
        src_cnt=dev(cnt, np.int32),
        odom_T_sensor=dev(odom_T_sensor, np.float32),
        map_T_sensor_gps=dev(map_T_sensor_gps, np.float32),
        odom_cov_trace=dev(odom_cov_trace, np.float32),
        gps_cov_trace=dev(gps_cov_trace, np.float32),
        valid=dev(valid, bool),
    )


# 8 bbox corner selectors (True -> take hi on that axis)
_CORNER_SEL = np.array([[(k >> a) & 1 for a in range(3)] for k in range(8)], bool)


@functools.lru_cache(maxsize=None)
def _corner_sel(device: torch.device) -> torch.Tensor:
    """The (8, 3) box-corner selector, uploaded once per device (a tensor
    made from host data inside a loop would wait for the device)."""
    return torch.from_numpy(_CORNER_SEL).to(device)


def _transformed_tile_boxes(pred: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """AABBs of per-tile boxes under per-frame rigid transforms:
    pred (K,4,4); lo/hi (K,nSt,3) in the sensor frame -> map frame. The
    rotated-box hull dilates the true point hull, so pair admissibility
    stays a superset."""
    # inverted (empty) boxes -> far POINT boxes before the corner transform:
    # mixed ±inf corners would turn into NaNs under the rotation
    emp = (lo > hi).any(dim=-1, keepdim=True)
    lo = torch.where(emp, _FAR, lo)
    hi = torch.where(emp, _FAR, hi)
    sel = _corner_sel(lo.device)
    corners = torch.where(sel[None, None], hi[:, :, None, :], lo[:, :, None, :])
    wc = (
        torch.einsum("kij,kscj->ksci", pred[:, :3, :3], corners)
        + pred[:, None, None, :3, 3]
    )
    return wc.amin(dim=2), wc.amax(dim=2)


def _page_subboxes(pages: torch.Tensor, cnt: torch.Tensor, gate_sub: int):
    """Fine gating sub-boxes from page-layout frames: pages (K, nSt, 3, TM)
    with valid-first rows, cnt (K, nSt) -> (lo, hi) of shape
    (K, nSt * TM // gate_sub, 3). Empty sub-groups give inverted boxes."""
    K, nSt, _, TM = pages.shape
    q = TM // gate_sub
    grp = pages.reshape(K, nSt, 3, q, gate_sub)
    row = torch.arange(TM, device=pages.device).reshape(q, gate_sub)
    valid = (row[None, None] < cnt[..., None, None])[:, :, None]
    lo = torch.where(valid, grp, torch.inf).amin(dim=4)
    hi = torch.where(valid, grp, -torch.inf).amax(dim=4)
    lo = lo.permute(0, 1, 3, 2).reshape(K, nSt * q, 3)
    hi = hi.permute(0, 1, 3, 2).reshape(K, nSt * q, 3)
    return lo, hi


def _slack_check(priors, pred, valid, config: LocalizationConfig, gps_pull):
    """Superstep slack-violation observability: the pair prologue built
    frame k's list from the dead-reckoned prediction, dilated by
    `slack_base + superstep_slack * k + gps_pull[k]`; flag frames whose
    REALIZED prior drifted further (translation only)."""
    K = priors.shape[0]
    slack_dist = torch.linalg.norm(priors[:, :3, 3] - pred[:, :3, 3], dim=1)
    budget = (
        config.slack_base
        + config.superstep_slack
        * torch.arange(K, dtype=torch.float32, device=priors.device)
        + gps_pull
    )
    viol = valid & (slack_dist > budget)
    return torch.where(valid, slack_dist, 0.0), viol


class Prologue(NamedTuple):
    """A superblock's inputs to K1 and what the step reports beside it."""

    cropped_map: cl.Cloud
    cached_target: CachedTarget
    map_T_ref: torch.Tensor
    need: torch.Tensor  # () bool: re-cropped at this block
    pred: torch.Tensor  # (K, 4, 4) odometry-predicted poses
    gps_pull: torch.Tensor  # (K,)
    pair_start: torch.Tensor  # (K, nSt)
    pair_cnt: torch.Tensor  # (K, nSt)
    pair_tgt: torch.Tensor  # (K, max_pairs)
    pair_ovf: torch.Tensor  # (K,) bool
    demand: torch.Tensor  # (K,) int32
    any_valid: torch.Tensor  # () bool


def superstep_prologue(
    state: PipelineState,
    blk: PagedFrames,
    map_cloud: cl.Cloud,
    config: LocalizationConfig,
) -> Prologue:
    """Odometry-predicted poses, the once-per-block re-crop and the
    vectorized pair prologue of one superblock (pipeline_fast.py:288-384)."""
    K = blk.valid.shape[0]
    icp_cfg = config.icp
    nSt = blk.src_pages.shape[1]
    max_pairs = nSt * icp_cfg.max_pairs_factor

    # ---- odometry-predicted poses for the whole block ----
    inv_prev = geo.inv_T(state.odom_T_sensor_previous)
    deltas = torch.einsum("ij,kjl->kil", inv_prev, blk.odom_T_sensor)
    pred = torch.einsum("ij,kjl->kil", state.map_T_sensor, deltas)

    # ---- map re-crop, once per block (localization_node.cpp:299-305) ----
    any_valid = blk.valid.any()
    end_dist = torch.linalg.norm(pred[-1, :3, 3] - state.map_T_ref[:3, 3])
    empty = state.cropped_map.count() == 0
    need = ((end_dist > config.ref_frame_distance) | empty) & any_valid
    center_pose = pred[K // 2]  # mid-block: best coverage of the block
    if bool(need):
        cropped_map, cached_target = recrop(map_cloud, center_pose[:3, 3], config)
        map_T_ref = center_pose
    else:
        cropped_map, cached_target = state.cropped_map, state.cached_target
        map_T_ref = state.map_T_ref

    # ---- pair lists for all K frames in one vectorized prologue ----
    # dilation: gate + in-ICP margin, slack_base + slack * k of realized
    # drift, and the per-frame GPS blend pull, which the prologue knows
    # exactly; its running max bounds a pull carried past an aborted ICP
    base_r = math.sqrt(icp_cfg.max_correspondence_dist_sq) + icp_cfg.reassoc_margin
    _, gps_gain = _pose_gains(blk.odom_cov_trace, blk.gps_cov_trace, config)
    gps_pull = gps_gain * torch.linalg.norm(
        blk.map_T_sensor_gps[:, :3, 3] - pred[:, :3, 3], dim=1
    )
    gps_pull = torch.where(blk.valid, gps_pull, 0.0)
    gps_pull = torch.cummax(gps_pull, dim=0).values + state.extra_slack
    radius2 = (
        base_r
        + config.slack_base
        + config.superstep_slack * torch.arange(K, dtype=torch.float32, device=pred.device)
        + gps_pull
    ) ** 2
    if icp_cfg.gate_sub_src is not None and cached_target.sub_lo is not None:
        slo, shi = _page_subboxes(blk.src_pages, blk.src_cnt, icp_cfg.gate_sub_src)
        slo_w, shi_w = _transformed_tile_boxes(pred, slo, shi)
        d2_tiles = subtile_pair_dist2(
            slo_w, shi_w, cached_target.sub_lo, cached_target.sub_hi,
            nSt, cached_target.lo.shape[0],
        )
    else:
        lo_s, hi_s = _transformed_tile_boxes(pred, blk.src_lo, blk.src_hi)
        d2_tiles = bbox_pair_dist2(lo_s, hi_s, cached_target.lo, cached_target.hi)
    visits, counts, v_ovf = pair_tiles_from_d2(
        d2_tiles, blk.src_cnt, radius2, icp_cfg.max_visits
    )
    demand = pair_demand_from_d2(d2_tiles, blk.src_cnt, radius2)
    pair_start, pair_cnt, pair_tgt = _build_tile_pair_list(visits, counts, max_pairs)
    return Prologue(
        cropped_map=cropped_map,
        cached_target=cached_target,
        map_T_ref=map_T_ref,
        need=need,
        pred=pred,
        gps_pull=gps_pull,
        pair_start=pair_start,
        pair_cnt=pair_cnt,
        pair_tgt=pair_tgt,
        pair_ovf=v_ovf | (demand > max_pairs),
        demand=demand,
        any_valid=any_valid,
    )


def _fine_per_frame(
    state: PipelineState, blk: PagedFrames, pro: Prologue, config: LocalizationConfig
) -> tuple[torch.Tensor, torch.Tensor, sf.FilterState, StepOutput]:
    """The superblock's fine loop frame by frame, one K3 launch a valid
    frame (pipeline_fast.py:437-502): prediction, blend, gate and ICP
    against the block's cached target, carrying pose, odometry reference
    and filter state. An invalid frame carries the state and outputs zeros
    (the JAX package computes and selects; the port skips its ICP)."""
    pose, odom_prev, filt = (
        state.map_T_sensor, state.odom_T_sensor_previous, state.filter_state
    )
    outs = []
    for k, v in enumerate(blk.valid.tolist()):
        if not v:
            outs.append(skipped_output(pose))
            continue
        prior, map_T_sensor_odom, filt_new = _prior(
            pose, odom_prev, filt, blk.odom_T_sensor[k], blk.map_T_sensor_gps[k],
            blk.odom_cov_trace[k], blk.gps_cov_trace[k], config,
        )
        icp = icp_align_fused_paged(
            blk.src_pages[k], pro.pair_start[k], pro.pair_cnt[k], pro.pair_tgt[k],
            prior, pro.cached_target, config.icp, pair_overflow=pro.pair_ovf[k],
            lazy=config.icp.mode == "parity",
        )
        pose, odom_prev, filt = icp.transformation, blk.odom_T_sensor[k], filt_new
        outs.append(StepOutput(
            map_T_sensor=pose,
            map_T_sensor_prior=prior,
            map_T_sensor_odom=map_T_sensor_odom,
            icp_error=icp.error,
            icp_iterations=icp.iterations,
            icp_converged=icp.has_converged,
            n_correspondences=icp.n_correspondences,
            recropped=torch.zeros((), dtype=torch.bool, device=pose.device),  # set per block
            pair_overflow=icp.pair_overflow,
            icp_det_min=icp.det_min,
        ))
    return pose, odom_prev, filt, join_outputs(outs, torch.stack)


def _superstep(
    state: PipelineState,
    blk: PagedFrames,
    map_cloud: cl.Cloud,
    config: LocalizationConfig,
) -> tuple[PipelineState, StepOutput]:
    """One K-frame superblock: re-crop once, one pair prologue, then the
    fine loop as one K1 launch (block_kernel) or one K3 launch a frame."""
    K = blk.valid.shape[0]
    pro = superstep_prologue(state, blk, map_cloud, config)
    if config.block_kernel:
        fs = state.filter_state
        (
            poses, priors, odom_preds, stats,
            pose_n, odom_prev_n, trans_n, count_n, fprev_n,
        ) = superblock_fine(
            blk.src_pages, pro.pair_start, pro.pair_cnt, pro.pair_tgt, blk.valid,
            blk.odom_T_sensor, blk.map_T_sensor_gps,
            blk.odom_cov_trace, blk.gps_cov_trace,
            state.map_T_sensor, state.odom_T_sensor_previous,
            fs.transitions, fs.count, fs.previous_pose,
            pro.cached_target.center, pro.cached_target.pages, config,
        )
        filt_n = sf.FilterState(transitions=trans_n, count=count_n, previous_pose=fprev_n)
        outs = StepOutput(
            map_T_sensor=poses,
            map_T_sensor_prior=priors,
            map_T_sensor_odom=odom_preds,
            icp_error=stats[:, 0],
            icp_iterations=stats[:, 1].to(torch.int32),
            icp_converged=stats[:, 3] > 0.5,
            n_correspondences=stats[:, 2].to(torch.int32),
            recropped=pro.need,
            pair_overflow=blk.valid & pro.pair_ovf,
            icp_det_min=stats[:, 4],
        )
    else:
        pose_n, odom_prev_n, filt_n, outs = _fine_per_frame(state, blk, pro, config)
    slack_dist, slack_viol = _slack_check(
        outs.map_T_sensor_prior, pro.pred, blk.valid, config, pro.gps_pull
    )
    first = torch.arange(K, device=blk.valid.device) == 0
    outs = outs._replace(
        recropped=pro.need & first,
        slack_violation=slack_viol,
        slack_dist=slack_dist,
        pair_demand=torch.where(blk.valid, pro.demand, 0),
    )
    new_state = PipelineState(
        map_T_sensor=pose_n,
        odom_T_sensor_previous=odom_prev_n,
        map_T_ref=pro.map_T_ref,
        cropped_map=pro.cropped_map,
        filter_state=filt_n,
        cached_target=pro.cached_target,
        extra_slack=torch.where(pro.any_valid, 0.0, state.extra_slack),
    )
    return new_state, outs


def run_chunk_fast(
    state: PipelineState,
    frames: PagedFrames,
    map_cloud: cl.Cloud,
    config: LocalizationConfig,
) -> tuple[PipelineState, StepOutput]:
    """Superblocks over a chunk of host-paged frames, carrying the state.

    T must be a multiple of config.superstep (callers pad the tail with
    valid=False no-op frames). Outputs are stacked per frame."""
    K = config.superstep
    T = frames.valid.shape[0]
    if T % K:
        raise ValueError(f"chunk length {T} not a multiple of superstep {K}")
    outs = []
    for b in range(T // K):
        blk = PagedFrames(*[x[b * K : (b + 1) * K] for x in frames])
        state, out = _superstep(state, blk, map_cloud, config)
        outs.append(out)
    return state, join_outputs(outs, torch.cat)
