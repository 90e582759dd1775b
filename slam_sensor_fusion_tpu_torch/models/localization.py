"""The localization pipeline: per-scan fusion step, startup and sequence
replay (port of the JAX `models/localization.py`).

Rebuild of LocalizationNode (localization/src/localization_node.cpp):

* `init_state` — initializePosesWithFirstReading (:181-198);
* `coarse_attempt` — one attempt of the startup ladder: brute force on
  floor-removed, extra-subsampled clouds, and on failure a loose "rescue"
  ICP from the best candidate (:200-261);
* `step` — one steady-state callback (:263-374): scan crop, predicated map
  re-crop, odometry prediction, covariance-weighted blend, stochastic gate,
  ICP (K3 in fast mode, the K2 parity ICP otherwise), pose update;
  `run_chunk` loops it over a chunk of frames;
* `Localizer.run` — replay of a whole sequence: the startup ladder per
  frame, then the steady state in chunks, per frame (`run_chunk`) or by
  superblocks (models/pipeline_fast.run_chunk_fast).

Parity notes (quirks preserved):
* the prior is an ELEMENT-WISE blend of two 4x4 pose matrices (:329);
* gains swap the covariance traces (odom_gain = gps_trace / sum, :172-178);
* frames with GPS altitude < 0 are skipped entirely (:269-276);
* the map is re-cropped only after moving ref_frame_distance from the last
  crop pose (:299-305).

Branches on device values (`if need:`) read the value back to the host:
one sync each, where the JAX package used `lax.cond` or a select.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
from typing import NamedTuple

import numpy as np
import torch

from slam_sensor_fusion_tpu_torch.models.mapping import MapData, gps_to_map_poses
from slam_sensor_fusion_tpu_torch.ops import cloud as cl
from slam_sensor_fusion_tpu_torch.ops import geometry as geo
from slam_sensor_fusion_tpu_torch.ops import morton
from slam_sensor_fusion_tpu_torch.ops import stochastic_filter as sf
from slam_sensor_fusion_tpu_torch.ops.brute_force import brute_force_align
from slam_sensor_fusion_tpu_torch.ops.icp import ICPResult, icp_align
from slam_sensor_fusion_tpu_torch.ops.icp_fused import (
    TARGET_SENTINEL,
    CachedTarget,
    build_cached_target,
    icp_align_fused,
)
from slam_sensor_fusion_tpu_torch.utils.config import LocalizationConfig

_log = logging.getLogger("slam_sensor_fusion_tpu_torch")


class FrameBatch(NamedTuple):
    """Time-aligned sensor arrays for a chunk of frames (leading axis T)."""

    scan_points: torch.Tensor  # (T, S, 3)
    scan_mask: torch.Tensor  # (T, S)
    odom_T_sensor: torch.Tensor  # (T, 4, 4)
    map_T_sensor_gps: torch.Tensor  # (T, 4, 4) precomputed GPS coarse poses
    odom_cov_trace: torch.Tensor  # (T,)
    gps_cov_trace: torch.Tensor  # (T,)
    valid: torch.Tensor  # (T,) bool — GPS altitude >= 0 gate


class PipelineState(NamedTuple):
    """Everything the reference keeps as node members, carried from frame
    to frame (or superblock to superblock)."""

    map_T_sensor: torch.Tensor  # (4, 4)
    odom_T_sensor_previous: torch.Tensor  # (4, 4)
    map_T_ref: torch.Tensor  # (4, 4) pose of the last map crop
    cropped_map: cl.Cloud  # fixed-capacity ICP target
    filter_state: sf.FilterState
    #: target pages/bboxes for the ICP, rebuilt only at re-crop
    cached_target: CachedTarget
    #: () f32 — extra pair-prologue dilation for the FIRST superblock after
    #: (re)initialization (the coarse pose can be off by up to the fine
    #: acceptance gate, localization_node.cpp:307-315); reset to 0 after
    #: one valid block
    extra_slack: torch.Tensor


class StepOutput(NamedTuple):
    map_T_sensor: torch.Tensor  # (4, 4) posterior
    map_T_sensor_prior: torch.Tensor  # (4, 4) fused prior
    map_T_sensor_odom: torch.Tensor  # (4, 4) odometry prediction
    icp_error: torch.Tensor
    icp_iterations: torch.Tensor
    icp_converged: torch.Tensor
    n_correspondences: torch.Tensor
    recropped: torch.Tensor  # bool
    #: the correspondence visit/pair list was truncated this frame
    pair_overflow: torch.Tensor
    #: min det of K1's / K3's Kabsch moment matrix (0 on the K2 path)
    icp_det_min: torch.Tensor
    #: superblock only (None on the per-frame engine): the realized prior
    #: drifted from the dead-reckoned prediction the pair prologue used by
    #: more than that frame's dilation budget
    slack_violation: torch.Tensor | None = None
    #: superblock only: realized |prior - prediction| translation drift
    slack_dist: torch.Tensor | None = None
    #: per-iteration ICP error (None: the port has no engine that exports
    #: it, see ops/icp.ICPResult.error_trace)
    icp_error_trace: torch.Tensor | None = None
    #: superblock only: admissible (src, tgt) tile pairs before capacity
    #: clipping
    pair_demand: torch.Tensor | None = None


def join_outputs(outs: list[StepOutput], join) -> StepOutput:
    """StepOutputs joined field by field with `join` (torch.stack for
    per-frame outputs, torch.cat for per-block ones); None stays None."""
    return StepOutput(*[None if xs[0] is None else join(list(xs)) for xs in zip(*outs)])


def init_state(
    config: LocalizationConfig,
    map_capacity: int,
    first_gps_pose: torch.Tensor,
    first_odom_pose: torch.Tensor,
) -> PipelineState:
    """initializePosesWithFirstReading (localization_node.cpp:181-198):
    pose from the first valid GPS fix, odometry reference recorded, map
    crop left empty so the first processed frame populates it."""
    del map_capacity
    dev = first_gps_pose.device
    f32 = torch.float32
    cap = config.capacity.cropped_map
    tn = config.icp.tile_tgt
    sub = config.icp.gate_sub_tgt
    return PipelineState(
        map_T_sensor=first_gps_pose,
        odom_T_sensor_previous=first_odom_pose,
        map_T_ref=first_gps_pose,
        cropped_map=cl.Cloud(
            torch.zeros((cap, 3), dtype=f32, device=dev),
            torch.zeros((cap,), dtype=torch.bool, device=dev),
        ),
        filter_state=sf.init_state(config.filter, dev),
        # empty boxes (lo > hi) can never pair; the first frame re-crops
        cached_target=CachedTarget(
            pages=torch.full((cap // tn, 3, tn), TARGET_SENTINEL, dtype=f32, device=dev),
            lo=torch.full((cap // tn, 3), torch.inf, dtype=f32, device=dev),
            hi=torch.full((cap // tn, 3), -torch.inf, dtype=f32, device=dev),
            center=torch.zeros(3, dtype=f32, device=dev),
            sub_lo=(
                torch.full((cap // sub, 3), torch.inf, dtype=f32, device=dev)
                if sub is not None else None
            ),
            sub_hi=(
                torch.full((cap // sub, 3), -torch.inf, dtype=f32, device=dev)
                if sub is not None else None
            ),
        ),
        extra_slack=torch.tensor(config.startup_slack, dtype=f32, device=dev),
    )


def recrop(
    map_cloud: cl.Cloud, center: torch.Tensor, config: LocalizationConfig
) -> tuple[cl.Cloud, CachedTarget]:
    """Map re-crop around `center` (localization_node.cpp:299-305): the
    radius crop compacted into the fixed ICP target buffer, plus its target
    pages. With config.presorted_map the map was Morton-sorted once at load
    (`Localizer`) and the order-preserving compact keeps that tile
    locality; otherwise the crop is Morton-sorted here, once a re-crop, as
    the JAX package does (localization.py:208-211)."""
    mask = cl.crop_radius(map_cloud, center, config.cloud_crop_radius)
    packed = cl.compact(mask, config.capacity.cropped_map)
    if not config.presorted_map:
        packed = morton.sort_by_morton(packed)
    cache = build_cached_target(
        packed.points, packed.mask, center, config.icp.tile_tgt,
        gate_sub=config.icp.gate_sub_tgt,
    )
    return packed, cache


def _preprocess(
    state: PipelineState,
    scan_points: torch.Tensor,
    scan_mask: torch.Tensor,
    map_cloud: cl.Cloud,
    config: LocalizationConfig,
):
    """Scan subsample + crop, and predicated map re-crop
    (localization_node.cpp:285-305). Returns (cropped_scan, cropped_map,
    cached_target, map_T_ref, recropped)."""
    scan = cl.Cloud(scan_points, scan_mask)
    if not config.host_preprocess:
        scan = cl.uniform_subsample(scan, config.scan_subsample_step)
    cropped_scan = cl.crop_radius(
        scan, torch.zeros(3, dtype=torch.float32, device=scan_points.device),
        config.cloud_crop_radius,
    )
    sensor_T_ref = geo.inv_T(state.map_T_sensor) @ state.map_T_ref
    moved = torch.linalg.norm(sensor_T_ref[:3, 3]) > config.ref_frame_distance
    need = moved | (state.cropped_map.count() == 0)
    if bool(need):
        cropped_map, cached_target = recrop(map_cloud, state.map_T_sensor[:3, 3], config)
        map_T_ref = state.map_T_sensor
    else:
        cropped_map, cached_target = state.cropped_map, state.cached_target
        map_T_ref = state.map_T_ref
    return cropped_scan, cropped_map, cached_target, map_T_ref, need


def _pose_gains(odom_cov_trace, gps_cov_trace, config: LocalizationConfig):
    """computePoseGainsFromCovarianceMatrices (localization_node.cpp:151-179):
    each source's gain is the OTHER's covariance trace, normalized."""
    if config.fixed_gains:
        return 0.95, 0.05
    total = odom_cov_trace + gps_cov_trace
    return gps_cov_trace / total, odom_cov_trace / total


def _prior(
    pose: torch.Tensor,
    odom_prev: torch.Tensor,
    filter_state: sf.FilterState,
    odom_T_sensor: torch.Tensor,
    map_T_sensor_gps: torch.Tensor,
    odom_cov_trace: torch.Tensor,
    gps_cov_trace: torch.Tensor,
    config: LocalizationConfig,
) -> tuple[torch.Tensor, torch.Tensor, sf.FilterState]:
    """The fine alignment's prior (localization_node.cpp:317-330): the
    odometry prediction right-composed onto the posterior (:106-109), the
    covariance-weighted element-wise blend with the GPS pose, then the
    stochastic filter's push and gate. Returns (prior, odometry
    prediction, filter state)."""
    previous_T_current = geo.inv_T(odom_prev) @ odom_T_sensor
    map_T_sensor_odom = pose @ previous_T_current
    odom_gain, gps_gain = _pose_gains(odom_cov_trace, gps_cov_trace, config)
    prior = odom_gain * map_T_sensor_odom + gps_gain * map_T_sensor_gps
    filter_state = sf.add_pose(filter_state, prior, config.filter)
    prior = sf.apply_gate(filter_state, pose, prior, config.filter)
    return prior, map_T_sensor_odom, filter_state


def skipped_output(map_T_sensor: torch.Tensor) -> StepOutput:
    """An invalid frame's outputs: zeros, with the posterior carried."""
    dev = map_T_sensor.device
    zeros44 = torch.zeros((4, 4), dtype=torch.float32, device=dev)
    f0 = torch.zeros((), dtype=torch.float32, device=dev)
    i0 = torch.zeros((), dtype=torch.int32, device=dev)
    b0 = torch.zeros((), dtype=torch.bool, device=dev)
    return StepOutput(
        map_T_sensor=map_T_sensor, map_T_sensor_prior=zeros44, map_T_sensor_odom=zeros44,
        icp_error=f0, icp_iterations=i0, icp_converged=b0, n_correspondences=i0,
        recropped=b0, pair_overflow=b0, icp_det_min=f0,
    )


def _fine(
    state: PipelineState,
    cropped_scan: cl.Cloud,
    cropped_map: cl.Cloud,
    cached_target: CachedTarget,
    map_T_ref: torch.Tensor,
    recropped: torch.Tensor,
    odom_T_sensor: torch.Tensor,
    map_T_sensor_gps: torch.Tensor,
    odom_cov_trace: torch.Tensor,
    gps_cov_trace: torch.Tensor,
    config: LocalizationConfig,
) -> tuple[PipelineState, StepOutput]:
    """The FINE ALIGNMENT section (localization_node.cpp:317-341): the
    prior (`_prior`), then ICP — K3 with the cached target in fast mode,
    the K2 parity ICP otherwise."""
    prior, map_T_sensor_odom, filter_state = _prior(
        state.map_T_sensor, state.odom_T_sensor_previous, state.filter_state,
        odom_T_sensor, map_T_sensor_gps, odom_cov_trace, gps_cov_trace, config,
    )

    if config.icp.mode == "fast":
        icp: ICPResult = icp_align_fused(
            cropped_scan.points, cropped_scan.mask, cropped_map.points,
            cropped_map.mask, prior, config.icp, cached_target=cached_target,
        )
    else:
        icp = icp_align(
            cropped_scan.points, cropped_scan.mask, cropped_map.points,
            cropped_map.mask, prior, config.icp,
        )
    dev = prior.device
    new_state = PipelineState(
        map_T_sensor=icp.transformation,
        odom_T_sensor_previous=odom_T_sensor,
        map_T_ref=map_T_ref,
        cropped_map=cropped_map,
        filter_state=filter_state,
        cached_target=cached_target,
        extra_slack=state.extra_slack,
    )
    out = StepOutput(
        map_T_sensor=icp.transformation,
        map_T_sensor_prior=prior,
        map_T_sensor_odom=map_T_sensor_odom,
        icp_error=icp.error,
        icp_iterations=icp.iterations,
        icp_converged=icp.has_converged,
        n_correspondences=icp.n_correspondences,
        recropped=torch.as_tensor(recropped, dtype=torch.bool, device=dev),
        pair_overflow=torch.as_tensor(icp.pair_overflow, dtype=torch.bool, device=dev),
        icp_det_min=torch.as_tensor(icp.det_min, dtype=torch.float32, device=dev),
        icp_error_trace=icp.error_trace,
    )
    return new_state, out


def step(
    state: PipelineState,
    scan_points: torch.Tensor,
    scan_mask: torch.Tensor,
    odom_T_sensor: torch.Tensor,
    map_T_sensor_gps: torch.Tensor,
    odom_cov_trace: torch.Tensor,
    gps_cov_trace: torch.Tensor,
    valid: torch.Tensor,
    map_cloud: cl.Cloud,
    config: LocalizationConfig,
) -> tuple[PipelineState, StepOutput]:
    """One full steady-state localization callback. An invalid frame (GPS
    altitude < 0) is a full no-op (:269-276): the state is carried, the
    outputs are zero and map_T_sensor carries the last posterior. The JAX
    package computes the frame and selects; the port reads `valid` back
    (one sync) and skips the ICP, with the same results."""
    if not bool(valid):
        return state, skipped_output(state.map_T_sensor)
    cropped_scan, cropped_map, cached_target, map_T_ref, recropped = _preprocess(
        state, scan_points, scan_mask, map_cloud, config
    )
    return _fine(
        state, cropped_scan, cropped_map, cached_target, map_T_ref, recropped,
        odom_T_sensor, map_T_sensor_gps, odom_cov_trace, gps_cov_trace, config,
    )


def run_chunk(
    state: PipelineState,
    frames: FrameBatch,
    map_cloud: cl.Cloud,
    config: LocalizationConfig,
) -> tuple[PipelineState, StepOutput]:
    """`step` over a chunk of frames (the JAX package's lax.scan), carrying
    the state. Outputs are stacked per frame."""
    outs = []
    for k in range(frames.valid.shape[0]):
        state, out = step(state, *[x[k] for x in frames], map_cloud, config)
        outs.append(out)
    return state, join_outputs(outs, torch.stack)


class CoarseOutput(NamedTuple):
    success: torch.Tensor
    map_T_sensor: torch.Tensor  # accepted pose if success, else best guess
    bf_success: torch.Tensor
    score: torch.Tensor


def coarse_attempt(
    state: PipelineState,
    scan_points: torch.Tensor,
    scan_mask: torch.Tensor,
    map_cloud: cl.Cloud,
    guess: torch.Tensor,
    config: LocalizationConfig,
):
    """One coarse-alignment attempt on one frame: brute force on floor-
    removed, extra-subsampled clouds; on failure the rescue ICP from the
    best candidate (localization_node.cpp:200-261). Returns (cropped_map,
    cached_target, map_T_ref, cropped_scan, CoarseOutput)."""
    cropped_scan, cropped_map, cached_target, map_T_ref, _ = _preprocess(
        state, scan_points, scan_mask, map_cloud, config
    )
    bf_map, bf_scan = brute_force_clouds(cropped_scan, cropped_map, map_T_ref, config)
    bf = brute_force_align(
        bf_scan.points, bf_scan.mask, bf_map.points, bf_map.mask, guess,
        config.brute_force,
    )
    if bool(bf.success):
        success, pose = bf.success, bf.transformation
    else:
        res = icp_align(
            bf_scan.points, bf_scan.mask, bf_map.points, bf_map.mask,
            bf.transformation, config.rescue_icp,
        )
        success, pose = res.has_converged, res.transformation
    return (
        cropped_map,
        cached_target,
        map_T_ref,
        cropped_scan,
        CoarseOutput(
            success=success,
            map_T_sensor=pose if bool(success) else bf.transformation,
            bf_success=bf.success,
            score=bf.score,
        ),
    )


def brute_force_clouds(
    cropped_scan: cl.Cloud,
    cropped_map: cl.Cloud,
    map_T_ref: torch.Tensor,
    config: LocalizationConfig,
) -> tuple[cl.Cloud, cl.Cloud]:
    """The brute-force (and rescue-ICP) inputs: subsample(map, step) +
    removeFloor(both) (localization_node.cpp:207-213). The crop is re-
    ordered by distance first, like the reference's kd-tree radius search
    returns it, so the index-based subsample picks the same range-stratified
    subset."""
    bf_map = cl.sample_to_capacity(
        cl.remove_floor(
            cl.uniform_subsample(
                cl.compact_by_distance(cropped_map, map_T_ref[:3, 3]),
                config.brute_force_map_subsample_step,
            )
        ),
        config.capacity.bf_target,
    )
    bf_scan = cl.sample_to_capacity(cl.remove_floor(cropped_scan), config.capacity.bf_source)
    return bf_map, bf_scan


def build_frame_batch(
    config: LocalizationConfig,
    scans: list[np.ndarray],
    odom_T_sensor: np.ndarray,
    map_T_sensor_gps: np.ndarray,
    odom_cov_trace: np.ndarray,
    gps_cov_trace: np.ndarray,
    valid: np.ndarray,
    device: torch.device | str = torch.device("cuda"),
) -> FrameBatch:
    """Pad per-frame host scans into stacked tensors on `device`. With
    config.host_preprocess the loader applies the reference's uniform
    subsample (original scan order, localization_node.cpp:292) and Morton
    pre-sorts the result."""
    S = config.capacity.scan
    T = len(scans)
    pts = np.zeros((T, S, 3), np.float32)
    msk = np.zeros((T, S), bool)
    for i, sc in enumerate(scans):
        if config.host_preprocess:
            if len(sc) >= config.scan_subsample_step:
                sc = sc[:: config.scan_subsample_step]
            sc = morton.sort_points_numpy(sc)
        n = min(len(sc), S)
        pts[i, :n] = sc[:n]
        msk[i, :n] = True

    def f32(a):  # host builders hand f64; the device pipeline is f32
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    return FrameBatch(
        scan_points=f32(pts),
        scan_mask=torch.from_numpy(msk).to(device),
        odom_T_sensor=f32(odom_T_sensor),
        map_T_sensor_gps=f32(map_T_sensor_gps),
        odom_cov_trace=f32(odom_cov_trace),
        gps_cov_trace=f32(gps_cov_trace),
        valid=torch.from_numpy(np.asarray(valid, bool)).to(device),
    )


@dataclasses.dataclass
class LocalizationResult:
    map_T_sensor: np.ndarray  # (T, 4, 4); frames before startup hold init pose
    valid: np.ndarray  # (T,) which frames produced a posterior
    icp_error: np.ndarray
    icp_iterations: np.ndarray
    icp_converged: np.ndarray
    n_correspondences: np.ndarray
    first_processed_frame: int


class Localizer:
    """End-to-end localization session over a map (the node equivalent):
    the map load path, the GPS pose stream and the replay entry point `run`."""

    def __init__(
        self,
        map_data: MapData,
        config: LocalizationConfig = LocalizationConfig(),
        device: torch.device | str = torch.device("cuda"),
    ):
        self.config = config
        self.map_data = map_data
        self.device = torch.device(device)
        # voxel-downsampled merged map, uniform-subsampled on the host
        # (localization_node.cpp:19-20), Morton-sorted ONCE so every
        # re-crop keeps tile locality through an order-preserving compact
        pts = map_data.map_points[:: config.map_subsample_step]
        if config.presorted_map:
            pts = morton.sort_points_numpy(np.asarray(pts, np.float32))
        cap = 1 << int(np.ceil(np.log2(max(len(pts), 1024))))
        self.map_cloud = cl.from_numpy(pts, cap, self.device)

    def gps_poses(self, lat, lon, compass_yaw) -> np.ndarray:
        return gps_to_map_poses(self.map_data, lat, lon, compass_yaw)

    def _tensor(self, a) -> torch.Tensor:
        """A host array as float32 on the session's device."""
        return torch.from_numpy(np.asarray(a, np.float32)).to(self.device)

    def run(
        self,
        scans: list[np.ndarray],
        odom_T_sensor: np.ndarray,
        gps_lat: np.ndarray,
        gps_lon: np.ndarray,
        gps_alt: np.ndarray,
        compass_yaw: np.ndarray,
        odom_cov_trace: np.ndarray,
        gps_cov_trace: np.ndarray,
        chunk: int = 64,
        debug_dir: str | None = None,
    ) -> LocalizationResult:
        """Replay a full sequence: startup gating and the coarse ladder per
        frame (like the reference's per-callback retries), then the steady
        state in chunks of `chunk` frames: by superblocks
        (pipeline_fast.run_chunk_fast) in fast mode or with
        superblock_parity, else per frame (`run_chunk`).

        With ``config.enable_debug`` this mirrors the reference node's
        debug branch (localization_node.cpp:348-373): wall-clock "CALLBACK
        TOOK" logs per chunk (StageTimer), and — when ``debug_dir`` is
        given — per-chunk export of the transformed cropped scan and the
        current cropped map (the two debug cloud topics, :354-372) plus a
        refreshed map/trajectory artifact (the Python twin's 5-second map
        republish, localization_node.py:96,174-183). Debug output reads
        results back; it changes none of them."""
        cfg = self.config
        timer = None
        if cfg.enable_debug:
            from slam_sensor_fusion_tpu_torch.utils.profiling import StageTimer

            timer = StageTimer()
            if debug_dir is not None:
                os.makedirs(debug_dir, exist_ok=True)
        T = len(scans)
        valid = np.asarray(gps_alt) >= 0
        gps_T = self.gps_poses(gps_lat, gps_lon, compass_yaw)

        out_T = np.tile(np.eye(4, dtype=np.float32), (T, 1, 1))
        out_valid = np.zeros(T, bool)
        out_err = np.zeros(T, np.float32)
        out_iters = np.zeros(T, np.int32)
        out_conv = np.zeros(T, bool)
        out_ncorr = np.zeros(T, np.int32)

        # ---- startup: first valid GPS fix initializes the pose ----
        first = int(np.argmax(valid)) if valid.any() else T
        if first >= T:
            return LocalizationResult(out_T, out_valid, out_err, out_iters, out_conv, out_ncorr, T)
        state = init_state(
            cfg, self.map_cloud.capacity, self._tensor(gps_T[first]),
            self._tensor(odom_T_sensor[first]),
        )
        out_T[: first + 1] = gps_T[first]

        # ---- coarse ladder: retry per frame until success ----
        i = first + 1
        guess = self._tensor(gps_T[first])
        coarse_done = False
        while i < T and not coarse_done:
            if not valid[i]:
                i += 1
                continue
            frame = build_frame_batch(
                cfg, [scans[i]], odom_T_sensor[i : i + 1], gps_T[i : i + 1],
                odom_cov_trace[i : i + 1], gps_cov_trace[i : i + 1], valid[i : i + 1],
                self.device,
            )
            cropped_map, cached_target, map_T_ref, cropped_scan, coarse = coarse_attempt(
                state, frame.scan_points[0], frame.scan_mask[0], self.map_cloud, guess, cfg
            )
            state = state._replace(
                cropped_map=cropped_map, cached_target=cached_target, map_T_ref=map_T_ref
            )
            if bool(coarse.success):
                coarse_done = True
                state = state._replace(map_T_sensor=coarse.map_T_sensor)
                # fine alignment runs in the same frame (:311-341)
                state, out = _fine(
                    state, cropped_scan, state.cropped_map, state.cached_target,
                    state.map_T_ref, False, frame.odom_T_sensor[0],
                    frame.map_T_sensor_gps[0], frame.odom_cov_trace[0],
                    frame.gps_cov_trace[0], cfg,
                )
                self._record(out, i, out_T, out_valid, out_err, out_iters, out_conv, out_ncorr)
            else:
                # next attempt searches around the best candidate
                # (brute_force_alignment.cpp:125-126)
                guess = coarse.map_T_sensor
                out_T[i] = state.map_T_sensor.cpu().numpy()
            i += 1

        # ---- steady state, in chunks ----
        use_fast = cfg.host_preprocess and (
            cfg.icp.mode == "fast" or (cfg.icp.mode == "parity" and cfg.superblock_parity)
        )
        from slam_sensor_fusion_tpu_torch.models.pipeline_fast import (
            build_paged_frames,
            run_chunk_fast,
        )

        while i < T:
            j = min(i + chunk, T)
            n = j - i
            # the chunk's wall clock: the reads of its outputs end it
            with timer.stage("chunk") if timer is not None else contextlib.nullcontext():
                if use_fast:
                    # pad the tail to whole superblocks with invalid no-op frames
                    pad = (-n) % cfg.superstep

                    def padded(a):
                        a = np.asarray(a)
                        return np.concatenate([a[i:j]] + [a[i : i + 1]] * pad)

                    frames = build_paged_frames(
                        cfg, scans[i:j] + [scans[i]] * pad, padded(odom_T_sensor),
                        padded(gps_T), padded(odom_cov_trace), padded(gps_cov_trace),
                        np.concatenate([valid[i:j], np.zeros(pad, bool)]), self.device,
                    )
                    state, outs = run_chunk_fast(state, frames, self.map_cloud, cfg)
                else:
                    frames = build_frame_batch(
                        cfg, scans[i:j], odom_T_sensor[i:j], gps_T[i:j],
                        odom_cov_trace[i:j], gps_cov_trace[i:j], valid[i:j], self.device,
                    )
                    state, outs = run_chunk(state, frames, self.map_cloud, cfg)
                out_valid[i:j] = frames.valid.cpu().numpy()[:n]
                out_T[i:j] = outs.map_T_sensor.cpu().numpy()[:n]
                out_err[i:j] = outs.icp_error.cpu().numpy()[:n]
                out_iters[i:j] = outs.icp_iterations.cpu().numpy()[:n]
                out_conv[i:j] = outs.icp_converged.cpu().numpy()[:n]
                out_ncorr[i:j] = outs.n_correspondences.cpu().numpy()[:n]
            if timer is not None:
                # the reference's "CALLBACK TOOK %f seconds" debug log
                # (localization_node.cpp:350-353), amortized per frame
                elapsed = timer.last
                _log.info(
                    "CALLBACK TOOK %f seconds (chunk of %d frames: %.3fs)",
                    elapsed / max(n, 1), n, elapsed,
                )
                if outs.icp_error_trace is not None:
                    # the reference's per-iteration printStepDebug lines
                    # (icp_point_to_point.cpp:171-183)
                    for f, tr in enumerate(outs.icp_error_trace.cpu().numpy()[:n]):
                        for it, e in enumerate(tr):
                            if np.isnan(e):
                                break
                            _log.info(
                                "[ICP INFO] frame %d iteration %d - Error: %f",
                                i + f, it, float(e),
                            )
                if debug_dir is not None:
                    self._emit_debug(debug_dir, state, scans, out_T, i, j)
            i = j

        if timer is not None:
            _log.info("debug timing report:\n%s", timer.report())
        return LocalizationResult(out_T, out_valid, out_err, out_iters, out_conv, out_ncorr, first)

    def _emit_debug(
        self,
        debug_dir: str,
        state: PipelineState,
        scans: list[np.ndarray],
        out_T: np.ndarray,
        i: int,
        j: int,
    ) -> None:
        """Debug cloud republication, offline equivalent of the reference's
        enable_debug branch: the cropped scan transformed into the map frame
        and the current cropped map (localization_node.cpp:354-372, the map
        copied back from the card), plus a refreshed map + trajectory
        artifact standing in for the Python twin's 5-second map republish
        timer (localization_node.py:96,174-183)."""
        from slam_sensor_fusion_tpu_torch.utils import viz

        cfg = self.config
        k = j - 1  # last frame of the chunk
        sc = np.asarray(scans[k], np.float32).reshape(-1, 3)
        if cfg.scan_subsample_step > 1 and len(sc) >= cfg.scan_subsample_step:
            sc = sc[:: cfg.scan_subsample_step]
        keep = np.linalg.norm(sc, axis=1) <= cfg.cloud_crop_radius
        T_k = out_T[k]
        scan_map = sc[keep] @ T_k[:3, :3].T + T_k[:3, 3]
        viz.write_ply(
            os.path.join(debug_dir, "cropped_scan_map_frame.ply"),
            scan_map,
            color=(255, 80, 40),
        )
        cm_pts = state.cropped_map.points.cpu().numpy()
        cm_msk = state.cropped_map.mask.cpu().numpy()
        viz.write_ply(
            os.path.join(debug_dir, "cropped_map.ply"),
            cm_pts[cm_msk],
            color=(120, 160, 255),
        )
        map_path = os.path.join(debug_dir, "map.ply")
        if not os.path.exists(map_path):
            viz.write_ply(map_path, self.map_data.map_points)
        viz.plot_topdown(
            os.path.join(debug_dir, "trajectory.svg"),
            out_T[:j],
            map_points=self.map_data.map_points,
        )
        # interactive replay viewer (rviz-config equivalent, SURVEY C15)
        viz.write_html_viewer(
            os.path.join(debug_dir, "viewer.html"),
            map_points=self.map_data.map_points,
            est_poses=out_T[:j],
            scan_points=scan_map,
        )

    @staticmethod
    def _record(out: StepOutput, i, out_T, out_valid, out_err, out_iters, out_conv, out_ncorr):
        out_T[i] = out.map_T_sensor.cpu().numpy()
        out_valid[i] = True
        out_err[i] = float(out.icp_error)
        out_iters[i] = int(out.icp_iterations)
        out_conv[i] = bool(out.icp_converged)
        out_ncorr[i] = int(out.n_correspondences)
