"""Frozen configuration tree for the whole engine.

Every algorithm constant that the reference hard-codes in constructors or
headers is catalogued here as an explicit field, with the reference source
cited so parity can be audited:

- ICP fine params: localization/src/localization_node.cpp:24-28
- ICP rescue params: localization/src/localization_node.cpp:226-229
- stochastic filter: localization/src/localization_node.cpp:32-35 and
  localization/src/stochastic_filter.cpp:11-12
- brute force: localization/src/localization_node.cpp:39-43 and
  localization/include/localization/brute_force_alignment.h (defaults)
- crop radius / ref re-crop distance: localization/include/localization/
  localization_node.h (cloud_crop_radius_, ref_frame_distance_)
- subsample steps: localization_node.cpp:20 (map, 3), :292 (scan, 2),
  :211 (brute-force map, 15)
- map voxel size: localization_node.cpp:19 (0.1 m)
- max poses for map_T_global: localization_node.cpp:9 (50)
- mapping tile save rate: mapping/include/mapping/map_data_save_node.h (10)

All shapes/capacities are static, as in the JAX package: the port keeps
the same field names and defaults so one config value can drive both
(utils/convert.config_from_fields).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    """Point-to-point ICP parameters.

    Mirrors ICPPointToPoint's ctor args (icp_point_to_point.cpp:3-12).
    NOTE: the reference compares the kd-tree's *squared* NN distance against
    ``max_correspondence_dist`` (icp_point_to_point.cpp:70 — PCL returns
    squared distances), so 0.5 here means an effective radius of ~0.707 m.
    We keep the same convention: the threshold is applied to squared
    distances.
    """

    max_correspondence_dist_sq: float = 0.5
    num_iterations: int = 10
    acceptable_mean_error: float = 0.05
    transformation_epsilon: float = 1e-5
    #: below this many matched correspondences ICP aborts and returns the
    #: prior (icp_point_to_point.cpp:196-200)
    min_correspondences: int = 10
    #: correspondence search backend: radius-gated Morton-tile culling
    #: (exact within the gate, ~10-80x faster than dense) or the dense
    #: distance sweep (ops/nn.py). Gated search assumes spatially coherent
    #: input order (host pre-sort or ops.morton.sort_by_morton) for speed;
    #: it is exact for any order.
    gated: bool = True
    #: correspondence backend name, kept for config parity with the JAX
    #: package; the port always runs the pair-list search (ops/nn_pallas.py)
    nn_backend: str = "pallas"
    tile_src: int = 256
    tile_tgt: int = 512
    #: cap on admissible target tiles per source tile. Sized to the worst
    #: tile of the densest crop observed (49 on the bench world); the
    #: nearest-by-bbox ordering makes truncation drop the farthest tiles
    #: first, and `pair_overflow` reports any truncation downstream.
    max_visits: int = 64
    #: pair-list capacity = max_pairs_factor * n_source_tiles. Kernel work
    #: scales with the ACTUAL number of admissible pairs, not this bound;
    #: the bound costs only SMEM and prologue width.
    max_pairs_factor: int = 16
    #: (pallas path) the tile pair list is built ONCE per alignment with
    #: the gate radius dilated by this margin [m] and reused across lazy
    #: re-associations — exact as long as ICP moves points less than the
    #: margin (per-step corrections are cm-scale against a <=0.7 m gate)
    reassoc_margin: float = 0.5
    #: kept for config parity with the JAX package (its interpret switch)
    pallas_interpret: bool = False
    #: kept for config parity with the JAX package: target tiles per
    #: pair-loop trip there; results are identical for any value
    assoc_unroll: int = 1
    #: "parity" = the reference's exact lazy-re-association control flow
    #: (ops/icp.py); "fast" = fresh-correspondence whole-ICP fused kernel
    #: (ops/icp_fused.py) — the native performance mode
    mode: str = "parity"
    #: points per FINE gating sub-box (ops/nn_gated.subtile_pair_dist2).
    #: Fixed-count Morton tiles go ragged at curve-order discontinuities
    #: and their coarse bboxes over-admit; min-distance over sub-box pairs
    #: recovers the cluster structure (still a superset of the true point
    #: distances, so no admissible pair is ever missed). None = coarse
    #: per-tile boxes. Used by the superblock pair prologue
    #: (models/pipeline_fast.py); must divide tile_src / tile_tgt.
    gate_sub_src: int | None = None
    gate_sub_tgt: int | None = None
    #: export the per-iteration mean-error trace (ICPResult.error_trace)
    #: — the reference's printStepDebug signal under enable_debug
    #: (icp_point_to_point.cpp:171-183). XLA/while-loop engines only.
    debug_trace: bool = False



#: rescue ICP used when brute-force first fix fails
#: (localization_node.cpp:226-229)
RESCUE_ICP = ICPConfig(
    max_correspondence_dist_sq=5.0,
    num_iterations=80,
    acceptable_mean_error=0.4,
    transformation_epsilon=1e-2,
    # the 2.24 m gate admits many more tiles per source tile
    max_visits=64,
    max_pairs_factor=32,
    # metre-scale corrections: the pallas path's movement guard rebuilds
    # the pair list whenever accumulated motion exceeds this margin
    # (ops/icp.py _icp_pallas), so staleness cannot drop true neighbours
    reassoc_margin=0.5,
)


@dataclasses.dataclass(frozen=True)
class BruteForceConfig:
    """4-DoF (x, y, z, yaw) grid-search parameters.

    Node overrides from localization_node.cpp:39-43; the test sequences are
    generated outward from zero exactly like
    brute_force_alignment.cpp:148-180 (including the duplicated 0 entry).
    The per-candidate score is the mean *squared* NN distance
    (brute_force_alignment.cpp:95-105, PCL squared distances), and the
    sequential early-exit keeps the first candidate in nesting order whose
    score beats ``mean_error_threshold``.
    """

    x_step: float = 0.1
    y_step: float = 0.1
    z_step: float = 0.05
    x_range: float = 1.5
    y_range: float = 1.5
    z_range: float = 0.1
    yaw_step: float = 3.141592653589793 / 18.0
    yaw_range: float = 3.141592653589793 / 6.0
    mean_error_threshold: float = 0.1


@dataclasses.dataclass(frozen=True)
class StochasticFilterConfig:
    """Outlier gate on fused pose priors (stochastic_filter.cpp)."""

    queue_size: int = 4
    z_score_threshold: float = 3.0
    #: 5 cm/scan: accelerations from stop (stochastic_filter.cpp:11)
    min_distance_per_scan: float = 0.05
    #: 20 cm/scan: 2 m/s cruise at 10 Hz (stochastic_filter.cpp:12)
    max_distance_per_scan: float = 0.20


@dataclasses.dataclass(frozen=True)
class CloudCapacity:
    """Static array capacities for the fixed-shape device pipeline.

    The reference works on dynamically sized PCL clouds; on the device
    every buffer is padded to a static capacity with a validity mask.
    """

    #: raw scan points fed per frame (after host load)
    scan: int = 32768
    #: cropped scan points entering ICP
    cropped_scan: int = 16384
    #: cropped local map points (ICP target)
    cropped_map: int = 65536
    #: full map cloud resident in device memory
    map: int = 1 << 21
    #: source points used by brute-force scoring
    bf_source: int = 1024
    #: target points used by brute-force scoring
    bf_target: int = 8192


@dataclasses.dataclass(frozen=True)
class LocalizationConfig:
    """Full localization pipeline configuration (mirrors the parameter
    surface of localization_node.cpp:6-9 plus its hard-coded constants)."""

    icp: ICPConfig = dataclasses.field(default_factory=ICPConfig)
    rescue_icp: ICPConfig = dataclasses.field(default_factory=lambda: RESCUE_ICP)
    brute_force: BruteForceConfig = dataclasses.field(default_factory=BruteForceConfig)
    filter: StochasticFilterConfig = dataclasses.field(
        default_factory=StochasticFilterConfig
    )
    capacity: CloudCapacity = dataclasses.field(default_factory=CloudCapacity)

    #: radius crop around the sensor, scan and map (localization_node.h)
    cloud_crop_radius: float = 10.0
    #: the map is Morton pre-sorted ONCE at load (host, Localizer) so the
    #: per-re-crop device sort can be skipped: a compact() of a globally
    #: Z-ordered map preserves spatial tile locality inside the crop.
    #: Order-invariant semantics — gated NN is exact within admitted
    #: pairs and tile admission uses realized point bboxes. False sorts
    #: each crop at re-crop instead (models/localization.recrop).
    presorted_map: bool = True
    #: re-crop the map once we moved this far from the reference frame
    #: (localization_node.cpp:299-305)
    ref_frame_distance: float = 3.0
    #: scan uniform subsample step (localization_node.cpp:292)
    scan_subsample_step: int = 2
    #: apply the scan subsample + Morton pre-sort on the host loader
    #: (build_frame_batch) instead of on device. The subsample happens in
    #: original scan order either way (parity); pre-sorting makes the
    #: gated correspondence search fast without a per-frame device sort —
    #: rigid transforms preserve tile locality, so host order stays good
    #: for the whole ICP.
    host_preprocess: bool = True
    #: map uniform subsample step applied after load (localization_node.cpp:20)
    map_subsample_step: int = 3
    #: extra map subsample for brute force (localization_node.cpp:211)
    brute_force_map_subsample_step: int = 15
    #: merged-map voxel size (localization_node.cpp:19)
    map_voxel_size: float = 0.1
    #: max poses used to solve map_T_global (localization_node.cpp:9)
    max_map_optimization_poses: int = 50
    #: GPS/odom gain mode: covariance traces (False) or fixed 0.95/0.05
    #: (localization_node.cpp:151-161; node calls with fixed=false at :328)
    fixed_gains: bool = False
    enable_debug: bool = False
    #: (fast mode) frames per superblock: the map re-crop check runs once
    #: per superblock and the tile-pair lists for all superstep frames are
    #: built in one vectorized prologue from odometry-predicted poses
    superstep: int = 8
    #: (fast mode) extra pair-list search-radius dilation per frame of
    #: lookahead [m] — bounds the accumulated ICP/blend correction between
    #: the odometry-predicted pose and the true per-frame prior
    superstep_slack: float = 0.08
    #: frame-0 share of the slack budget: the realized prior deviates from
    #: the dead-reckoned prediction even at the block start (GPS blend
    #: pull, stochastic-gate replacement). The slack-violation flag fires
    #: when |prior - prediction| > superstep_slack * k + slack_base.
    slack_base: float = 0.1
    #: extra pair-prologue dilation for the FIRST superblock after
    #: (re)initialization, seeded into PipelineState.extra_slack: the
    #: coarse brute-force pose can be off by up to the fine-acceptance
    #: gate sqrt(max_correspondence_dist_sq) ~= 0.707 m
    #: (localization_node.cpp:307-315), and ICP grinds that error out
    #: over several frames of the first block.
    startup_slack: float = 0.71
    #: run parity-mode ICP (the reference's exact lazy control flow, as
    #: the fused kernel's lazy variant) through the superblock pipeline.
    #: ICP semantics stay reference-exact; only the map re-crop
    #: granularity becomes per-block instead of per-frame. False keeps
    #: the legacy per-frame engine (models/localization.run_chunk).
    superblock_parity: bool = False
    #: (fast mode) run the WHOLE fine loop of each superblock — odometry
    #: prediction, covariance blend, stochastic gate, fused ICP,
    #: predicated state update — in ONE kernel launch
    #: (ops/superblock_fused.py). The port supports only True.
    block_kernel: bool = False


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    """Mapping (map-data recording) configuration.

    Mirrors map_data_save_node parameters and constants:
    tile save rate 10 (map_data_save_node.h), txt log formats
    (map_data_save_node.cpp:84-98).
    """

    cloud_save_rate: int = 10
    map_voxel_size: float = 0.1
    #: odometry standstill threshold used when filtering calibration poses
    #: (global_map_frames_manager.cpp:168: odom xy-norm < 0.1)
    standstill_xy_norm: float = 0.1
    max_map_optimization_poses: int = 50
    #: the PYTHON builder's standstill criterion differs from the C++
    #: node's: it counts the CONSECUTIVE INITIAL poses whose full 3D
    #: odometry norm is < 0.5 m and stops at the first mover
    #: (optimize_global_map_pose.py:19,21-32) — no altitude filter
    prefix_standstill_norm: float = 0.5
