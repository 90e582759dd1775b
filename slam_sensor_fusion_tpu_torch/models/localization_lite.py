"""The "lite" localization pipeline, twin of the reference's Python node
(port of the JAX `models/localization_lite.py`).

The reference ships a simplified Python prototype beside the C++ node
(localization_python/localization_python/localization_node.py) with
deliberately different semantics, all reproduced here:

* fixed fusion weights 0.2 GPS / 0.8 odometry (:212-215), no covariance
  weighting and no stochastic gate;
* LEFT-composed odometry prediction (odom_cur @ odom_prev^-1) @
  map_T_sensor (:161-167); the C++ node right-composes;
* the scan filtered by a forward axis-aligned box [0..15] x [-7.5..7.5] x
  [0..7.5] in the sensor frame (:53-57, 105-115);
* the map cropped by an ORIENTED box of extent (30, 15, 15) at the coarse
  pose (:222-225), every frame;
* ICP from the coarse pose with a 0.5 m TRUE-distance threshold (0.25
  squared), up to 30 iterations, fresh correspondences per iteration:
  K3 against the whole map's pages, masked by the crop (:231-243);
* no startup brute force: the first GPS fix initializes the pose.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from slam_sensor_fusion_tpu_torch.ops import cloud as cl
from slam_sensor_fusion_tpu_torch.ops import geometry as geo
from slam_sensor_fusion_tpu_torch.ops.icp import icp_align
from slam_sensor_fusion_tpu_torch.ops.icp_fused import icp_align_fused
from slam_sensor_fusion_tpu_torch.ops.morton import sort_points_numpy
from slam_sensor_fusion_tpu_torch.utils.config import ICPConfig


@dataclasses.dataclass(frozen=True)
class LiteConfig:
    """Constants of the Python twin (localization_node.py:52-57, 212-215)."""

    gps_weight: float = 0.2
    bbox_side: float = 15.0
    #: open3d's threshold is a true distance; the gate here is squared
    icp: ICPConfig = dataclasses.field(
        default_factory=lambda: ICPConfig(
            max_correspondence_dist_sq=0.25,
            num_iterations=30,
            # open3d convergence: relative change thresholds; fresh
            # correspondences every iteration == fast mode
            acceptable_mean_error=0.0,
            transformation_epsilon=1e-6,
            mode="fast",
        )
    )
    scan_capacity: int = 16384
    cropped_map_capacity: int = 65536


class LiteState(NamedTuple):
    map_T_sensor: torch.Tensor
    odom_T_sensor_previous: torch.Tensor


class LiteOutput(NamedTuple):
    map_T_sensor: torch.Tensor
    map_T_sensor_coarse: torch.Tensor
    icp_error: torch.Tensor
    n_correspondences: torch.Tensor
    #: the OBB map crop is empty: the twin skips the WHOLE frame ("not
    #: localizing", localization_node.py:226-228), neither map_T_sensor
    #: nor odom_previous_T_sensor is updated
    cropped_map_empty: torch.Tensor


def init_state(first_gps_pose: torch.Tensor, first_odom_pose: torch.Tensor) -> LiteState:
    return LiteState(map_T_sensor=first_gps_pose, odom_T_sensor_previous=first_odom_pose)


def lite_step(
    state: LiteState,
    scan_points: torch.Tensor,
    scan_mask: torch.Tensor,
    odom_T_sensor: torch.Tensor,
    map_T_sensor_gps: torch.Tensor,
    map_cloud: cl.Cloud,
    config: LiteConfig = LiteConfig(),
) -> tuple[LiteState, LiteOutput]:
    """One frame of the Python twin (syncCallback, :193-269)."""
    side = config.bbox_side
    dev = scan_points.device
    # LEFT-composed prediction (:161-167)
    delta = odom_T_sensor @ geo.inv_T(state.odom_T_sensor_previous)
    map_T_sensor_odom = delta @ state.map_T_sensor

    w = config.gps_weight
    coarse = w * map_T_sensor_gps + (1.0 - w) * map_T_sensor_odom  # (:212-215)

    def vec(*x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    scan = cl.crop_box(
        cl.Cloud(scan_points, scan_mask), vec(0.0, -side / 2, 0.0), vec(side, side / 2, side / 2)
    )
    cropped_map = cl.crop_obb(map_cloud, coarse, vec(side * 2, side, side))

    icp_fn = icp_align_fused if config.icp.mode == "fast" else icp_align
    res = icp_fn(
        scan.points, scan.mask, cropped_map.points, cropped_map.mask, coarse, config.icp
    )

    # an empty cropped map makes the frame a FULL no-op: the twin warns and
    # returns before the ICP, the publish AND the odom_previous update
    # (localization_node.py:226-228, 248-255)
    empty = cropped_map.count() == 0
    new_state = LiteState(
        map_T_sensor=torch.where(empty, state.map_T_sensor, res.transformation),
        odom_T_sensor_previous=torch.where(empty, state.odom_T_sensor_previous, odom_T_sensor),
    )
    return new_state, LiteOutput(
        map_T_sensor=new_state.map_T_sensor,
        map_T_sensor_coarse=coarse,
        icp_error=torch.where(empty, 0.0, res.error),
        n_correspondences=torch.where(empty, 0, res.n_correspondences),
        cropped_map_empty=empty,
    )


def run_lite(
    map_points: np.ndarray,
    scans: list[np.ndarray],
    odom_T_sensor: np.ndarray,
    map_T_sensor_gps: np.ndarray,
    config: LiteConfig = LiteConfig(),
    device: torch.device | str = torch.device("cuda"),
) -> np.ndarray:
    """Host loop: the first frame initializes, the rest are steps.

    Returns the (T, 4, 4) trajectory (frame 0 holds the GPS init pose). The
    map is used at full resolution (Morton-sorted once); GPS poses come
    precomputed with raw altitudes."""
    map_cloud = cl.from_numpy(
        sort_points_numpy(map_points),
        1 << int(np.ceil(np.log2(max(len(map_points), 1024)))),
        device,
    )

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    T = len(scans)
    out = np.tile(np.eye(4, dtype=np.float32), (T, 1, 1))
    out[0] = map_T_sensor_gps[0]
    state = init_state(f32(map_T_sensor_gps[0]), f32(odom_T_sensor[0]))
    S = config.scan_capacity
    for k in range(1, T):
        sc = sort_points_numpy(scans[k])
        buf = np.zeros((S, 3), np.float32)
        n = min(len(sc), S)
        buf[:n] = sc[:n]
        msk = np.zeros(S, bool)
        msk[:n] = True
        state, o = lite_step(
            state, f32(buf), torch.from_numpy(msk).to(device), f32(odom_T_sensor[k]),
            f32(map_T_sensor_gps[k]), map_cloud, config,
        )
        out[k] = o.map_T_sensor.cpu().numpy()
    return out
