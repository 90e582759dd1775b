"""Top-level API: the equivalent of the reference's two ROS nodes, on the
card (port of the JAX `api.py`).

* `build_map(...)` — the mapping product (map_data_saver node +
  GlobalMapFramesManager build path): record scan tiles + pose logs,
  produce the merged voxel map and the map<-global datum. Host work, as in
  the JAX package.
* `localize(...)` — the localization product (localization_node): replay
  time-aligned sensor streams against a map_data directory on `device`
  (the card unless the caller asks for the CPU) and return the map-frame
  trajectory.

Parameter surface mirrors the reference's node parameters
(localization_node.cpp:6-9 / launch args in
localization/launch/localization_launch.py): map_data_path, map_name,
enable_debug, max_map_optimization_poses — plus the engine's capacity and
algorithm config tree (utils/config.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from slam_sensor_fusion_tpu_torch.models.localization import LocalizationResult, Localizer
from slam_sensor_fusion_tpu_torch.models.mapping import MapData, StreamingMapper
from slam_sensor_fusion_tpu_torch.utils import mapdata, timesync
from slam_sensor_fusion_tpu_torch.utils.config import LocalizationConfig, MappingConfig


def build_map(
    scans_map_frame: list[np.ndarray],
    odom_positions: np.ndarray,
    gps_lat: np.ndarray,
    gps_lon: np.ndarray,
    gps_alt: np.ndarray,
    compass_yaw: np.ndarray,
    map_data_path: str | None = None,
    config: MappingConfig = MappingConfig(),
) -> MapData:
    """Record a mapping run and build its MapData.

    Scans arrive registered in the map frame (the `/cloud_registered`
    stream the reference's recorder consumes, map_data_save_node.cpp:53).
    When ``map_data_path`` is given, the tile/log directory is written in
    the reference's exact on-disk layout.
    """
    mapper = StreamingMapper(config)
    for i, scan in enumerate(scans_map_frame):
        mapper.add_frame(
            scan,
            np.asarray(odom_positions[i]),
            float(gps_lat[i]),
            float(gps_lon[i]),
            float(gps_alt[i]),
            float(compass_yaw[i]),
        )
    md = mapper.finalize()
    if map_data_path is not None:
        mapdata.save_map_data(
            map_data_path,
            mapper.tiles,
            np.stack(mapper.odom_positions),
            np.stack(mapper.gps_rows),
        )
    return md


def localize(
    scans: list[np.ndarray],
    odom_T_sensor: np.ndarray,
    gps_lat: np.ndarray,
    gps_lon: np.ndarray,
    gps_alt: np.ndarray,
    compass_heading_deg: np.ndarray | None = None,
    compass_yaw: np.ndarray | None = None,
    map_data: MapData | None = None,
    map_data_path: str | None = None,
    map_name: str = "map",
    odom_cov_trace: np.ndarray | None = None,
    gps_cov_trace: np.ndarray | None = None,
    config: LocalizationConfig = LocalizationConfig(),
    max_map_optimization_poses: int | None = None,
    device: torch.device | str = torch.device("cuda"),
) -> LocalizationResult:
    """Run the full localization pipeline over aligned sensor streams on
    `device`.

    Streams must be time-aligned per frame (use utils.timesync.align for
    raw logs). Provide either a MapData or a map_data directory. Compass
    input is either raw ArduPilot headings in degrees (converted via the
    reference's (90 - hdg) rule, localization_node.cpp:66-77) or
    already-converted ENU yaw radians.
    """
    if map_data is None:
        if map_data_path is None:
            raise ValueError("need map_data or map_data_path")
        mcfg = MappingConfig(
            map_voxel_size=config.map_voxel_size,
            max_map_optimization_poses=(
                max_map_optimization_poses or config.max_map_optimization_poses
            ),
        )
        map_data = mapdata.load_map_data(map_data_path, map_name, mcfg)

    if compass_yaw is None:
        if compass_heading_deg is None:
            raise ValueError("need compass_yaw or compass_heading_deg")
        h = np.asarray(compass_heading_deg, np.float64)
        compass_yaw = np.mod(np.deg2rad(90.0 - h) + np.pi, 2 * np.pi) - np.pi

    T = len(scans)
    if odom_cov_trace is None:
        odom_cov_trace = np.full(T, 0.03)
    if gps_cov_trace is None:
        gps_cov_trace = np.full(T, 1.0)

    loc = Localizer(map_data, config, device)
    return loc.run(
        scans,
        np.asarray(odom_T_sensor, np.float32),
        np.asarray(gps_lat, np.float64),
        np.asarray(gps_lon, np.float64),
        np.asarray(gps_alt, np.float64),
        np.asarray(compass_yaw, np.float64),
        np.asarray(odom_cov_trace, np.float32),
        np.asarray(gps_cov_trace, np.float32),
    )


@dataclasses.dataclass
class RawStreams:
    """Unaligned sensor logs with per-sample timestamps (the offline form
    of the ROS topic streams)."""

    scan_t: np.ndarray
    scans: list[np.ndarray]
    gps_t: np.ndarray
    gps_lat: np.ndarray
    gps_lon: np.ndarray
    gps_alt: np.ndarray
    gps_cov_trace: np.ndarray
    odom_t: np.ndarray
    odom_T_sensor: np.ndarray
    odom_cov_trace: np.ndarray
    compass_t: np.ndarray
    compass_heading_deg: np.ndarray


def localize_streams(
    streams: RawStreams,
    slop: float = 0.1,
    **kwargs,
) -> LocalizationResult:
    """Align raw streams (ApproximateTime semantics, C13) then localize;
    `kwargs` go to `localize` (map, config, device)."""
    al = timesync.align(
        streams.scan_t, streams.gps_t, streams.odom_t, streams.compass_t, slop
    )
    return localize(
        scans=[streams.scans[i] for i in al.scan_idx],
        odom_T_sensor=streams.odom_T_sensor[al.odom_idx],
        gps_lat=streams.gps_lat[al.gps_idx],
        gps_lon=streams.gps_lon[al.gps_idx],
        gps_alt=streams.gps_alt[al.gps_idx],
        compass_heading_deg=streams.compass_heading_deg[al.compass_idx],
        odom_cov_trace=streams.odom_cov_trace[al.odom_idx],
        gps_cov_trace=streams.gps_cov_trace[al.gps_idx],
        **kwargs,
    )
