"""Map-data management: tile merging, map_T_global solve, altitude table.

Host-side rebuild of GlobalMapFramesManager
(localization/src/global_map_frames_manager.cpp) and the mapping recorder's
artifacts (mapping/src/map_data_save_node.cpp). These run once at startup on
f64 host math (UTM magnitudes), producing the map arrays and
the map_T_global datum that rebases all GPS data into f32-safe map-frame
coordinates — the same centring trick the reference gets implicitly from
composing map_T_global (global_map_frames_manager.cpp:224-246).

A NumPy copy of the JAX package's host map build, and its online recorder
`StreamingMapper`, whose device path streams every frame into one of the
port's device voxel stores (ops/voxel_map, ops/voxel_map_sorted).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from slam_sensor_fusion_tpu_torch.ops.cloud import voxel_downsample_numpy
from slam_sensor_fusion_tpu_torch.ops.utm import ll_to_utm
from slam_sensor_fusion_tpu_torch.ops.voxel_map import (
    VoxelMapConfig,
    voxel_map_centroids_numpy,
    voxel_map_init,
    voxel_map_insert,
)
from slam_sensor_fusion_tpu_torch.ops.voxel_map_sorted import (
    SortedVoxelMapConfig,
    sorted_voxel_map_centroids_numpy,
    sorted_voxel_map_init,
    sorted_voxel_map_insert,
)
from slam_sensor_fusion_tpu_torch.utils.config import MappingConfig


@dataclasses.dataclass
class MapData:
    """Everything the localization pipeline needs from a mapping run."""

    map_points: np.ndarray  # (N, 3) float32, voxel-downsampled map cloud
    map_T_global: np.ndarray  # (4, 4) float64
    altitude_table: np.ndarray  # (K, 3) float64 rows (lat, lon, alt)


def _rot_z(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def merge_tiles(tiles: list[np.ndarray], voxel_size: float = 0.1) -> np.ndarray:
    """Concatenate scan tiles and voxel-downsample — the host
    mergeScansAndSave (global_map_frames_manager.cpp:110-151)."""
    if not tiles:
        return np.zeros((0, 3), np.float32)
    merged = np.concatenate([np.asarray(t, np.float32).reshape(-1, 3) for t in tiles])
    return voxel_downsample_numpy(merged, voxel_size)


def build_altitude_table(gps_rows: np.ndarray) -> np.ndarray:
    """Rows (lat, lon, alt, yaw) -> altitude lookup rows with alt > 0
    (global_map_frames_manager.cpp:59-64; note: UNfiltered by odometry)."""
    gps_rows = np.asarray(gps_rows, np.float64).reshape(-1, 4)
    keep = gps_rows[:, 2] > 0
    return gps_rows[keep, :3]


def closest_altitude(table: np.ndarray, lat: float, lon: float) -> float:
    """Nearest-neighbour altitude in raw lat/lon degrees
    (global_map_frames_manager.cpp:69-91). Empty table -> 0."""
    if table.shape[0] == 0:
        return 0.0
    d = np.hypot(table[:, 0] - lat, table[:, 1] - lon)
    return float(table[np.argmin(d), 2])


def closest_altitude_batch(table: np.ndarray, lat: np.ndarray, lon: np.ndarray) -> np.ndarray:
    """Nearest-neighbour altitude in raw lat/lon degrees for each (lat,
    lon) (global_map_frames_manager.cpp:69-91). Empty table -> 0."""
    if table.shape[0] == 0:
        return np.zeros_like(np.asarray(lat, np.float64))
    d = np.hypot(
        table[None, :, 0] - np.asarray(lat)[:, None],
        table[None, :, 1] - np.asarray(lon)[:, None],
    )
    return table[np.argmin(d, axis=1), 2]


def solve_map_T_global(
    odom_positions: np.ndarray,
    gps_rows: np.ndarray,
    config: MappingConfig = MappingConfig(),
) -> np.ndarray:
    """Solve the map<-global datum from standstill calibration poses.

    Port of GlobalMapFramesManager::getMapTGlobal/computeMapTGlobal
    (global_map_frames_manager.cpp:182-248): keep rows where the odometry
    xy-norm < 0.1 m AND altitude > 0, take the first <= num_poses_max, mean
    the UTM translations and compass yaws, build global_T_map = (Rz(yaw),
    t_mean) and return its inverse. Like the reference, proceeds even when
    the filter leaves <= 3 poses and returns identity when it leaves none.
    """
    odom_positions = np.asarray(odom_positions, np.float64).reshape(-1, 3)
    gps_rows = np.asarray(gps_rows, np.float64).reshape(-1, 4)
    n = min(len(odom_positions), len(gps_rows))
    if len(odom_positions) != len(gps_rows):
        # reference errors and keeps both vectors as-is; truncate defensively
        odom_positions, gps_rows = odom_positions[:n], gps_rows[:n]
    keep = (np.linalg.norm(odom_positions[:, :2], axis=1) < config.standstill_xy_norm) & (
        gps_rows[:, 2] > 0
    )
    rows = gps_rows[keep][: config.max_map_optimization_poses]
    if rows.shape[0] == 0:
        return np.eye(4)

    e, nn = ll_to_utm(rows[:, 0], rows[:, 1])
    global_t_map = np.stack([e, nn, rows[:, 2]], axis=1).mean(axis=0)
    yaw_avg = rows[:, 3].mean()

    map_R_global = _rot_z(-yaw_avg)
    map_T_global = np.eye(4)
    map_T_global[:3, :3] = map_R_global
    map_T_global[:3, 3] = -map_R_global @ global_t_map
    return map_T_global


def standstill_prefix_count(
    odom_positions: np.ndarray,
    config: MappingConfig = MappingConfig(),
) -> int:
    """The Python builder's calibration-pose selection: count the
    CONSECUTIVE INITIAL odometry rows with full 3D norm below 0.5 m,
    stopping at the first row that exceeds it
    (optimize_global_map_pose.py:21-32 `load_odom_positions`).

    This differs from the C++ node's filter (solve_map_T_global above):
    xy-only vs 3D norm, 0.1 vs 0.5 m, scattered-keep vs prefix-break,
    and no altitude > 0 requirement.
    """
    odom_positions = np.asarray(odom_positions, np.float64).reshape(-1, 3)
    norms = np.linalg.norm(odom_positions, axis=1)
    moving = norms >= config.prefix_standstill_norm
    return int(np.argmax(moving)) if moving.any() else len(norms)


def solve_map_T_global_prefix(
    odom_positions: np.ndarray,
    gps_imu_rows: np.ndarray,
    config: MappingConfig = MappingConfig(),
) -> np.ndarray:
    """map_T_global as the PYTHON map builder solves it
    (optimize_global_map_pose.py:68-99 `optimize_map_T_global`).

    Differences from the C++ solve (solve_map_T_global):

    * calibration poses are the standstill PREFIX (3D norm < 0.5 m,
      break at the first mover; :21-32) min'd with the GPS row count and
      the 50-pose cap (:75-77) — not the C++ scattered odom-xy/alt filter;
    * attitude rows carry full (roll, pitch, yaw) euler-XYZ angles
      (:39-45 "lat lon alt r p y"), meaned per-component and turned into
      a rotation via R.from_euler('xyz') (:80-84) — 4-column C++-format
      rows (lat, lon, alt, yaw) are accepted as (0, 0, yaw);
    * altitudes are used unfiltered (no alt > 0 gate).
    """
    odom_positions = np.asarray(odom_positions, np.float64).reshape(-1, 3)
    gps_imu_rows = np.asarray(gps_imu_rows, np.float64)
    if gps_imu_rows.ndim == 1:
        gps_imu_rows = gps_imu_rows.reshape(1, -1)
    if gps_imu_rows.shape[1] == 4:  # C++ log format: lat lon alt yaw
        rpy = np.zeros((len(gps_imu_rows), 3))
        rpy[:, 2] = gps_imu_rows[:, 3]
    else:  # python format: lat lon alt r p y
        rpy = gps_imu_rows[:, 3:6]

    n_poses = min(
        standstill_prefix_count(odom_positions, config),
        len(gps_imu_rows),
        config.max_map_optimization_poses,
    )
    if n_poses == 0:
        return np.eye(4)

    mean_rpy = rpy[:n_poses].mean(axis=0)
    e, nn = ll_to_utm(gps_imu_rows[:n_poses, 0], gps_imu_rows[:n_poses, 1])
    mean_t = np.stack([e, nn, gps_imu_rows[:n_poses, 2]], axis=1).mean(axis=0)

    # R.from_euler('xyz', rpy) == Rz(y) @ Ry(p) @ Rx(r) (extrinsic xyz)
    r, p, y = mean_rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    global_R_map = _rot_z(y) @ Ry @ Rx

    global_T_map = np.eye(4)
    global_T_map[:3, :3] = global_R_map
    global_T_map[:3, 3] = mean_t
    return np.linalg.inv(global_T_map)


def build_map_data(
    tiles: list[np.ndarray],
    odom_positions: np.ndarray,
    gps_rows: np.ndarray,
    config: MappingConfig = MappingConfig(),
    use_prefix_solver: bool = False,
) -> MapData:
    """One-stop map build from a mapping run's artifacts.

    ``use_prefix_solver=True`` selects the Python builder's datum solve
    (standstill-prefix calibration poses + euler-mean attitude,
    optimize_global_map_pose.py:68-99) instead of the C++ node's
    (global_map_frames_manager.cpp:182-248).
    """
    solve = solve_map_T_global_prefix if use_prefix_solver else solve_map_T_global
    return MapData(
        map_points=merge_tiles(tiles, config.map_voxel_size),
        map_T_global=solve(odom_positions, gps_rows, config),
        altitude_table=build_altitude_table(gps_rows),
    )


def gps_to_map_poses(
    map_data: MapData,
    lat: np.ndarray,
    lon: np.ndarray,
    compass_yaw: np.ndarray,
) -> np.ndarray:
    """Per-frame GPS/compass coarse poses in the MAP frame, f32-safe.

    Host-side vectorized port of computeGpsCoarsePoseInMapFrame
    (localization_node.cpp:112-128): Rz(compass yaw) + UTM position with
    the table altitude, composed with map_T_global. Precomputing the whole
    stream keeps UTM f64 math off the device while feeding the scan loop
    pure f32 map-frame arrays.
    """
    lat = np.asarray(lat, np.float64)
    lon = np.asarray(lon, np.float64)
    yaw = np.asarray(compass_yaw, np.float64)
    e, n = ll_to_utm(lat, lon)
    alt = closest_altitude_batch(map_data.altitude_table, lat, lon)
    T = len(lat)
    out = np.zeros((T, 4, 4))
    c, s = np.cos(yaw), np.sin(yaw)
    out[:, 0, 0] = c
    out[:, 0, 1] = -s
    out[:, 1, 0] = s
    out[:, 1, 1] = c
    out[:, 2, 2] = 1.0
    out[:, 3, 3] = 1.0
    out[:, 0, 3] = e
    out[:, 1, 3] = n
    out[:, 2, 3] = alt
    out = np.einsum("ij,tjk->tik", map_data.map_T_global, out)
    return out.astype(np.float32)


class StreamingMapper:
    """Online mapping recorder, the reference's MapDataSaver
    (map_data_save_node.cpp): accumulate registered scans, cut a tile every
    ``cloud_save_rate`` frames, log odometry positions and GPS/compass rows.
    Storage is in memory; utils/mapdata.save_map_data persists it.

    Device path (``device_origin`` given): each frame ALSO streams into a
    device voxel store on ``device`` (the card unless the caller asks for
    the CPU), so ``finalize(use_device=True)`` takes the global map from
    that store with no host re-grid: the map was maintained cell-exactly
    on the device the whole run. ``device_config`` picks the store: a
    `VoxelMapConfig` (the default, at ``map_voxel_size``) for the
    open-addressing hash table, a `SortedVoxelMapConfig` for the
    sort-merge array. The host tile and log artifacts are written either
    way: they are the checkpoint format.
    """

    def __init__(
        self,
        config: MappingConfig = MappingConfig(),
        device_origin: np.ndarray | None = None,
        device_config=None,
        device_scan_capacity: int = 65536,
        device_group: int = 1,
        device: torch.device | str = torch.device("cuda"),
    ):
        self.config = config
        self._accum: list[np.ndarray] = []
        self._counter = 0
        self.tiles: list[np.ndarray] = []
        self.odom_positions: list[np.ndarray] = []
        self.gps_rows: list[np.ndarray] = []
        self._vm_state = None
        self._vm_config = None
        if device_origin is not None:
            self._vm_config = device_config or VoxelMapConfig(
                voxel_size=config.map_voxel_size
            )
            init, self._vm_insert, self._vm_extract = (
                (sorted_voxel_map_init, sorted_voxel_map_insert, sorted_voxel_map_centroids_numpy)
                if isinstance(self._vm_config, SortedVoxelMapConfig)
                else (voxel_map_init, voxel_map_insert, voxel_map_centroids_numpy)
            )
            self._vm_device = torch.device(device)
            self._vm_state = init(self._vm_config, device_origin, self._vm_device)
            self._vm_scan_cap = device_scan_capacity
            # frames per device insert: cell sums and counts add up the
            # same in groups, so grouping is bit-identical to per-frame
            # inserts (the reference itself persists every 10th frame,
            # map_data_save_node.h:72). The tail group is padded, so every
            # flush has the same shapes.
            self._vm_group = max(int(device_group), 1)
            self._vm_pending: list[np.ndarray] = []

    def add_frame(
        self,
        scan_map_frame: np.ndarray,
        odom_position: np.ndarray,
        lat: float,
        lon: float,
        alt: float,
        compass_yaw: float,
    ) -> None:
        """Record one registered scan (map frame) and its log rows. On the
        device path a full frame group is inserted; nothing here waits for
        the device."""
        pts = np.asarray(scan_map_frame, np.float32).reshape(-1, 3)
        self._accum.append(pts)
        self._counter += 1
        if self._counter % self.config.cloud_save_rate == 0:
            self.tiles.append(np.concatenate(self._accum))
            self._accum = []
        self.odom_positions.append(np.asarray(odom_position, np.float64))
        self.gps_rows.append(np.array([lat, lon, alt, compass_yaw], np.float64))
        if self._vm_state is not None:
            if len(pts) > self._vm_scan_cap:
                raise ValueError(
                    f"scan of {len(pts)} points exceeds device_scan_capacity"
                    f"={self._vm_scan_cap}; size the mapper to the sensor"
                )
            self._vm_pending.append(pts)
            if len(self._vm_pending) >= self._vm_group:
                self._vm_flush()

    def _vm_flush(self) -> None:
        """One device insert for the pending frame group (a fixed
        group-width buffer: the tail group is padded)."""
        if not self._vm_pending:
            return
        cap = self._vm_scan_cap * self._vm_group
        pts = np.concatenate(self._vm_pending)
        self._vm_pending = []
        buf = np.zeros((cap, 3), np.float32)
        buf[: len(pts)] = pts
        msk = np.zeros(cap, bool)
        msk[: len(pts)] = True
        # non_blocking: a copy from pageable memory is staged at once and
        # does not wait for the inserts already queued on the card
        self._vm_state = self._vm_insert(
            self._vm_state,
            torch.from_numpy(buf).to(self._vm_device, non_blocking=True),
            torch.from_numpy(msk).to(self._vm_device, non_blocking=True),
            self._vm_config,
        )

    def finalize(self, use_device: bool = False) -> MapData:
        """Flush the residual tile (onShutdown, map_data_save_node.cpp:101-113)
        and build the MapData. ``use_device=True`` takes the map cloud from
        the device store (cell-identical to the host merge anchored at the
        same origin) instead of re-gridding on the host; it reads the
        store's two counters once and raises if either is not 0."""
        if self._accum:
            self.tiles.append(np.concatenate(self._accum))
            self._accum = []
        data = build_map_data(
            self.tiles if not use_device else [],
            np.stack(self.odom_positions) if self.odom_positions else np.zeros((0, 3)),
            np.stack(self.gps_rows) if self.gps_rows else np.zeros((0, 4)),
            self.config,
        )
        if use_device:
            if self._vm_state is None:
                raise ValueError(
                    "finalize(use_device=True) needs device_origin at init"
                )
            self._vm_flush()  # the partial tail group
            dropped, oob = torch.stack(
                [self._vm_state.n_dropped, self._vm_state.n_oob]
            ).tolist()
            if dropped or oob:
                raise ValueError(
                    "device voxel map overflowed: "
                    f"dropped={dropped} oob={oob}; grow capacity/"
                    "extents or re-anchor the origin"
                )
            data = dataclasses.replace(
                data, map_points=self._vm_extract(self._vm_state)
            )
        return data
