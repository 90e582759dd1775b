"""map_data directory persistence — the reference's on-disk checkpoint.

The reference's mapping run writes `~/Desktop/map_data/` with
`cloud_<N>.pcd` tiles, `odometry_positions.txt` and `gps_imu_poses.txt`
(map_data_save_node.cpp:14-29,71-98), and the localization run consumes
the directory, caching the merged cloud as `<map_name>.pcd`
(global_map_frames_manager.cpp:93-151) — the Python twin additionally
caches `map_T_global.npy` (optimize_global_map_pose.py:120-121). This
module reads and writes that exact layout (formats via utils/pcdio, fast
paths via utils/native). A copy of the JAX package's `utils/mapdata.py` on
the port's `models/mapping`: either package reads what the other writes.
"""

from __future__ import annotations

import os
import re
import shutil

import numpy as np

from slam_sensor_fusion_tpu_torch.models.mapping import MapData, build_map_data
from slam_sensor_fusion_tpu_torch.utils import native, pcdio
from slam_sensor_fusion_tpu_torch.utils.config import MappingConfig

_TILE_RE = re.compile(r"^cloud_(\d+)\.pcd$")


def save_map_data(
    path: str,
    tiles: list[np.ndarray],
    odom_positions: np.ndarray,
    gps_rows: np.ndarray,
    wipe: bool = True,
) -> None:
    """Write a full map_data directory.

    ``wipe=True`` mirrors the reference's destructive recreate
    (map_data_save_node.cpp:16-21).
    """
    if wipe and os.path.isdir(path):
        shutil.rmtree(path)
    os.makedirs(path, exist_ok=True)
    counter = 0
    for i, tile in enumerate(tiles):
        counter += 10  # tile names follow the 10-frame save rate
        native.write_pcd(os.path.join(path, f"cloud_{counter}.pcd"), tile)
        del i
    pcdio.write_odometry_positions(
        os.path.join(path, "odometry_positions.txt"), odom_positions
    )
    pcdio.write_gps_imu_poses(os.path.join(path, "gps_imu_poses.txt"), gps_rows)


def load_tiles(path: str, map_name: str = "map") -> list[np.ndarray]:
    """All tile PCDs in the directory (every *.pcd EXCEPT the merged map
    cache — the reference's readdir loop would merge the cache into itself
    on a second run; we exclude it)."""
    out = []
    for fn in sorted(os.listdir(path)):
        if fn.endswith(".pcd") and fn != f"{map_name}.pcd":
            out.append(native.read_pcd(os.path.join(path, fn)))
    return out


def load_map_data(
    path: str,
    map_name: str = "map",
    config: MappingConfig = MappingConfig(),
    cache: bool = True,
) -> MapData:
    """Load (or build-and-cache) MapData from a map_data directory.

    Mirrors GlobalMapFramesManager: use `<map_name>.pcd` when present
    (:98-103), else merge the tiles, voxel-downsample and save (:110-151);
    the solved map_T_global is cached as `map_T_global.npy` like the
    Python twin.
    """
    odom = pcdio.read_odometry_positions(os.path.join(path, "odometry_positions.txt"))
    gps = pcdio.read_gps_imu_poses(os.path.join(path, "gps_imu_poses.txt"))

    merged_path = os.path.join(path, f"{map_name}.pcd")
    t_path = os.path.join(path, "map_T_global.npy")
    if os.path.exists(merged_path):
        from slam_sensor_fusion_tpu_torch.models.mapping import (
            build_altitude_table,
            solve_map_T_global,
        )

        map_points = native.read_pcd(merged_path)
        if os.path.exists(t_path):
            map_T_global = np.load(t_path)
        else:
            map_T_global = solve_map_T_global(odom, gps, config)
        return MapData(
            map_points=map_points,
            map_T_global=map_T_global,
            altitude_table=build_altitude_table(gps),
        )

    tiles = load_tiles(path, map_name)
    md = build_map_data(tiles, odom, gps, config)
    if cache:
        native.write_pcd(merged_path, md.map_points)
        np.save(t_path, md.map_T_global)
    return md
