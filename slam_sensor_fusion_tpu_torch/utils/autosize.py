"""Derive capacities + tile shapes from a data sample (auto-sizing; port of
the JAX `utils/autosize.py`, the same rules in NumPy).

The reference "just works on whatever arrives" because PCL clouds are
dynamically sized (localization_node.cpp:6-28); the fixed-shape device
pipeline instead needs capacities picked per workload. Point it at a
sample of scans + the map and it returns a config whose buffers fit the
data with headroom, whose tile shapes follow the JAX package's rule, and
whose visit/pair lists are complete BY CONSTRUCTION (capacity >= the
target tile count), so the overflow flags cannot fire for capacity
reasons.

Heuristics are data-derived: scan capacity from the largest sample scan
(x1.25 margin), cropped-map capacity from the densest observed crop-ball
(x2 margin against unvisited regions), tile shapes switched at ~16k device
points a scan (512/512 below, 4096/128 above: coarser SOURCE tiles cut
sequential pair-loop trips, finer TARGET tiles cull more precisely).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from slam_sensor_fusion_tpu_torch.utils import kitti
from slam_sensor_fusion_tpu_torch.utils.config import LocalizationConfig


def _pow2(n: int, floor: int = 1024) -> int:
    return 1 << int(np.ceil(np.log2(max(int(n), floor))))


def suggest_scan_capacity(
    scans: list[np.ndarray], subsample: int = 1, margin: float = 1.25
) -> int:
    """Capacity (power of two) covering every sample scan with headroom
    (utils/kitti.suggest_scan_capacity, for non-KITTI data too)."""
    return kitti.suggest_scan_capacity(scans, subsample=subsample, margin=margin)


def estimate_crop_points(
    map_points: np.ndarray,
    crop_radius: float,
    sample_centers: np.ndarray | None = None,
    n_samples: int = 32,
    seed: int = 0,
) -> int:
    """Largest map-point count inside any sampled crop ball.

    Centers default to random map points (the trajectory visits the
    mapped region by definition); pass known poses for exactness.
    """
    map_points = np.asarray(map_points, np.float32).reshape(-1, 3)
    if len(map_points) == 0:
        return 0
    if sample_centers is None:
        rng = np.random.default_rng(seed)
        idx = rng.choice(len(map_points), min(n_samples, len(map_points)),
                         replace=False)
        sample_centers = map_points[idx]
    best = 0
    r2 = crop_radius * crop_radius
    for c in np.asarray(sample_centers, np.float32).reshape(-1, 3):
        d2 = ((map_points - c) ** 2).sum(axis=1)
        best = max(best, int((d2 <= r2).sum()))
    return best


def suggest_localization_config(
    scans: list[np.ndarray],
    map_points: np.ndarray,
    base: LocalizationConfig = LocalizationConfig(),
    poses_xyz: np.ndarray | None = None,
) -> LocalizationConfig:
    """A LocalizationConfig sized to the given data sample.

    `scans` is any representative sample (a prefix works); `map_points`
    the loaded map cloud; `poses_xyz` optional (T, 3) expected sensor
    positions for exact crop-ball sizing.
    """
    sub = base.scan_subsample_step
    scan_cap = suggest_scan_capacity(scans, subsample=sub if base.host_preprocess else 1)
    map_pts = np.asarray(map_points, np.float32).reshape(-1, 3)
    map_cap = _pow2(len(map_pts) // max(base.map_subsample_step, 1))

    crop_n = estimate_crop_points(
        map_pts[:: max(base.map_subsample_step, 1)],
        base.cloud_crop_radius,
        sample_centers=poses_xyz,
    )
    cropped_map = _pow2(int(crop_n * 2.0), floor=4096)  # 2x: unvisited areas

    # big scans want coarse source tiles (fewer sequential pair-loop
    # trips) and fine target tiles (tighter bbox culling)
    device_pts = max(len(s) for s in scans) // max(sub, 1) if scans else 1024
    if device_pts > 16384:
        tile_src, tile_tgt = 4096, 128
    else:
        tile_src, tile_tgt = 512, 512
    n_target_tiles = cropped_map // tile_tgt
    # visit/pair lists complete by construction: a source tile can admit
    # at most every target tile
    max_visits = _pow2(n_target_tiles, floor=64)
    max_pairs_factor = max_visits

    return dataclasses.replace(
        base,
        capacity=dataclasses.replace(
            base.capacity,
            scan=scan_cap,
            cropped_scan=scan_cap,
            cropped_map=cropped_map,
            map=map_cap,
        ),
        icp=dataclasses.replace(
            base.icp,
            tile_src=tile_src,
            tile_tgt=tile_tgt,
            max_visits=max_visits,
            max_pairs_factor=max_pairs_factor,
        ),
    )


def suggest_voxel_map_config(
    world_frames: list[np.ndarray],
    voxel_size: float,
    frames_per_insert: int = 1,
    origin: np.ndarray | None = None,
    cell_margin: float = 1.5,
    extent_margin_m: float = 20.0,
):
    """A VoxelMapConfig (the hash store, ops/voxel_map) + origin sized to a
    sample of WORLD-frame scans.

    Sizes the three capacities the device voxel store needs up front
    (grid extents, hash-table size, per-insert unique-cell width) from
    the data instead of hand tuning, mirroring the reference's
    accumulate-anything recorder (map_data_save_node.cpp:60-99). The
    store's n_dropped / n_oob counters stay the loud backstop if the
    sample under-represents the run.

    Returns (config, origin). `world_frames` is a representative sample
    (a prefix works); `frames_per_insert` is the insert grouping the
    caller will use (unique-cell width is measured per GROUP).
    """
    from slam_sensor_fusion_tpu_torch.ops.voxel_map import VoxelMapConfig

    frames = [np.asarray(f, np.float32).reshape(-1, 3)
              for f in world_frames if len(f)]
    if not frames:
        raise ValueError("empty sample")
    lo = np.min([f.min(axis=0) for f in frames], axis=0) - extent_margin_m
    hi = np.max([f.max(axis=0) for f in frames], axis=0) + extent_margin_m
    if origin is None:
        origin = lo.astype(np.float32)
    dims = np.ceil((hi - np.asarray(origin)) / voxel_size).astype(int) + 1
    dim_xy = int(max(dims[0], dims[1]))
    dim_z = int(dims[2])

    def cells(pts):
        ijk = np.floor((pts - origin) / voxel_size).astype(np.int64)
        # loud failure on packing overflow: a caller-passed origin above
        # the sample min (negative ijk) or >2^21-cell extents would make
        # packed ids collide and silently undersize the capacities
        if ijk.min() < 0 or ijk.max() >= (1 << 21):
            raise ValueError(
                "sample cells out of packable range [0, 2^21): "
                f"ijk min {ijk.min(axis=0)}, max {ijk.max(axis=0)} "
                "(is the passed origin above the sample min?)"
            )
        return (ijk[:, 0] << 42) + (ijk[:, 1] << 21) + ijk[:, 2]

    g = max(frames_per_insert, 1)
    per_group = max(
        len(np.unique(cells(np.concatenate(frames[i:i + g]))))
        for i in range(0, len(frames), g)
    )
    unique_capacity = -(-int(per_group * cell_margin) // 4096) * 4096
    total = len(np.unique(np.concatenate([cells(f) for f in frames])))
    # x4: occupancy <= 0.25 even if the sample is the whole run, more
    # headroom when it's a prefix (probe failure ~ occupancy^probes)
    table_size = _pow2(4 * total, floor=1 << 14)
    return (
        VoxelMapConfig(
            voxel_size=voxel_size,
            table_size=table_size,
            dim_xy=dim_xy,
            dim_z=dim_z,
            unique_capacity=unique_capacity,
            straggler_capacity=max(1024, unique_capacity // 16),
        ).validate(),
        np.asarray(origin, np.float32),
    )


def suggest_lio_config(scans: list[np.ndarray], base=None, target_reg_points: int = 2048):
    """A LIOConfig (models/lio) sized to the scan sample: capacity with
    headroom and a registration subsample hitting ~`target_reg_points`
    device points (association cost scales with it; the JAX package's
    sweeps put the accuracy/throughput knee near 2k at survey densities)."""
    from slam_sensor_fusion_tpu_torch.models.lio import LIOConfig

    if base is None:
        base = LIOConfig()
    cap = suggest_scan_capacity(scans)
    median_pts = int(np.median([len(s) for s in scans])) if scans else 1024
    reg_sub = int(np.clip(round(median_pts / target_reg_points), 1, 32))
    return base._replace(scan_capacity=cap, reg_subsample=reg_sub)
