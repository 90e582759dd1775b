"""Carry state from the JAX package into the port.

The engine has no weights: what a run carries is its configuration, the
map and the pipeline state. These functions rebuild the port's versions
from the JAX package's values handed over as plain Python and NumPy (for a
nested NamedTuple: `jax.tree.map(np.asarray, x)`), so a test or a migration
can start the port from exactly the state the JAX package reached. Nothing
here imports jax: inputs are duck-typed by their field names.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from slam_sensor_fusion_tpu_torch.models.ekf import EKFConfig, EKFState
from slam_sensor_fusion_tpu_torch.models.lio import LIOConfig, LIOState
from slam_sensor_fusion_tpu_torch.models.localization import PipelineState
from slam_sensor_fusion_tpu_torch.models.mapping import MapData
from slam_sensor_fusion_tpu_torch.models.pipeline_fast import PagedFrames
from slam_sensor_fusion_tpu_torch.ops.cloud import Cloud
from slam_sensor_fusion_tpu_torch.ops.icp_fused import CachedTarget
from slam_sensor_fusion_tpu_torch.ops.p2p_fused import CachedP2PTarget
from slam_sensor_fusion_tpu_torch.ops.point_to_plane import PointToPlaneConfig
from slam_sensor_fusion_tpu_torch.ops.stochastic_filter import FilterState
from slam_sensor_fusion_tpu_torch.ops.voxel_map import VoxelMapState
from slam_sensor_fusion_tpu_torch.ops.voxel_map_sorted import SortedVoxelMapState
from slam_sensor_fusion_tpu_torch.parallel.map_shard import ShardedP2PTarget, SpPipelineState
from slam_sensor_fusion_tpu_torch.utils.config import (
    BruteForceConfig,
    CloudCapacity,
    ICPConfig,
    LocalizationConfig,
    StochasticFilterConfig,
)

_NESTED = {
    "icp": ICPConfig,
    "rescue_icp": ICPConfig,
    "brute_force": BruteForceConfig,
    "filter": StochasticFilterConfig,
    "capacity": CloudCapacity,
}


def config_from_fields(d: dict) -> LocalizationConfig:
    """The port's LocalizationConfig from `dataclasses.asdict` of a JAX
    package LocalizationConfig (same field names and defaults)."""
    names = {f.name for f in dataclasses.fields(LocalizationConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown LocalizationConfig fields: {sorted(unknown)}")
    kw = {k: (_NESTED[k](**v) if k in _NESTED else v) for k, v in d.items()}
    return LocalizationConfig(**kw)


def map_data_from_numpy(map_points, map_T_global, altitude_table) -> MapData:
    """A MapData from host arrays, in the dtypes the map build produces."""
    return MapData(
        map_points=np.asarray(map_points, np.float32).reshape(-1, 3),
        map_T_global=np.asarray(map_T_global, np.float64).reshape(4, 4),
        altitude_table=np.asarray(altitude_table, np.float64).reshape(-1, 3),
    )


def _tensor(a, device) -> torch.Tensor:
    """NumPy -> torch on `device`; floating arrays become float32 (host
    builders hand float64, the device pipeline is float32)."""
    a = np.array(a)  # a writable copy; keeps 0-d arrays 0-d
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    return torch.from_numpy(a).to(device)


def state_from_numpy(
    state, device: torch.device | str = torch.device("cuda")
) -> PipelineState:
    """A PipelineState from a JAX PipelineState (with its Cloud,
    FilterState and CachedTarget) whose leaves are NumPy arrays."""
    ct = state.cached_target
    fs = state.filter_state

    def opt(a):
        return None if a is None else _tensor(a, device)

    return PipelineState(
        map_T_sensor=_tensor(state.map_T_sensor, device),
        odom_T_sensor_previous=_tensor(state.odom_T_sensor_previous, device),
        map_T_ref=_tensor(state.map_T_ref, device),
        cropped_map=Cloud(
            _tensor(state.cropped_map.points, device),
            _tensor(np.asarray(state.cropped_map.mask, bool), device),
        ),
        filter_state=FilterState(
            transitions=_tensor(fs.transitions, device),
            count=_tensor(np.asarray(fs.count, np.int32), device),
            previous_pose=_tensor(fs.previous_pose, device),
        ),
        cached_target=CachedTarget(
            pages=_tensor(ct.pages, device),
            lo=_tensor(ct.lo, device),
            hi=_tensor(ct.hi, device),
            center=_tensor(ct.center, device),
            sub_lo=opt(ct.sub_lo),
            sub_hi=opt(ct.sub_hi),
        ),
        extra_slack=_tensor(state.extra_slack, device),
    )


def paged_frames_from_numpy(
    frames, device: torch.device | str = torch.device("cuda")
) -> PagedFrames:
    """PagedFrames from a JAX PagedFrames whose leaves are NumPy arrays."""
    return PagedFrames(
        src_pages=_tensor(frames.src_pages, device),
        src_lo=_tensor(frames.src_lo, device),
        src_hi=_tensor(frames.src_hi, device),
        src_cnt=_tensor(np.asarray(frames.src_cnt, np.int32), device),
        odom_T_sensor=_tensor(frames.odom_T_sensor, device),
        map_T_sensor_gps=_tensor(frames.map_T_sensor_gps, device),
        odom_cov_trace=_tensor(frames.odom_cov_trace, device),
        gps_cov_trace=_tensor(frames.gps_cov_trace, device),
        valid=_tensor(np.asarray(frames.valid, bool), device),
    )


def lio_config_from_fields(d: dict) -> LIOConfig:
    """The port's LIOConfig from `_asdict()` of a JAX package LIOConfig
    (same field names and defaults; the nested `p2p` and `ekf` configs as
    NamedTuples or their `_asdict()`)."""
    unknown = set(d) - set(LIOConfig._fields)
    if unknown:
        raise ValueError(f"unknown LIOConfig fields: {sorted(unknown)}")

    def nested(cls, v):
        return cls(**(v if isinstance(v, dict) else v._asdict()))

    kw = dict(d)
    if "p2p" in kw:
        kw["p2p"] = nested(PointToPlaneConfig, kw["p2p"])
    if "ekf" in kw:
        kw["ekf"] = nested(EKFConfig, kw["ekf"])
    return LIOConfig(**kw)


def ekf_state_from_numpy(
    state, device: torch.device | str = torch.device("cuda")
) -> EKFState:
    """An EKFState from a JAX EKFState whose leaves are NumPy arrays."""
    return EKFState(*[_tensor(getattr(state, f), device) for f in EKFState._fields])


def cached_p2p_target_from_numpy(
    cached, device: torch.device | str = torch.device("cuda")
) -> CachedP2PTarget:
    """A CachedP2PTarget (6-row pages, tile boxes, optional sub-boxes) from
    the JAX one whose leaves are NumPy arrays."""
    return CachedP2PTarget(
        *[
            None if getattr(cached, f) is None else _tensor(getattr(cached, f), device)
            for f in CachedP2PTarget._fields
        ]
    )


def sharded_p2p_target_from_numpy(
    sharded, device: torch.device | str = torch.device("cuda")
) -> ShardedP2PTarget:
    """A ShardedP2PTarget (the shards' 6-row pages and tile boxes, their
    common center) from the JAX one whose array leaves are NumPy arrays."""
    return ShardedP2PTarget(
        pages=_tensor(sharded.pages, device),
        lo=_tensor(sharded.lo, device),
        hi=_tensor(sharded.hi, device),
        center=_tensor(sharded.center, device),
        n_shards=int(sharded.n_shards),
    )


def sp_state_from_numpy(
    state, device: torch.device | str = torch.device("cuda")
) -> SpPipelineState:
    """An SpPipelineState (the map-sharded loop's carry: pose, odometry
    reference, filter queue) from the JAX one whose leaves are NumPy
    arrays."""
    fs = state.filter_state
    return SpPipelineState(
        map_T_sensor=_tensor(state.map_T_sensor, device),
        odom_T_sensor_previous=_tensor(state.odom_T_sensor_previous, device),
        filter_state=FilterState(
            transitions=_tensor(fs.transitions, device),
            count=_tensor(np.asarray(fs.count, np.int32), device),
            previous_pose=_tensor(fs.previous_pose, device),
        ),
    )


def lio_state_from_numpy(
    state, device: torch.device | str = torch.device("cuda")
) -> LIOState:
    """A LIOState from a JAX LIOState taken mid-run, leaves as NumPy
    arrays: the ring, the anchor arrays, the cached pages and boxes and
    `anchor_P6`. The slot and frame counters become Python ints."""
    return LIOState(
        ekf_state=ekf_state_from_numpy(state.ekf_state, device),
        ring=_tensor(state.ring, device),
        ring_mask=_tensor(np.asarray(state.ring_mask, bool), device),
        slot=int(state.slot),
        frame=int(state.frame),
        anchor_points=_tensor(state.anchor_points, device),
        anchor_mask=_tensor(np.asarray(state.anchor_mask, bool), device),
        anchor_normals=_tensor(state.anchor_normals, device),
        anchor_normals_valid=_tensor(np.asarray(state.anchor_normals_valid, bool), device),
        anchor_cache=cached_p2p_target_from_numpy(state.anchor_cache, device),
        anchor_P6=_tensor(state.anchor_P6, device),
    )


def voxel_map_state_from_numpy(
    state, device: torch.device | str = torch.device("cuda")
) -> VoxelMapState:
    """A hash-store VoxelMapState from the JAX one whose leaves are NumPy
    arrays, so a map recorded by one package goes on in the other (the
    same table layout: `_probe_slot` gives the same slots)."""
    return VoxelMapState(*[_tensor(getattr(state, f), device) for f in VoxelMapState._fields])


def sorted_voxel_map_state_from_numpy(
    state, device: torch.device | str = torch.device("cuda")
) -> SortedVoxelMapState:
    """A SortedVoxelMapState (keys, moments, origin, counters) from the JAX
    one whose leaves are NumPy arrays."""
    return SortedVoxelMapState(
        *[_tensor(getattr(state, f), device) for f in SortedVoxelMapState._fields]
    )


def sp_voxel_map_state_from_numpy(
    state, device: torch.device | str = torch.device("cuda")
) -> VoxelMapState:
    """The sharded hash store (parallel/voxel_map_shard: a leading shard
    axis on every leaf) from the JAX one whose leaves are NumPy arrays,
    every shard's table as it is; the port's insert goes on from it."""
    if np.ndim(state.keys) != 2:
        raise ValueError(f"a sharded store's keys are (shards, table), not {np.shape(state.keys)}")
    return voxel_map_state_from_numpy(state, device)
