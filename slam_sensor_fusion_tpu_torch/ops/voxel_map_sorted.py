"""Incremental device voxel map as a SORTED cell array (port of the JAX
`ops/voxel_map_sorted.py`).

The second device store of the mapping product's global map (reference
semantics: map_data_save_node.cpp:60-99 host accumulate loop +
global_map_frames_manager.cpp:143-146 pcl::VoxelGrid at merge time, kept
incrementally and cell-exactly here). Same contract as ops/voxel_map (the
open-addressing hash store): running (sum, count) per voxel cell, loud
n_dropped / n_oob counters, a fixed anchor origin.

The map is a flat array of (cell key, moment) rows and an insert is a
SORT-MERGE, with no random-access table, no probe rounds and no
compaction. Per insert group:

1. pack cell ids and sort the group's rows by key (a stable sort, then a
   gather of the points);
2. segment-reduce the sorted run to one (sum3, count) moment per distinct
   cell (`ops/voxel_segsum.segment_sum_sorted`, each cell's points added
   in row order) and collect each segment's key with a scatter-min;
3. concatenate the store's rows with the group's unique rows and sort the
   lot by key: one stable merge, a store row right before its group row;
4. combine duplicate neighbours elementwise: both inputs hold at most one
   row per key, so every run has length <= 2 and one shift-compare-add
   folds the store row into the group row (`a + b`: f32 addition is
   commutative, so this is bit-identical to the hash store's `table +=
   group`);
5. mark absorbed rows EMPTY and keep the first `capacity +
   unique_capacity` rows. Absorbed rows carry key EMPTY = int32 max, so the
   NEXT insert's sort pushes them to the tail; the cut only ever removes
   EMPTY rows while the live cell count stays within `capacity` (cut live
   rows are COUNTED in n_dropped).

State width is therefore `capacity + unique_capacity` rows with the
invariant "live rows unique by key; dead rows EMPTY; EMPTY tail at least
`unique_capacity` long after every insert". Extraction sorts once, on the
host, at finalize.

Cell-exactness: the per-cell (sum, count) moments are identical to the
hash store's and to the host merge's (ops/cloud.voxel_downsample_numpy
anchored at the same origin): all three add the same group moments in the
same per-group order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slam_sensor_fusion_tpu_torch.ops.voxel_map import (
    _EMPTY,
    VoxelMapConfig,
    _anchor,
    _pack_ids,
    _sort_group,
)
from slam_sensor_fusion_tpu_torch.ops.voxel_segsum import segment_sum_sorted


class SortedVoxelMapConfig(NamedTuple):
    """Static geometry/capacity of the sorted-array voxel store."""

    voxel_size: float = 0.1
    #: max LIVE cells the store holds; the (capacity+unique_capacity)-row
    #: array never cuts a live row while the cell count stays under this
    capacity: int = 1 << 18
    #: max distinct cells one insert group may touch (the group dedup
    #: width); cells past it are counted in n_dropped, same rule as the
    #: hash store's unique_capacity
    unique_capacity: int = 1 << 16
    #: grid extents in CELLS; dim_xy^2 * dim_z must stay under int32
    #: (the top id is the EMPTY sentinel)
    dim_xy: int = 2048
    dim_z: int = 256

    def validate(self) -> "SortedVoxelMapConfig":
        if self.dim_xy * self.dim_xy * self.dim_z >= 2**31:
            raise ValueError(
                "voxel grid id space exceeds int32 (the top id is the "
                f"empty sentinel): {self.dim_xy}^2 * {self.dim_z} >= 2^31"
            )
        return self

    def as_hash_geometry(self) -> VoxelMapConfig:
        """The equivalent hash-store geometry (for _pack_ids reuse)."""
        return VoxelMapConfig(
            voxel_size=self.voxel_size,
            dim_xy=self.dim_xy,
            dim_z=self.dim_z,
        )


class SortedVoxelMapState(NamedTuple):
    """The insert carry: a flat (key, moment) row array.

    Row layout: `keys` nondecreasing after every insert EXCEPT rows
    absorbed by that insert's combine step, which sit at their old
    position with key EMPTY until the next sort sweeps them tailward.
    `moments` columns are (sum_x, sum_y, sum_z, count).
    """

    keys: torch.Tensor  # (M,) i32, M = capacity + unique_capacity
    moments: torch.Tensor  # (M, 4) f32
    origin: torch.Tensor  # (3,) f32 grid anchor (min corner)
    n_dropped: torch.Tensor  # () i32 capacity overflows (must stay 0)
    n_oob: torch.Tensor  # () i32 out-of-extent points (must stay 0)

    def n_cells(self) -> torch.Tensor:
        return (self.keys != int(_EMPTY)).sum(dtype=torch.int32)


def sorted_voxel_map_init(
    config: SortedVoxelMapConfig, origin, device: torch.device | str = torch.device("cuda")
) -> SortedVoxelMapState:
    """Empty store anchored at `origin` (fixed for the map's lifetime, the
    same exact-incremental-centroid argument as voxel_map_init), on
    `device`."""
    config.validate()
    M = config.capacity + config.unique_capacity
    zero = torch.zeros((), dtype=torch.int32, device=device)
    return SortedVoxelMapState(
        keys=torch.full((M,), int(_EMPTY), dtype=torch.int32, device=device),
        moments=torch.zeros((M, 4), dtype=torch.float32, device=device),
        origin=_anchor(origin, device),
        n_dropped=zero,
        n_oob=zero.clone(),
    )


def _group_rows(
    points: torch.Tensor, mask: torch.Tensor, origin: torch.Tensor, config: SortedVoxelMapConfig
):
    """One insert group sorted by cell id, and the segment sum's inputs:
    (sorted keys, use, over, payload (S, 4) = (x, y, z, 1) or 0, segment
    ids clipped to [0, U), n_oob). Masked rows and rows past U distinct
    cells alias U - 1 with zero payload."""
    S = points.shape[0]
    U = min(config.unique_capacity, S)
    key, active, n_oob = _pack_ids(points, mask, origin, config.as_hash_geometry())
    key = torch.where(active, key, int(_EMPTY))
    k_s, p_s, valid, _, seg = _sort_group(key, points)
    over = valid & (seg >= U)  # group touched more cells than U
    use = valid & ~over
    ones = torch.ones((S, 1), dtype=torch.float32, device=points.device)
    payload = torch.cat([p_s, ones], dim=1) * use[:, None].to(torch.float32)
    return k_s, use, over, payload, torch.clamp(seg, 0, U - 1), n_oob


def sorted_voxel_map_insert(
    state: SortedVoxelMapState,
    points: torch.Tensor,  # (S, 3) f32 MAP/world-frame points
    mask: torch.Tensor,  # (S,) bool
    config: SortedVoxelMapConfig,
) -> SortedVoxelMapState:
    """Absorb one scan (or frame group) by sort-merge. A pure carry update
    (the input state is not modified); unplaceable points are counted,
    never silently dropped into a wrong cell."""
    M = state.keys.shape[0]
    dev = points.device
    empty = int(_EMPTY)

    # ---- group dedup: sort by cell id, segment-reduce to per-cell
    # moments in row order
    k_s, use, over, payload, seg_c, n_oob = _group_rows(points, mask, state.origin, config)
    U = min(config.unique_capacity, points.shape[0])
    g_mom = segment_sum_sorted(payload, seg_c, U)
    g_key = torch.full((U,), empty, dtype=torch.int32, device=dev).scatter_reduce_(
        0, seg_c.to(torch.int64), torch.where(use, k_s, empty), "amin"
    )
    n_dropped = over.sum(dtype=torch.int32)

    # ---- merge: one stable sort of store rows + group rows. Equal keys
    # keep concat order (store row immediately before its group row);
    # EMPTY rows (store tail + absorbed-last-round + masked) go tailward.
    zk, order = torch.sort(torch.cat([state.keys, g_key]), stable=True)
    zm = torch.cat([state.moments, g_mom])[order]

    # ---- combine runs (length <= 2: both inputs are unique-by-key):
    # fold row i-1 into row i where keys match, then kill row i-1.
    no = torch.zeros((1,), dtype=torch.bool, device=dev)
    dup = torch.cat([no, (zk[1:] == zk[:-1]) & (zk[1:] != empty)])
    prev = torch.cat([torch.zeros((1, 4), dtype=torch.float32, device=dev), zm[:-1]])
    zm = zm + torch.where(dup[:, None], prev, 0.0)
    killed = torch.cat([dup[1:], no])
    zk = torch.where(killed, empty, zk)
    zm = torch.where(killed[:, None], 0.0, zm)

    # ---- slice back to M rows. The cut tail rows are EMPTY whenever the
    # live cell count fits `capacity` (live <= cap, absorbed-this-round
    # <= U, so non-EMPTY rows <= cap + U = M); if the map outgrew its
    # capacity the cut rows hold the LARGEST keys: count their points.
    cut = zk[M:]
    cut_pts = torch.where(cut != empty, zm[M:, 3], 0.0).sum()
    n_dropped = n_dropped + cut_pts.to(torch.int32)

    return SortedVoxelMapState(
        keys=zk[:M],
        moments=zm[:M],
        origin=state.origin,
        n_dropped=state.n_dropped + n_dropped,
        n_oob=state.n_oob + n_oob,
    )


def sorted_voxel_map_insert_chunk(
    state: SortedVoxelMapState,
    points: torch.Tensor,  # (T, S, 3)
    mask: torch.Tensor,  # (T, S)
    config: SortedVoxelMapConfig,
) -> SortedVoxelMapState:
    """`sorted_voxel_map_insert` over a chunk of frames, one insert a frame."""
    for p, m in zip(points, mask):
        state = sorted_voxel_map_insert(state, p, m, config)
    return state


def sorted_voxel_map_centroids_numpy(state: SortedVoxelMapState) -> np.ndarray:
    """Host extraction of all centroids in packed-id order: the same cloud
    (same order) voxel_map_centroids_numpy yields from the hash store, and
    the host merge yields sorted."""
    keys = state.keys.cpu().numpy()
    occ = keys != _EMPTY
    order = np.argsort(keys[occ], kind="stable")
    mom = state.moments.cpu().numpy()[occ][order]
    return (mom[:, :3] / mom[:, 3:4]).astype(np.float32)
