"""The global voxel map with its cell space sharded over a mesh (port of the
JAX `parallel/voxel_map_shard.py`, the hash store).

ops/voxel_map.py caps the map at one table's worth of cells. Here each
shard owns the cells whose ownership hash lands on it and keeps a whole
private `VoxelMapState` for them, so the capacity is n_shards * table_size
cells. An insert hands the (deskewed, world-frame) scan group to every
shard; each masks it down to the points of the cells it owns and runs the
store's own insert (ops/voxel_map.voxel_map_insert, its segment sum on the
card). Ownership is a pure function of the packed cell id, so the shards
are disjoint by construction and their union is the single store's map,
cell for cell: no collective is needed.

The state's tensors carry a leading shard axis: the shards this process
holds (every shard with no process group). A process of a group keeps only
its own tables; `sp_voxel_map_centroids_numpy` and `sp_voxel_map_flags`
gather the others for the caller when given the mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_sensor_fusion_tpu_torch.ops.voxel_map import (
    _EMPTY,
    VoxelMapConfig,
    VoxelMapState,
    _pack_ids,
    voxel_map_centroids_numpy,
    voxel_map_init,
    voxel_map_insert,
)
from slam_sensor_fusion_tpu_torch.parallel.mesh import Mesh, tree_index, tree_stack

_OWNER_MULT = 0x9E3779B1  # an odd mix distinct from ops/voxel_map's _HASH_MULT
_MASK32 = 0xFFFFFFFF


def _owner(key: torch.Tensor, n_shards: int) -> torch.Tensor:
    """The shard owning a packed cell id: ((uint32(key) * 0x9E3779B1) mod
    2^32 >> 20) % n_shards, as the JAX function's uint32 arithmetic. torch
    has no full uint32 arithmetic, so the product is taken in int64 in two
    16-bit halves of the multiplier (no partial product passes 2^49) and
    masked to 32 bits before the shift."""
    k = key.to(torch.int64) & _MASK32
    lo = k * (_OWNER_MULT & 0xFFFF)
    hi = ((k * (_OWNER_MULT >> 16)) & 0xFFFF) << 16
    prod = (lo + hi) & _MASK32
    return ((prod >> 20) % n_shards).to(torch.int32)


def sp_voxel_map_init(
    config: VoxelMapConfig,
    origin,
    mesh: Mesh,
    device: torch.device | str = torch.device("cuda"),
) -> VoxelMapState:
    """A VoxelMapState whose tensors carry a leading axis of the shards this
    process holds, each a whole empty store on `device`.
    `config.table_size` is PER SHARD."""
    single = voxel_map_init(config, origin, device)
    return tree_stack([single] * len(mesh.local_shards))


def sp_voxel_map_insert_chunk(
    state: VoxelMapState,  # leading axis: this process's shards
    points: torch.Tensor,  # (T, S, 3) world-frame insert groups
    mask: torch.Tensor,  # (T, S)
    config: VoxelMapConfig,
    mesh: Mesh,
) -> VoxelMapState:
    """Absorb T insert groups into the shards this process holds: each
    shard masks every group down to its own cells, by the ownership hash of
    the points' packed cell ids (the store's own packer, so binning is the
    single store's), and runs the store's insert on its table. An
    out-of-extent point's clipped id still has exactly one owner, so
    exactly one shard counts it in n_oob."""
    shards = []
    for i, s in enumerate(mesh.local_shards):
        st = tree_index(state, i)
        for p, m in zip(points, mask):
            key, _, _ = _pack_ids(p, m, st.origin, config)
            mine = m & (_owner(key, mesh.n_shards) == s)
            st = voxel_map_insert(st, p, mine, config)
        shards.append(st)
    return tree_stack(shards)


def _all_shards(state: VoxelMapState, mesh: Mesh | None) -> VoxelMapState:
    return state if mesh is None else mesh.gather_tree(state)


def sp_voxel_map_centroids_numpy(state: VoxelMapState, mesh: Mesh | None = None) -> np.ndarray:
    """Every shard's centroids (disjoint cell sets) concatenated: the
    single store's cloud up to row order. With the mesh of a process group
    the other processes' shards are gathered first."""
    state = _all_shards(state, mesh)
    outs = [voxel_map_centroids_numpy(tree_index(state, s)) for s in range(state.keys.shape[0])]
    return np.concatenate([o for o in outs if len(o)] or [np.zeros((0, 3), np.float32)])


def sp_voxel_map_flags(
    state: VoxelMapState, mesh: Mesh | None = None
) -> tuple[int, int, np.ndarray]:
    """(total dropped, total out of extent, live cells a shard): the single
    store's must-stay-zero counters, summed over the shards."""
    state = _all_shards(state, mesh)
    return (
        int(state.n_dropped.sum()),
        int(state.n_oob.sum()),
        (state.keys != int(_EMPTY)).sum(dim=1).cpu().numpy(),
    )
