"""Incremental device voxel map: the open-addressing hash store (port of
the JAX `ops/voxel_map.py`).

The mapping product's global map: the reference accumulates registered
scans on the host and voxel-grids them once at merge time
(map_data_save_node.cpp:60-99 accumulate loop,
global_map_frames_manager.cpp:143-146 pcl::VoxelGrid). Here the map is a
DEVICE-RESIDENT open-addressing hash table over voxel cells that absorbs
one scan (or frame group) an insert, and yields at any point exactly the
centroid-per-voxel cloud the host merge would: a running (sum, count) per
cell is an exact incremental centroid.

Per insert: only the SCAN is sorted and segment-reduced to one (sum,
count) row per touched cell (`ops/voxel_segsum.segment_sum_sorted`, which
adds each cell's points in row order on any device, as the JAX package's
scatter-add does); every table-width gather and scatter then runs at the
unique-cell width U. Two claim rounds at width U place nearly all cells
(per-round miss rate ~ table occupancy), the few collision losers are
COMPACTED and finish the deep probe budget on a small array, and each phase
lands ONE scatter-add of the per-cell moments. No host round-trip: the
compactions that `jnp.nonzero(..., size=)` does in the JAX package are a
cumulative sum and a scatter into a pre-filled buffer here, so an insert
is a fixed sequence of launches.

Collision policy (deterministic, masked, observability-first):

* a cell's packed id claims a slot by a scatter-min against an EMPTY
  sentinel (int32 max). Occupied slots are never displaced: losers
  contribute min-candidates of EMPTY, a no-op. Contenders that lose a
  claim re-probe (double hashing) up to `max_probes` times;
* points still unplaced after the probe budget are counted in
  `n_dropped`, points outside the grid extents in `n_oob`; both must stay
  0 in healthy runs.

Each slot's moments receive at most one non-zero contribution an insert
(unplaced lanes alias slot 0 with a zero one), so the table's scatter-adds
(`index_add`) give the same bits in any order; only the per-cell segment
sum needs its order fixed.

Grid ids pack (x, y, z) cells into one int32, so the extents must satisfy
dim_xy^2 * dim_z < 2^31.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slam_sensor_fusion_tpu_torch.ops.cloud import Cloud, _saturating_int32
from slam_sensor_fusion_tpu_torch.ops.voxel_segsum import segment_sum_sorted

_EMPTY = np.int32(np.iinfo(np.int32).max)
# Knuth multiplicative hash constant (2^32 / phi), uint32 wrap-around
_HASH_MULT = np.uint32(2654435761)
_U32 = 0xFFFFFFFF


class VoxelMapConfig(NamedTuple):
    """Static geometry/capacity of the device voxel store."""

    voxel_size: float = 0.1
    #: hash-table slots; keep occupancy (live cells / slots) under ~0.5
    #: or probe failures (n_dropped) start firing
    table_size: int = 1 << 21
    #: total probe rounds. Per-point placement failure is ~occupancy^probes,
    #: so over millions of inserts the budget must stay deep (8 at 0.25
    #: occupancy ~ 1.5e-5 per point); n_dropped observably catches any
    #: residue
    max_probes: int = 8
    #: probe rounds at the full unique width before compacting the
    #: stragglers (after 2 rounds only ~occupancy^2 of the cells are
    #: still unplaced)
    full_width_probes: int = 2
    #: capacity of the compacted straggler pass; cells past it (never at
    #: sane occupancy) are counted dropped, not silently lost
    straggler_capacity: int = 1024
    #: grid extents in CELLS; dim_xy^2 * dim_z must fit int31
    dim_xy: int = 2048
    dim_z: int = 256
    #: width of the per-insert unique-cell stage (the dedup scratch and
    #: every claim/add). 0 = scan width (always complete). Real scans
    #: touch far fewer cells than they have points, so size this to ~1.5x
    #: the measured per-insert unique-cell count; points in cells past it
    #: are counted in n_dropped
    unique_capacity: int = 0

    def validate(self) -> "VoxelMapConfig":
        # >=: id 2^31-1 (int32 max) is the _EMPTY sentinel — a point in
        # the far-corner cell would silently read as masked otherwise
        if self.dim_xy * self.dim_xy * self.dim_z >= 2**31:
            raise ValueError(
                "voxel grid id space exceeds int32 (the top id is the "
                f"empty sentinel): {self.dim_xy}^2 * {self.dim_z} >= 2^31"
            )
        return self


class VoxelMapState(NamedTuple):
    """The insert carry: one open-addressing table of voxel cells."""

    keys: torch.Tensor  # (H,) int32 packed cell id, _EMPTY where free
    sums: torch.Tensor  # (H, 3) f32 running point sums
    counts: torch.Tensor  # (H,) f32 running point counts
    origin: torch.Tensor  # (3,) f32 grid anchor (min corner)
    n_dropped: torch.Tensor  # () i32 probe-budget failures (must stay 0)
    n_oob: torch.Tensor  # () i32 out-of-extent points (must stay 0)

    def n_cells(self) -> torch.Tensor:
        return (self.keys != int(_EMPTY)).sum(dtype=torch.int32)


def voxel_map_init(
    config: VoxelMapConfig, origin, device: torch.device | str = torch.device("cuda")
) -> VoxelMapState:
    """Empty store anchored at `origin` (the grid's min corner), on `device`.

    The anchor is FIXED for the map's lifetime: the incremental centroid is
    only exact when every insert bins against the same grid, so pick the
    survey site's min corner (with margin) up front. The host merge
    (ops/cloud.voxel_downsample_numpy) anchors at the global min the same
    way.
    """
    config.validate()
    H = config.table_size
    zero = torch.zeros((), dtype=torch.int32, device=device)
    return VoxelMapState(
        keys=torch.full((H,), int(_EMPTY), dtype=torch.int32, device=device),
        sums=torch.zeros((H, 3), dtype=torch.float32, device=device),
        counts=torch.zeros((H,), dtype=torch.float32, device=device),
        origin=_anchor(origin, device),
        n_dropped=zero,
        n_oob=zero.clone(),
    )


def _anchor(origin, device: torch.device | str) -> torch.Tensor:
    """A store's (3,) float32 grid anchor on `device`, copied from an
    array, a list or a tensor."""
    if isinstance(origin, torch.Tensor):
        return origin.detach().to(device=device, dtype=torch.float32).reshape(3).clone()
    return torch.tensor(np.asarray(origin, np.float32).reshape(3), device=device)


def _pack_ids(
    points: torch.Tensor, mask: torch.Tensor, origin: torch.Tensor, config: VoxelMapConfig
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(packed ids, in-bounds mask, oob count) for one scan.

    The voxel size divides as a tensor: a Python scalar divisor on the card
    becomes a multiplication by its reciprocal, which rounds differently."""
    vs = torch.full((), config.voxel_size, dtype=torch.float32, device=points.device)
    ijk = _saturating_int32(torch.floor((points - origin[None, :]) / vs))
    dims = (config.dim_xy, config.dim_xy, config.dim_z)
    inb = (ijk >= 0).all(dim=-1)
    for a, d in enumerate(dims):
        inb = inb & (ijk[:, a] < d)
    n_oob = (mask & ~inb).sum(dtype=torch.int32)
    ok = mask & inb
    i, j, k = (torch.clamp(ijk[:, a], 0, d - 1) for a, d in enumerate(dims))
    key = (i * config.dim_xy + j) * config.dim_z + k
    return key, ok, n_oob


def _probe_slot(key: torch.Tensor, probe: int, table_size: int) -> torch.Tensor:
    """Double-hashed slot index (int64) for probe round `probe`, with the
    JAX package's uint32 wrap-around emulated in int64: the product k *
    _HASH_MULT mod 2^32 is taken over k's 16-bit halves, so nothing
    overflows int64."""
    k = key.to(torch.int64) & _U32
    mult = int(_HASH_MULT)
    h = ((k & 0xFFFF) * mult + ((((k >> 16) * mult) & 0xFFFF) << 16)) & _U32
    h1 = h >> 8
    h2 = (k ^ (k >> 13)) | 1  # odd stride
    return ((h1 + probe * h2) & _U32) % table_size


def _nonzero_fixed(flag: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """`jnp.nonzero(flag, size=size, fill_value=fill)[0]` without a host
    sync: the indices of the first `size` set entries in order, padded with
    `fill` (int64). Ranks come from a cumulative sum; entries past `size`
    land in a spare slot that is cut off."""
    rank = torch.cumsum(flag, dim=0) - 1
    pos = torch.where(flag & (rank < size), rank, size)
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=flag.device)
    out.scatter_(0, pos, torch.arange(flag.shape[0], device=flag.device))
    return out[:size]


def _sort_group(key: torch.Tensor, points: torch.Tensor):
    """The group sorted by cell id, equal ids in input order (masked points
    sort last as _EMPTY = int32 max), and the sorted rows' segment ids:
    (sorted keys, sorted points, valid, first-of-cell, segment id int32)."""
    k_s, order = torch.sort(key, stable=True)
    p_s = points[order]
    valid = k_s != int(_EMPTY)
    first = torch.cat([valid[:1], valid[1:] & (k_s[1:] != k_s[:-1])])
    seg = torch.cumsum(first, dim=0, dtype=torch.int32) - 1
    return k_s, p_s, valid, first, seg


def voxel_map_insert(
    state: VoxelMapState,
    points: torch.Tensor,  # (S, 3) f32 MAP/world-frame points
    mask: torch.Tensor,  # (S,) bool
    config: VoxelMapConfig,
) -> VoxelMapState:
    """Absorb one scan: each point joins its voxel cell's running mean.

    A pure carry update (the input state is not modified). Unplaceable
    points are COUNTED, never silently dropped into a wrong cell.
    """
    S = points.shape[0]
    dev = points.device
    empty = int(_EMPTY)
    key, active, n_oob = _pack_ids(points, mask, state.origin, config)
    key = torch.where(active, key, empty)
    U = min(config.unique_capacity or S, S)

    # ---- dedup: sort the scan by cell id, segment-reduce to one (sum,
    # count) per cell in row order; all table traffic runs at width U
    k_s, p_s, valid, first, seg = _sort_group(key, points)
    over = valid & (seg >= U)  # unique-capacity overflow: counted below
    use = valid & ~over
    seg_c = torch.clamp(seg, 0, U - 1)
    payload = torch.cat(
        [torch.where(use[:, None], p_s, 0.0), use.to(torch.float32)[:, None]], dim=1
    )
    cell = segment_sum_sorted(payload, seg_c, U)
    cell_sum, cell_cnt = cell[:, :3], cell[:, 3]
    starts = _nonzero_fixed(first, U, S - 1)
    n_uniq = first.sum(dtype=torch.int32)
    uvalid = torch.arange(U, device=dev) < n_uniq
    ukey = torch.where(uvalid, k_s[starts], empty)

    keys = state.keys.clone()

    def claim(ck, act, lo, hi):
        """Probe rounds claiming one slot per (distinct) cell key, in place
        on `keys`. Occupied slots only ever receive _EMPTY min-candidates (a
        no-op), so history is never displaced; same-round contenders for a
        free slot resolve by scatter-min and the losers re-probe."""
        owned = torch.zeros(ck.shape, dtype=torch.int64, device=dev)
        placed = torch.zeros_like(act)
        for probe in range(lo, hi):
            slot = _probe_slot(ck, probe, config.table_size)
            contend = act & (keys[slot] == empty)
            keys.scatter_reduce_(0, slot, torch.where(contend, ck, empty), "amin")
            own = act & (keys[slot] == ck)
            owned = torch.where(own, slot, owned)
            placed = placed | own
            act = act & ~own
        return owned, placed, act

    def add_at(sums, counts, owned, placed, c_sum, c_cnt):
        # ONE scatter-add per phase: unplaced lanes alias slot 0 with a
        # zero contribution
        slot = torch.where(placed, owned, 0)
        sums.index_add_(0, slot, c_sum * placed[:, None])
        counts.index_add_(0, slot, c_cnt * placed)

    # phase 1: a couple of rounds at unique width place ~all cells
    # (per-round miss rate ~ table occupancy)
    fw = min(config.full_width_probes, config.max_probes)
    owned, placed, rem = claim(ukey, uvalid, 0, fw)
    sums, counts = state.sums.clone(), state.counts.clone()
    add_at(sums, counts, owned, placed, cell_sum, cell_cnt)

    n_dropped = over.sum(dtype=torch.int32)
    if config.max_probes > fw:
        # phase 2: compact the straggler cells (collision losers) and
        # finish the probe budget on the small array
        r_cap = min(config.straggler_capacity, U)
        n_rem = rem.sum(dtype=torch.int32)
        idx = _nonzero_fixed(rem, r_cap, 0)
        r_act = torch.arange(r_cap, device=dev) < n_rem
        rkey = torch.where(r_act, ukey[idx], empty)
        r_owned, r_placed, _ = claim(rkey, r_act, fw, config.max_probes)
        r_cnt = cell_cnt[idx]
        add_at(sums, counts, r_owned, r_placed, cell_sum[idx], r_cnt)
        # dropped POINTS: everything in cells still unplaced after phase 1
        # minus what phase 2 landed (deep-probe exhaustion and cells past
        # the straggler cap)
        n_dropped = n_dropped + (
            (cell_cnt * rem).sum() - (r_cnt * r_placed).sum()
        ).to(torch.int32)
    else:
        n_dropped = n_dropped + (cell_cnt * rem).sum().to(torch.int32)

    return VoxelMapState(
        keys=keys,
        sums=sums,
        counts=counts,
        origin=state.origin,
        n_dropped=state.n_dropped + n_dropped,
        n_oob=state.n_oob + n_oob,
    )


def voxel_map_insert_chunk(
    state: VoxelMapState,
    points: torch.Tensor,  # (T, S, 3)
    mask: torch.Tensor,  # (T, S)
    config: VoxelMapConfig,
) -> VoxelMapState:
    """`voxel_map_insert` over a chunk of frames, one insert a frame: the
    mapping product's device-resident accumulate loop."""
    for p, m in zip(points, mask):
        state = voxel_map_insert(state, p, m, config)
    return state


def voxel_map_centroids(
    state: VoxelMapState, config: VoxelMapConfig, out_capacity: int
) -> Cloud:
    """The map cloud: one centroid per occupied cell, packed id order.

    Ordering by packed id makes the output deterministic (independent of
    hash layout and insert order): the same cloud the host merge
    produces, sorted. O(H log H) once at extraction, not per frame.
    """
    del config  # the JAX signature; the state carries what is needed
    empty = int(_EMPTY)
    occ = state.keys != empty
    order = torch.argsort(state.keys, stable=True)[:out_capacity]
    cent = state.sums[order] / torch.clamp(state.counts[order], min=1.0)[:, None]
    n = torch.clamp(occ.sum(dtype=torch.int32), max=out_capacity)
    msk = torch.arange(order.shape[0], device=state.keys.device) < n
    return Cloud(torch.where(msk[:, None], cent, 0.0), msk)


def voxel_map_centroids_numpy(state: VoxelMapState) -> np.ndarray:
    """Host extraction of all centroids (packed id order), for finalize()
    paths and tests."""
    keys = state.keys.cpu().numpy()
    occ = keys != _EMPTY
    order = np.argsort(keys[occ], kind="stable")
    sums = state.sums.cpu().numpy()[occ][order]
    counts = state.counts.cpu().numpy()[occ][order]
    return (sums / counts[:, None]).astype(np.float32)
