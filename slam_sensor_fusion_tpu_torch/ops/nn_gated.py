"""Radius-gated tile culling (port of the JAX `ops/nn_gated.py`).

The pipeline only ever uses neighbours within the ICP correspondence gate,
so nearest-neighbour search is a bounded-radius problem that tile culling
solves exactly: per Morton-sorted source tile, only target tiles whose
bounding boxes lie within the (dilated) gate radius can hold an admissible
neighbour. These functions build those visit lists; the search itself is
K1 (ops/superblock_fused.py) or K2 (ops/nn_pallas.py), or `gated_nn`: the
JAX package's XLA formulation (a scan over each source tile's visits), which
the parity ICP runs on its "xla" backend (ops/icp._icp_xla). It is XLA code
there, not a Pallas kernel, so plain PyTorch is its port.

Every function takes optional leading batch dimensions (the superblock
prologue runs all K frames at once, where the JAX package used vmap).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam_sensor_fusion_tpu_torch.ops.morton import bbox_pair_dist2, tile_bboxes
from slam_sensor_fusion_tpu_torch.ops import xla_math as xm

_BIG = 3.0e38


class GatedNNResult(NamedTuple):
    d2: torch.Tensor  # (M,) squared distance (>= gate if no admissible neighbour)
    idx: torch.Tensor  # (M,) int32 index into the target array
    visit_overflow: torch.Tensor  # () bool: some tile pair was culled by max_visits


def _r2(radius2, d2: torch.Tensor) -> torch.Tensor | float:
    """A per-batch radius tensor broadcast over the (nSt, nTt) matrix."""
    if isinstance(radius2, torch.Tensor) and radius2.ndim:
        return radius2[..., None, None]
    return radius2


def pair_tiles(
    lo_s: torch.Tensor,
    hi_s: torch.Tensor,
    cnt_s: torch.Tensor,
    lo_t: torch.Tensor,
    hi_t: torch.Tensor,
    radius2: float,
    max_visits: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Admissible-tile pairing from bboxes: (visits (nSt, max_visits) int32,
    counts (nSt,) int32, overflow () bool)."""
    d2 = bbox_pair_dist2(lo_s, hi_s, lo_t, hi_t)
    return pair_tiles_from_d2(d2, cnt_s, radius2, max_visits)


def subtile_pair_dist2(
    lo_s: torch.Tensor,  # (..., nSt * qs, 3) sub-box minima, row-major per tile
    hi_s: torch.Tensor,
    lo_t: torch.Tensor,  # (nTt * qt, 3)
    hi_t: torch.Tensor,
    n_src_tiles: int,
    n_tgt_tiles: int,
) -> torch.Tensor:
    """Tile-pair distance via fine sub-boxes: the min over every (source
    sub-box, target sub-box) pair inside the coarse tile pair. Still a
    superset of the true point-pair distances, so no admissible pair is
    ever missed, but ragged Morton tiles stop over-admitting."""
    d2 = bbox_pair_dist2(lo_s, hi_s, lo_t, hi_t)
    qs = lo_s.shape[-2] // n_src_tiles
    qt = lo_t.shape[-2] // n_tgt_tiles
    d2 = d2.reshape(d2.shape[:-2] + (n_src_tiles, qs, n_tgt_tiles, qt))
    return d2.amin(dim=-1).amin(dim=-2)


def pair_demand_from_d2(d2: torch.Tensor, cnt_s: torch.Tensor, radius2) -> torch.Tensor:
    """Total admissible (src, tgt) tile pairs BEFORE capacity clipping —
    the realized association load (observability)."""
    adm = (d2 <= _r2(radius2, d2)) & (cnt_s[..., :, None] > 0)
    return adm.sum(dim=(-2, -1), dtype=torch.int32)


def pair_tiles_from_d2(
    d2: torch.Tensor, cnt_s: torch.Tensor, radius2, max_visits: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """pair_tiles from a precomputed (..., nSt, nTt) tile-pair distance
    matrix. Visits are nearest-first; the sort is STABLE, so the many exact
    d2 = 0 ties of overlapping boxes keep tile order, which fixes both the
    visit order and what `max_visits` truncates."""
    admissible = d2 <= _r2(radius2, d2)  # inf for empty tiles -> False
    n_adm = admissible.sum(dim=-1, dtype=torch.int32)
    keys = torch.where(admissible, d2, torch.inf)
    order = torch.argsort(keys, dim=-1, stable=True)
    visits = order[..., :max_visits].to(torch.int32)
    counts = torch.clamp(n_adm, max=max_visits)
    counts = torch.where(cnt_s > 0, counts, 0).to(torch.int32)
    overflow = ((n_adm > max_visits) & (cnt_s > 0)).any(dim=-1)
    return visits, counts, overflow


def build_visit_lists(
    src_pts: torch.Tensor,
    src_mask: torch.Tensor,
    tgt_pts: torch.Tensor,
    tgt_mask: torch.Tensor,
    radius2: float,
    tile_src: int,
    tile_tgt: int,
    max_visits: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(visits (nSt, max_visits) int32, counts (nSt,), overflow ()) from the
    two clouds' tile boxes."""
    lo_s, hi_s, cnt_s = tile_bboxes(src_pts, src_mask, tile_src)
    lo_t, hi_t, _ = tile_bboxes(tgt_pts, tgt_mask, tile_tgt)
    return pair_tiles(lo_s, hi_s, cnt_s, lo_t, hi_t, radius2, max_visits)


def gated_nn(
    src: torch.Tensor,
    src_mask: torch.Tensor,
    tgt: torch.Tensor,
    tgt_mask: torch.Tensor,
    center: torch.Tensor,
    radius2: float,
    tile_src: int = 512,
    tile_tgt: int = 512,
    max_visits: int = 16,
) -> GatedNNResult:
    """Gated NN over Morton-sorted clouds (the JAX package's XLA
    formulation, nn_gated.py:121-200): per source tile, a loop over its
    visit list that gathers one target tile a step and keeps a running
    (min, argmin) under a strict `<`, so an exact tie keeps the earlier
    visit; within a tile the first row wins. Distances are the expanded
    (|s|^2 - 2 s.t) + |t|^2 rebased on `center`, each norm the fused
    multiply-add chain XLA's fusion makes of it (`xla_math.norm2`), the cross term a
    batched product: on the CPU the same bits as the JAX function. Exact
    within the gate for any order; points without an admissible neighbour
    report d2 >= gate."""
    M = src.shape[0]
    nSt = M // tile_src
    dev = src.device
    visits, counts, overflow = build_visit_lists(
        src, src_mask, tgt, tgt_mask, radius2, tile_src, tile_tgt, max_visits
    )
    src_tiles = (src - center[None, :]).float().reshape(nSt, tile_src, 3)
    s_norm = xm.norm2(src_tiles)  # (nSt, TM)
    tgt_tiles = (tgt - center[None, :]).float().reshape(-1, tile_tgt, 3)
    tmask_tiles = tgt_mask.reshape(-1, tile_tgt)
    best_d2 = torch.full((nSt, tile_src), _BIG, dtype=torch.float32, device=dev)
    best_idx = torch.zeros((nSt, tile_src), dtype=torch.int32, device=dev)
    # visits holds min(max_visits, target tiles) columns; JAX's scan over
    # max_visits clamps past them, where no source tile is still live
    for j in range(visits.shape[1]):
        tile_ids = visits[:, j].long()  # (nSt,)
        t = tgt_tiles[tile_ids]  # (nSt, TN, 3)
        live = j < counts  # (nSt,)
        cross = torch.bmm(src_tiles, t.transpose(1, 2))  # (nSt, TM, TN)
        t_norm = xm.norm2(t)  # (nSt, TN)
        d2 = s_norm[:, :, None] - 2.0 * cross + t_norm[:, None, :]
        ok = tmask_tiles[tile_ids] & live[:, None]
        d2 = torch.where(ok[:, None, :], d2, _BIG)
        tile_min, tile_arg = d2.min(dim=2)  # first row on ties
        tile_arg = tile_arg.to(torch.int32) + (tile_ids[:, None] * tile_tgt).to(torch.int32)
        better = tile_min < best_d2
        best_d2 = torch.where(better, tile_min, best_d2)
        best_idx = torch.where(better, tile_arg, best_idx)
    return GatedNNResult(
        d2=torch.clamp(best_d2.reshape(M), min=0.0),
        idx=best_idx.reshape(M),
        visit_overflow=overflow,
    )
