"""Morton (Z-order) sorting and tile bounding boxes (port of the JAX
`ops/morton.py`).

Sorting a cloud by Morton code makes fixed-size point tiles spatially
coherent, so tile bounding boxes are tight and the gated NN search can cull
target tiles by bbox distance (ops/nn_gated.py). The host sort is the
loader's pre-sort; the map is sorted once at load (models/localization.py);
the LIO ring is sorted on the device at every anchor refresh (models/lio.py).
"""

from __future__ import annotations

import numpy as np
import torch

from slam_sensor_fusion_tpu_torch.ops.cloud import Cloud

_BITS = 10  # 10 bits/axis -> 30-bit codes


def sort_points_numpy(points: np.ndarray, isotropic: bool = False) -> np.ndarray:
    """Host-side Morton sort of an (n, 3) array (loader pre-sort): 10-bit
    codes over the points' box, stable order."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    return points[sort_order_numpy(points, isotropic)]


def sort_order_numpy(points: np.ndarray, isotropic: bool = False) -> np.ndarray:
    """Host-side Morton sort ORDER of an (n, 3) array, so per-point side
    channels (deskew timestamps) can ride along with the sort. `isotropic`
    quantizes over a CUBE instead of the per-axis box, as
    `cloud_box(isotropic=True)` does on the device; use it whenever tile
    bboxes will gate NN search on flat clouds."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    n = points.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    lo = points.min(axis=0)
    extent = np.maximum(points.max(axis=0) - lo, 1e-6)
    if isotropic:
        extent = np.full(3, extent.max(), extent.dtype)
    q = np.clip(
        ((points - lo) / extent * (1 << _BITS)).astype(np.int64),
        0,
        (1 << _BITS) - 1,
    )

    def spread(v):
        v = v & 0x3FF
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    code = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    return np.argsort(code, kind="stable")


def _spread_bits(v: torch.Tensor) -> torch.Tensor:
    """Insert two zero bits between each of the low 10 bits of v (int64)."""
    v = v.to(torch.int64) & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_codes(
    points: torch.Tensor, mask: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
) -> torch.Tensor:
    """30-bit Morton codes (int32) over the [lo, hi] box; invalid points get
    the maximal code so they sort to the end."""
    extent = torch.clamp(hi - lo, min=1e-6)
    scaled = (points - lo) / extent * (1 << _BITS)
    # clamped in float first: the conversion of an out-of-range float is
    # undefined, and the clip below gives the same integers either way
    q = torch.clamp(scaled, -1.0, float(1 << _BITS)).to(torch.int32)
    q = torch.clamp(q, 0, (1 << _BITS) - 1)
    code = (
        _spread_bits(q[:, 0])
        | (_spread_bits(q[:, 1]) << 1)
        | (_spread_bits(q[:, 2]) << 2)
    ).to(torch.int32)
    return torch.where(mask, code, (1 << 30) + 1)


def cloud_box(cloud: Cloud, isotropic: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked (lo, hi) bounding box of a cloud; `isotropic` expands it to a
    CUBE (hi = lo + max extent on every axis) so Morton cells are metrically
    cubic, as truncated codes that define spatial cells need
    (ops/point_to_plane.estimate_normals_cells)."""
    m = cloud.mask[:, None]
    lo = torch.where(m, cloud.points, torch.inf).amin(dim=0)
    lo = torch.where(torch.isfinite(lo), lo, 0.0)
    hi = torch.where(m, cloud.points, -torch.inf).amax(dim=0)
    hi = torch.where(torch.isfinite(hi), hi, 1.0)
    if isotropic:
        hi = lo + torch.clamp(hi - lo, min=1e-6).max()
    return lo, hi


def sort_by_morton(cloud: Cloud, isotropic: bool = False) -> Cloud:
    """Spatially sort the cloud (valid points first, Z-order; stable, so
    equal codes keep buffer order as `jnp.argsort` keeps them)."""
    lo, hi = cloud_box(cloud, isotropic)
    codes = morton_codes(cloud.points, cloud.mask, lo, hi)
    order = torch.sort(codes, stable=True).indices
    return Cloud(cloud.points[order], cloud.mask[order])


def tile_bboxes(
    points: torch.Tensor, mask: torch.Tensor, tile: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-tile (lo, hi, count) of (..., n, 3) points with invalid rows
    excluded. Empty tiles get inverted boxes (lo=+inf, hi=-inf), which can
    never pass a bbox-distance test."""
    lead = points.shape[:-2]
    n_tiles = points.shape[-2] // tile
    p = points.reshape(lead + (n_tiles, tile, 3))
    m = mask.reshape(lead + (n_tiles, tile, 1))
    lo = torch.where(m, p, torch.inf).amin(dim=-2)
    hi = torch.where(m, p, -torch.inf).amax(dim=-2)
    cnt = m[..., 0].sum(dim=-1, dtype=torch.int32)
    return lo, hi, cnt


def bbox_pair_dist2(
    lo_a: torch.Tensor, hi_a: torch.Tensor, lo_b: torch.Tensor, hi_b: torch.Tensor
) -> torch.Tensor:
    """Squared min distance between every box in A (..., nA, 3) and every
    box in B (..., nB, 3) -> (..., nA, nB); empty (inverted) boxes give
    +inf."""
    gap = torch.maximum(
        lo_b[..., None, :, :] - hi_a[..., :, None, :],
        lo_a[..., :, None, :] - hi_b[..., None, :, :],
    )
    gap = torch.clamp(gap, min=0.0)
    d2 = (
        gap[..., 0] * gap[..., 0]
        + gap[..., 1] * gap[..., 1]
        + gap[..., 2] * gap[..., 2]
    )
    empty_a = (lo_a > hi_a).any(dim=-1)
    empty_b = (lo_b > hi_b).any(dim=-1)
    return torch.where(
        empty_a[..., :, None] | empty_b[..., None, :], torch.inf, d2
    )
