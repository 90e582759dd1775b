"""Fixed-capacity masked point clouds (port of the JAX `ops/cloud.py`).

A cloud is a `(capacity, 3)` float32 tensor plus a `(capacity,)` bool
validity mask. Host loaders produce *packed* clouds (valid points first);
device ops are mask-tolerant.

Reference ports:
* uniform_subsample   <- applyUniformSubsample (point_cloud_processing.hpp:55-74)
* crop_radius         <- cropPointCloudThroughRadius (:31-53), as a masked
                         distance test
* crop_box, crop_obb  <- the Python twin's box filter and oriented map crop
                         (localization_node.py:105-115, :222-225)
* remove_floor        <- removeFloor (:76-92) (keeps z > 0)
* voxel_downsample_numpy <- pcl::VoxelGrid centroid mode
                         (global_map_frames_manager.cpp:143-146)
* voxel_downsample    <- the same on the device: a stable sort of the voxel
                         ids, then the order-exact segment sum
                         (ops/voxel_segsum)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slam_sensor_fusion_tpu_torch.ops.voxel_segsum import segment_sum_sorted


class Cloud(NamedTuple):
    """A fixed-capacity masked point cloud."""

    points: torch.Tensor  # (N, 3) float32; invalid rows hold arbitrary data
    mask: torch.Tensor  # (N,) bool

    @property
    def capacity(self) -> int:
        return self.points.shape[-2]

    def count(self) -> torch.Tensor:
        return self.mask.sum(dim=-1, dtype=torch.int32)


def dist2(points: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """|p - c|^2 summed x, y, z in that order (the JAX package's order, so
    masks at the crop boundary agree bit for bit)."""
    d = points - center
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def from_numpy(
    points: np.ndarray, capacity: int, device: torch.device | str = torch.device("cuda")
) -> Cloud:
    """Pack a host (n, 3) array into a padded Cloud of given capacity."""
    points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    n = min(points.shape[0], capacity)
    buf = np.zeros((capacity, 3), dtype=np.float32)
    buf[:n] = points[:n]
    mask = np.zeros((capacity,), dtype=bool)
    mask[:n] = True
    return Cloud(
        torch.from_numpy(buf).to(device), torch.from_numpy(mask).to(device)
    )


def to_numpy(cloud: Cloud) -> np.ndarray:
    """The valid points of a cloud as a host (n, 3) array."""
    pts = cloud.points.detach().cpu().numpy()
    return pts[cloud.mask.detach().cpu().numpy()]


def uniform_subsample(cloud: Cloud, step: int) -> Cloud:
    """Keep every ``step``-th point by buffer index; a cloud with fewer
    points than ``step`` is kept whole, like the reference's early-out."""
    if step <= 1:
        return cloud
    idx = torch.arange(cloud.capacity, device=cloud.mask.device)
    keep = (idx % step == 0) & cloud.mask
    tiny = cloud.count() < step
    return Cloud(cloud.points, torch.where(tiny, cloud.mask, keep))


def crop_radius(cloud: Cloud, center: torch.Tensor, radius: float) -> Cloud:
    """Keep points within ``radius`` of ``center`` (masked, exact)."""
    keep = (dist2(cloud.points, center) <= radius * radius) & cloud.mask
    return Cloud(cloud.points, keep)


def crop_box(cloud: Cloud, min_bound: torch.Tensor, max_bound: torch.Tensor) -> Cloud:
    """Axis-aligned box crop (the Python twin's scan filter,
    localization_node.py:105-115)."""
    p = cloud.points
    keep = (p >= min_bound).all(dim=-1) & (p <= max_bound).all(dim=-1) & cloud.mask
    return Cloud(cloud.points, keep)


def crop_obb(cloud: Cloud, T: torch.Tensor, extent: torch.Tensor) -> Cloud:
    """Oriented-bounding-box crop: keep points within +-extent/2 of T's
    origin along T's axes (open3d OrientedBoundingBox crop,
    localization_node.py:222-225)."""
    local = (cloud.points - T[:3, 3]) @ T[:3, :3]  # R^T applied rowwise
    keep = (local.abs() <= extent / 2.0).all(dim=-1) & cloud.mask
    return Cloud(cloud.points, keep)


def remove_floor(cloud: Cloud) -> Cloud:
    """Drop points with z <= 0 (point_cloud_processing.hpp:76-92)."""
    return Cloud(cloud.points, (cloud.points[:, 2] > 0.0) & cloud.mask)


def _packed_mask(cloud: Cloud, out_capacity: int) -> torch.Tensor:
    n = torch.clamp(cloud.count(), max=out_capacity)
    return torch.arange(out_capacity, device=cloud.mask.device) < n


def compact(cloud: Cloud, out_capacity: int | None = None) -> Cloud:
    """Pack valid points to the front, preserving order. Rows past the
    valid count repeat row 0, as `jnp.nonzero(..., fill_value=0)` does."""
    out_capacity = out_capacity or cloud.capacity
    idx = torch.nonzero(cloud.mask).flatten()[:out_capacity]
    pad = out_capacity - idx.shape[0]
    if pad:
        idx = torch.cat([idx, idx.new_zeros(pad)])
    return Cloud(cloud.points[idx], _packed_mask(cloud, out_capacity))


def compact_by_distance(
    cloud: Cloud, center: torch.Tensor, out_capacity: int | None = None
) -> Cloud:
    """Pack valid points to the front, ORDERED by distance from `center`
    (PCL's radiusSearch returns distance-sorted hits,
    point_cloud_processing.hpp:37-49); stable, so ties keep index order."""
    out_capacity = out_capacity or cloud.capacity
    key = torch.where(cloud.mask, dist2(cloud.points, center), torch.inf)
    order = torch.argsort(key, stable=True)[:out_capacity]
    return Cloud(cloud.points[order], _packed_mask(cloud, out_capacity))


def sample_to_capacity(cloud: Cloud, out_capacity: int) -> Cloud:
    """Evenly sample the valid points into a (possibly smaller) capacity:
    exactly `compact` when they fit, an even stride over the packed order
    when they do not."""
    dev = cloud.mask.device
    n = cloud.count().to(torch.int64)
    # `compact` at full capacity without its data-dependent shape (no host
    # sync): a stable sort moves the valid rows to the front in order, rows
    # past the count take row 0
    order = torch.sort((~cloud.mask).to(torch.uint8), stable=True).indices
    rows = torch.arange(cloud.capacity, device=dev)
    packed = cloud.points[torch.where(rows < n, order, 0)]
    i = torch.arange(out_capacity, device=dev)
    idx = (i * n) // out_capacity  # hits every index once when n <= cap
    dup = torch.cat([idx.new_zeros(1, dtype=torch.bool), idx[1:] == idx[:-1]])
    return Cloud(packed[idx], (idx < n) & ~dup)


def packed_sample_indices(
    mask: torch.Tensor, out_capacity: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """`sample_to_capacity`'s selection for PACKED masks (the valid rows
    form a prefix, the loader contract for Morton-pre-sorted scans), as
    indices: (idx (..., out_capacity) int64, mask (..., out_capacity)).
    Callers gather only `out_capacity` rows, from the raw scan, before any
    per-point work. Same `(i * n) // cap` stride, duplicate kill and empty
    handling as `sample_to_capacity`; leading batch dimensions allowed."""
    n = mask.sum(dim=-1, dtype=torch.int64)[..., None]
    i = torch.arange(out_capacity, device=mask.device)
    idx = (i * n) // out_capacity
    first = torch.zeros_like(idx[..., :1], dtype=torch.bool)
    dup = torch.cat([first, idx[..., 1:] == idx[..., :-1]], dim=-1)
    return idx, (idx < n) & ~dup


def masked_points(cloud: Cloud, fill: float = float("inf")) -> torch.Tensor:
    """Points with invalid rows replaced by ``fill`` (for NN targets)."""
    return torch.where(cloud.mask[:, None], cloud.points, fill)


def _saturating_int32(f: torch.Tensor) -> torch.Tensor:
    """float -> int32 as XLA converts: out-of-range values saturate at the
    int32 limits and NaN becomes 0 (torch's own cast of such values is
    undefined, so the range is fixed in float and int64 first)."""
    f = torch.nan_to_num(f, nan=0.0).clamp(-(2.0**31), 2.0**31)
    return f.to(torch.int64).clamp(-(2**31), 2**31 - 1).to(torch.int32)


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap-around, as int32
    arithmetic in XLA overflows."""
    return ((x + 2**31) % 2**32 - 2**31).to(torch.int32)


def voxel_downsample(
    cloud: Cloud,
    voxel_size: float,
    out_capacity: int,
    origin: torch.Tensor | None = None,
    grid_dim: int = 2048,
) -> Cloud:
    """Centroid-per-voxel downsample with a fixed output capacity (the JAX
    package's device voxel grid, cloud.py:229-281).

    Voxel ids are linearized over a ``grid_dim``^3 grid anchored at
    ``origin`` (default: the masked min corner, a non-finite component 0)
    as ``(i * grid_dim + j) * grid_dim + k`` in int32 WITH wrap-around, as
    the JAX function computes them: at the default grid_dim, cells 1024
    apart in i share an id and i >= 512 gives negative ids, which sort
    first. Masked rows take the id int32 max. Rows are sorted by id
    (stable: a voxel's rows keep their order), each voxel numbered in id
    order, and the first ``out_capacity`` voxels summed by the order-exact
    segment sum with the counts as a fourth column; voxels past
    ``out_capacity`` are dropped. On the CPU the same bits as the JAX
    function."""
    dev = cloud.points.device
    pts, mask = cloud.points, cloud.mask
    if origin is None:
        origin = torch.where(mask[:, None], pts, torch.inf).amin(dim=0)
        origin = torch.where(torch.isfinite(origin), origin, 0.0)
    # a 0-d tensor divisor: a Python scalar on the card becomes a multiply
    # by its reciprocal, which rounds differently
    vs = torch.full((), voxel_size, dtype=pts.dtype, device=dev)
    ijk = _saturating_int32(torch.floor((pts - origin[None, :]) / vs)).to(torch.int64)
    i, j, k = torch.clamp(ijk, 0, grid_dim - 1).unbind(dim=-1)
    lin = _wrap_int32((i * grid_dim + j) * grid_dim + k)
    lin = torch.where(mask, lin, torch.iinfo(torch.int32).max)

    lin_s, order = torch.sort(lin, stable=True)
    valid_s = mask[order]
    first = torch.ones_like(valid_s)
    first[1:] = lin_s[1:] != lin_s[:-1]
    seg = torch.cumsum(first & valid_s, dim=0, dtype=torch.int32) - 1
    # the segment sum needs nondecreasing ids: masked rows (all +0.0, which
    # changes no bit of a sum that starts at +0.0) take the id of the valid
    # row before them (-1, no voxel, at the start); voxels past
    # out_capacity take the dropped id out_capacity
    seg = torch.where(valid_s, seg, -1).cummax(dim=0).values
    seg = torch.clamp(seg, max=out_capacity)
    vals = torch.cat([pts[order], torch.ones_like(pts[:, :1])], dim=1)
    vals = torch.where(valid_s[:, None], vals, 0.0)
    out = segment_sum_sorted(vals, seg, out_capacity)
    sums, cnts = out[:, :3], out[:, 3]
    return Cloud(sums / torch.clamp(cnts, min=1.0)[:, None], cnts > 0)


def voxel_downsample_numpy(
    points: np.ndarray, voxel_size: float, origin: np.ndarray | None = None
) -> np.ndarray:
    """Host (init-time) voxel centroid downsample on arbitrary extents,
    mirroring GlobalMapFramesManager::mergeScansAndSave
    (global_map_frames_manager.cpp:110-151). int64 ids, unbounded grid.
    ``origin`` pins the grid anchor (defaults to the data min corner)."""
    points = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    if points.shape[0] == 0:
        return points.astype(np.float32)
    if origin is None:
        origin = points.min(axis=0)
    else:
        origin = np.asarray(origin)
        if not (points >= origin - 1e-9).all():
            raise ValueError(
                "voxel_downsample_numpy: origin is above the data min "
                "(negative cell indices would collide); pass an origin "
                "<= the point minimum per axis"
            )
    ijk = np.floor((points - origin) / voxel_size).astype(np.int64)
    dims = ijk.max(axis=0) + 1
    lin = (ijk[:, 0] * dims[1] + ijk[:, 1]) * dims[2] + ijk[:, 2]
    order = np.argsort(lin, kind="stable")
    lin_s = lin[order]
    pts_s = points[order]
    first = np.concatenate([[True], lin_s[1:] != lin_s[:-1]])
    seg = np.cumsum(first) - 1
    nseg = seg[-1] + 1
    sums = np.zeros((nseg, 3))
    np.add.at(sums, seg, pts_s)
    cnts = np.zeros((nseg,))
    np.add.at(cnts, seg, 1.0)
    return (sums / cnts[:, None]).astype(np.float32)
