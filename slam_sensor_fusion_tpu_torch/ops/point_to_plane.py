"""Point-to-plane Gauss-Newton scan-to-map registration, native mode (port
of the JAX `ops/point_to_plane.py`).

* map normals are estimated ONCE per anchor refresh: by voxel-cell PCA
  (`estimate_normals`: sort + segment sums + a batched `eigh`), by PCA over
  fixed Morton-contiguous chunks (`estimate_normals_tiled`), or by cell PCA
  over truncated-Morton runs with cumulative-sum moments and an analytic
  3x3 eigenvector (`estimate_normals_cells`, the bench's estimator). No
  kd-tree, no per-point neighbour search. Normal ORIENTATION is arbitrary
  in all three (the plane residual and its Jacobian flip together).
* each GN iteration of `point_to_plane_align`: 1-NN correspondences from
  the dense sweep (ops/nn.py, `nn_backend="xla"`) or from K2 on a pair list
  (ops/nn_pallas.py, `nn_backend="pallas"`), residuals r = n . (p - q),
  Jacobian rows J = [n, (p x n)], the 6x6 JtJ / 6 Jtr as masked einsums,
  solve and left-compose exp(dx). Fixed iteration count, Huber weights.

The whole-GN kernel K4 and its halves are in ops/p2p_fused.py.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from slam_sensor_fusion_tpu_torch.ops import geometry, lapack_cpu
from slam_sensor_fusion_tpu_torch.ops import xla_math as xm
from slam_sensor_fusion_tpu_torch.ops.cloud import Cloud
from slam_sensor_fusion_tpu_torch.ops.morton import (
    _BITS,
    cloud_box,
    morton_codes,
    tile_bboxes,
)
from slam_sensor_fusion_tpu_torch.ops.nn import nearest_neighbor
from slam_sensor_fusion_tpu_torch.ops.nn_gated import pair_tiles
from slam_sensor_fusion_tpu_torch.ops.nn_pallas import (
    _build_tile_pair_list,
    make_pages,
    pair_nn,
)
from slam_sensor_fusion_tpu_torch.ops.ordered_scan import cumsum_rows
from slam_sensor_fusion_tpu_torch.ops.voxel_segsum import segment_sum_sorted


class PointToPlaneConfig(NamedTuple):
    """Static config (the JAX package's fields and defaults)."""

    num_iterations: int = 6
    max_correspondence_dist_sq: float = 1.0
    #: voxel size for normal estimation neighbourhoods [m]
    normal_voxel: float = 0.75
    #: cells with fewer points than this get no (invalid) normal
    min_cell_points: int = 5
    #: Huber kernel width on the plane residual [m]
    huber_delta: float = 0.3
    #: Levenberg damping added to JtJ's diagonal
    damping: float = 1e-4
    tile_src: int = 256
    tile_tgt: int = 512
    max_visits: int = 24
    #: pair-list capacity = max_pairs_factor * n_source_tiles (fused
    #: kernels); compact scenes where most tile pairs are admissible need
    #: headroom past the default or the list truncates (nearest-first)
    max_pairs_factor: int = 16
    reassoc_margin: float = 0.5
    #: "xla" = the dense sweep (ops/nn.py); "pallas" = K2 on a pair list;
    #: "fused" = the whole-GN kernel K4 (models/lio.py dispatches on it)
    nn_backend: str = "pallas"
    #: kept for the JAX package's configs; the port has no interpret mode
    #: (CPU tensors run the kernels' plain versions)
    pallas_interpret: bool = False
    #: (fused kernel) associate ONCE at the prior and keep the matched
    #: point/normal set fixed across all GN iterations + the stats pass
    fixed_correspondences: bool = False
    #: the TPU kernels' pair-loop unrolling; results are identical for any
    #: value and the CUDA kernels ignore it
    assoc_unroll: int = 1


class PointToPlaneResult(NamedTuple):
    transformation: torch.Tensor  # (4, 4)
    rmse: torch.Tensor  # () plane-residual RMS over inliers
    n_correspondences: torch.Tensor  # () int32 from the final iteration
    #: unscaled (6, 6) covariance of the (dp, dtheta_body) pose error from
    #: the final GN moments (pose_covariance_from_jtj)
    cov_pose: torch.Tensor | None = None
    #: sum of w_in * r^2 over inliers at the final transform
    wr2: torch.Tensor | None = None


def pose_covariance_from_jtj(JtJ: torch.Tensor, T: torch.Tensor, reg: float = 1e-6) -> torch.Tensor:
    """Map the GN information matrix to a pose-error covariance.

    `JtJ` is the (Huber-weighted) 6x6 system of the left-perturbation
    parameterization T <- exp([rho, phi]) T, expressed in whatever frame
    the GN ran in; `T` is the final transform IN THAT FRAME. The EKF's
    measurement error is (dp, dtheta_body) with dp = rho + phi x t and
    dtheta_body = R^T phi, so the returned covariance is
    C (JtJ + reg I)^-1 C^T with C = [[I, -skew(t)], [0, R^T]]. Scale by the
    residual variance sigma^2 before use as a measurement covariance."""
    R = T[:3, :3]
    t = T[:3, 3]
    eye3 = torch.eye(3, dtype=torch.float32, device=T.device)
    inv = _inv(JtJ + reg * torch.eye(6, dtype=torch.float32, device=T.device))
    top = torch.cat([eye3, -geometry.skew(t)], dim=1)
    bot = torch.cat([torch.zeros_like(eye3), R.T], dim=1)
    C = torch.cat([top, bot], dim=0)
    return C @ inv @ C.T


def estimate_normals(
    points: torch.Tensor,
    mask: torch.Tensor,
    voxel: float,
    min_cell_points: int = 5,
    grid_dim: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-point normals by voxel-cell PCA.

    Returns (normals (N, 3), valid (N,)). Cells are `voxel`-sized; each
    valid point takes the smallest-eigenvalue eigenvector of its cell's
    covariance. Orientation is arbitrary.
    """
    N = points.shape[0]
    dev = points.device
    order, seg, valid_s, (sums, cnts, sq) = _voxel_moments(points, mask, voxel, grid_dim)
    c = torch.clamp(cnts, min=1.0)
    mean = sums / c[:, None]
    cov = sq / c[:, None, None] - mean[:, :, None] * mean[:, None, :]
    # regularize for eigh stability
    cov = cov + 1e-9 * torch.eye(3, dtype=torch.float32, device=dev)[None]
    _, vecs = _eigh(cov)  # ascending eigenvalues
    cell_normal = vecs[..., 0]  # smallest-eigenvalue direction
    cell_valid = cnts >= min_cell_points

    # scatter back to original point order
    normals = torch.empty((N, 3), dtype=torch.float32, device=dev)
    normals[order] = cell_normal[seg]
    nvalid = torch.empty((N,), dtype=torch.bool, device=dev)
    nvalid[order] = cell_valid[seg] & valid_s
    return normals, nvalid & mask


def _voxel_moments(
    points: torch.Tensor, mask: torch.Tensor, voxel: float, grid_dim: int = 1024
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, tuple]:
    """`estimate_normals`' cells: the rows sorted by cell (`order`), each
    sorted row's cell id (`seg`, int32, the invalid rows in the overflow
    bucket N), the sorted mask, and the N + 1 cells' (sums (3,), count,
    second moments (3, 3)), each cell 0.0 plus its rows in row order as the
    JAX package's scatter-add adds them (`voxel_segsum.segment_sum_sorted`:
    on the card one launch, the same bits as the CPU's)."""
    N = points.shape[0]
    dev = points.device
    origin = torch.where(mask[:, None], points, torch.inf).amin(dim=0)
    origin = torch.where(torch.isfinite(origin), origin, 0.0)
    # the JAX LIO divides by its static `voxel`, which XLA rewrites as a
    # product with the float32 reciprocal (a point on a cell's edge floors
    # otherwise than under a true division): the same product on either
    # device
    inv = float(torch.tensor(1.0) / torch.tensor(voxel, dtype=torch.float32))
    cell = torch.floor((points - origin[None]) * inv)
    ijk = torch.clamp(cell, 0, grid_dim - 1).to(torch.int32)
    lin = (ijk[:, 0] * grid_dim + ijk[:, 1]) * grid_dim + ijk[:, 2]
    lin = torch.where(mask, lin, torch.iinfo(torch.int32).max)

    lin_s, order = torch.sort(lin, stable=True)
    pts_s = points[order]
    valid_s = mask[order]

    first = torch.cat([lin_s.new_ones(1, dtype=torch.bool), lin_s[1:] != lin_s[:-1]]) & valid_s
    seg = torch.cumsum(first.to(torch.int32), dim=0, dtype=torch.int32) - 1
    seg = torch.where(valid_s, seg, N)  # overflow bucket

    # each sorted row's 13 moment columns (x, y, z, weight, the 9 products;
    # weight 0 in the overflow bucket), padded to 16, go in as 4 groups of
    # 4, group g's rows under the ids g (N + 1) + seg: nondecreasing ids
    w = valid_s.float()
    outer = pts_s[:, :, None] * pts_s[:, None, :] * w[:, None, None]
    cols = torch.cat([pts_s * w[:, None], w[:, None], outer.reshape(N, 9),
                      pts_s.new_zeros((N, 3))], dim=1)
    values = cols.reshape(N, 4, 4).transpose(0, 1).reshape(4 * N, 4)
    offsets = torch.arange(4, dtype=torch.int32, device=dev)[:, None] * (N + 1)
    mom = segment_sum_sorted(values, (seg[None, :] + offsets).reshape(4 * N), 4 * (N + 1))
    mom = mom.reshape(4, N + 1, 4).transpose(0, 1).reshape(N + 1, 16)
    return order, seg, valid_s, (mom[:, :3], mom[:, 3], mom[:, 4:13].reshape(N + 1, 3, 3))


#: matrices an eigen-solve call takes: cuSOLVER's batched solver
#: (cusolverDnXsyevBatched, under torch 2.11 and CUDA 12.8 on an H100)
#: refuses a batch of 32 767 or more 3 x 3 matrices and takes 16 385; the
#: voxel estimator has N + 1 cells, 65 537 at the LIO's ring
_EIGH_BATCH = 1 << 14


def _eigh(cov: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The eigen-solve of (B, 3, 3) symmetric matrices, ascending: on the
    CPU jaxlib's own `ssyevd` (ops/lapack_cpu, bit-equal to the JAX
    package's `jnp.linalg.eigh`, eigenvector signs included); on the card
    `torch.linalg.eigh`, `_EIGH_BATCH` matrices a cuSOLVER call."""
    if cov.device.type == "cpu":
        return lapack_cpu.eigh(cov)
    return _eigh_in_parts(torch.linalg.eigh, cov)


def _eigh_in_parts(fn, cov: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`fn` (an eigen-solve) over `cov`, _EIGH_BATCH matrices at a time:
    each matrix is solved on its own, so the split moves no bit."""
    parts = [fn(c) for c in cov.split(_EIGH_BATCH)]
    return torch.cat([w for w, _ in parts]), torch.cat([v for _, v in parts])


def _inv(a: torch.Tensor) -> torch.Tensor:
    """`torch.linalg.inv` on the card; on the CPU jaxlib's LAPACK, as the
    JAX package's jitted `jnp.linalg.inv` (ops/lapack_cpu)."""
    return lapack_cpu.inv(a) if a.device.type == "cpu" else torch.linalg.inv(a)


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`torch.linalg.solve` on the card; on the CPU jaxlib's LAPACK, as the
    JAX package's jitted `jnp.linalg.solve` (ops/lapack_cpu)."""
    return lapack_cpu.solve(a, b) if a.device.type == "cpu" else torch.linalg.solve(a, b)


def estimate_normals_tiled(
    points: torch.Tensor,
    mask: torch.Tensor,
    chunk: int = 32,
    min_chunk_points: int = 5,
    max_planarity: float = 0.25,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-point normals by PCA over fixed Morton-contiguous chunks, for
    clouds that are ALREADY Morton-sorted (the LIO anchor is): consecutive
    runs of `chunk` points are spatially compact, so each run's covariance
    is a usable local plane estimate. Crease/volume chunks (lam_min
    comparable to lam_mid) are dropped by the planarity gate."""
    N = points.shape[0]
    C = N // chunk
    dev = points.device
    P = points[: C * chunk].reshape(C, chunk, 3)
    w = mask[: C * chunk].reshape(C, chunk).float()
    cnt = w.sum(dim=1)
    denom = torch.clamp(cnt, min=1.0)[:, None]
    if dev.type == "cpu":
        # the jitted JAX function's order: each chunk's sum XLA's reduction
        # (`_xla_sum_rows`), its X^T X XLA's elemental dot, an fma chain
        # along the chunk from 0 (the card keeps one reduction each)
        mean = _xla_sum_rows(P * w[..., None]) / denom
        X = (P - mean[:, None, :]) * w[..., None]
        dot = X[:, 0, :, None] * X[:, 0, None, :] + 0.0
        for k in range(1, chunk):
            dot = xm.fma32(X[:, k, :, None], X[:, k, None, :], dot)
    else:
        mean = (P * w[..., None]).sum(dim=1) / denom
        X = (P - mean[:, None, :]) * w[..., None]
        dot = torch.einsum("cki,ckj->cij", X, X)
    cov = dot / denom[..., None]
    cov = cov + 1e-9 * torch.eye(3, dtype=torch.float32, device=dev)[None]
    vals, vecs = _eigh(cov)  # ascending
    chunk_normal = vecs[..., 0]  # (C, 3)
    planar = vals[..., 0] < max_planarity * torch.clamp(vals[..., 1], min=1e-12)
    chunk_valid = (cnt >= min_chunk_points) & planar

    normals = chunk_normal[:, None, :].expand(C, chunk, 3).reshape(C * chunk, 3)
    valid = chunk_valid[:, None].expand(C, chunk).reshape(C * chunk)
    if C * chunk < N:  # ragged tail: no normals
        pad = N - C * chunk
        normals = torch.cat([normals, normals.new_zeros((pad, 3))], dim=0)
        valid = torch.cat([valid, valid.new_zeros(pad)])
    return normals, valid & mask


#: XLA's CPU reduction: a reduced dimension longer than this is first
#: summed in windows of this many consecutive elements
_REDUCE_WINDOW = 32


def _xla_sum_rows(x: torch.Tensor) -> torch.Tensor:
    """x (C, K, D) summed over K as XLA's CPU code sums it: while K exceeds
    32, a reduce-window of 32 consecutive rows (SAME padding, the padding
    added as +0.0), each window summed in order from 0; then the rest in
    order from 0."""
    W = _REDUCE_WINDOW
    while x.shape[1] > W:
        C, K, D = x.shape
        o = -(-K // W)
        pad = o * W - K
        x = torch.nn.functional.pad(x, (0, 0, pad // 2, pad - pad // 2)).reshape(C, o, W, D)
        acc = torch.zeros((C, o, D), dtype=x.dtype, device=x.device)
        for k in range(W):
            acc = acc + x[:, :, k]
        x = acc
    acc = torch.zeros_like(x[:, 0])
    for k in range(x.shape[1]):
        acc = acc + x[:, k]
    return acc


def _smallest_eigvec3(cov: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Analytic smallest eigenpair of symmetric (..., 3, 3) matrices: the
    trigonometric eigenvalue formula and the largest of the three row cross
    products of (A - lam_min I). Returns (eigvec (..., 3), lam_min,
    lam_mid).

    Rounded as XLA compiles the JAX function inside the jitted normals on
    the CPU (ops/xla_math; the fusions' object code, run on the same
    inputs): divisions by 3 and 6 as products, the sums of squares,
    determinant and cross products as fused multiply-add chains, XLA's
    arccos and glibc's cosf, correctly rounded square roots. XLA splits the
    solve over fusions that each recompute what they need and contract it
    their own way: p's fusion fuses the last square of sum(a_ij^2), the
    determinant's does not (its a12^2 has a second use) and divides by
    p2 p; the cosine's argument is fma(acos, 1/3, 2 pi / 3); the x01 cross
    product's fusion takes lam_min as fma(trace, 1/3, 2 p cos), the
    others as fma(2 p, cos, q)."""
    a00 = cov[..., 0, 0]
    a11 = cov[..., 1, 1]
    a22 = cov[..., 2, 2]
    a01 = cov[..., 0, 1]
    a02 = cov[..., 0, 2]
    a12 = cov[..., 1, 2]
    f = xm.fma32
    third = torch.full_like(a00, _THIRD)
    tr = (a00 + a11) + a22
    q = tr * _THIRD
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    s1 = f(b22, b22, f(b00, b00, b11 * b11))
    s01 = f(a01, a01, a02 * a02)
    p = xm.sqrtf(torch.clamp(f(f(a12, a12, s01), third, s1 * _SIXTH), min=1e-30))
    p2 = torch.clamp(f(s01 + a12 * a12, third, s1 * _SIXTH), min=1e-30)
    # det(B)/2 with B = (A - qI)/p
    detB = f(a02, f(a01, a12, -(b11 * a02)),
             f(b00, f(b11, b22, -(a12 * a12)), -(a01 * f(a01, b22, -(a12 * a02))))) / (p2 * p)
    acos_r = xm.acosf(torch.clamp(detB * 0.5, -1.0, 1.0))
    p_2 = p * 2.0
    cos_min = xm.cosf(f(acos_r, third, torch.full_like(a00, _TWO_PI_3)))
    lam_max = f(p_2, xm.cosf(acos_r * _THIRD), q)
    lam_min = f(p_2, cos_min, q)
    lam_mid = 3.0 * q - lam_max - lam_min
    lam_01 = f(tr, third, p_2 * cos_min)
    x01 = xm.cross3((a00 - lam_01, a01, a02), (a01, a11 - lam_01, a12))
    x02 = xm.cross3((a00 - lam_min, a01, a02), (a02, a12, a22 - lam_min))
    x12 = xm.cross3((a01, a11 - lam_min, a12), (a02, a12, a22 - lam_min))
    n01, n02, n12 = xm.sumsq3(*x01), xm.sumsq3(*x02), xm.sumsq3(*x12)
    x01, x02, x12 = (torch.stack(x, dim=-1) for x in (x01, x02, x12))
    best = torch.where(
        (n01 >= n02)[..., None] & (n01 >= n12)[..., None],
        x01,
        torch.where((n02 >= n12)[..., None], x02, x12),
    )
    nrm = xm.sqrtf(torch.maximum(n01, torch.maximum(n02, n12)))
    vec = best / torch.clamp(xm.sqrtf(xm.norm2(best)), min=1e-20)[..., None]
    # fully degenerate (isotropic) matrices: arbitrary unit vector
    up = torch.zeros_like(vec)
    up[..., 2] = 1.0
    vec = torch.where((nrm > 1e-20)[..., None], vec, up)
    return vec, lam_min, lam_mid


#: divisions by constants as XLA rewrites them: products with the float32
#: reciprocals
_THIRD = 1.0 / 3.0
_SIXTH = 1.0 / 6.0
_TWO_PI_3 = 2.0 * math.pi / 3.0


def _cell_eigen(seg: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each point's cell covariance from its cell moments (N, 10: count,
    sums, xx yy zz xy xz yz), then its smallest eigenpair
    (`_smallest_eigvec3`): (normals, lam_min, lam_mid). One launch of
    csrc/xla_math.cu on the card, a thread a point; these tensor ops are
    its plain version."""
    if xm.on_card(seg):
        n = seg.shape[0]
        normals = torch.empty((n, 3), dtype=seg.dtype, device=seg.device)
        lam_min, lam_mid = torch.empty_like(seg[:, 0]), torch.empty_like(seg[:, 0])
        xm.launch("cell_normals", [xm.rows(seg, 10)], [normals, lam_min, lam_mid], n=n)
        return normals, lam_min, lam_mid
    c = torch.clamp(seg[:, 0], min=1.0)
    mx, my, mz = seg[:, 1] / c, seg[:, 2] / c, seg[:, 3] / c
    # E[ab] - E[a] E[b] as XLA contracts it: fma(-E[a], E[b], E[ab])
    cxx = xm.fma32(-mx, mx, seg[:, 4] / c)
    cyy = xm.fma32(-my, my, seg[:, 5] / c)
    czz = xm.fma32(-mz, mz, seg[:, 6] / c)
    cxy = xm.fma32(-mx, my, seg[:, 7] / c)
    cxz = xm.fma32(-mx, mz, seg[:, 8] / c)
    cyz = xm.fma32(-my, mz, seg[:, 9] / c)
    cov = torch.stack(
        [
            torch.stack([cxx, cxy, cxz], dim=-1),
            torch.stack([cxy, cyy, cyz], dim=-1),
            torch.stack([cxz, cyz, czz], dim=-1),
        ],
        dim=-2,
    ) + 1e-9 * torch.eye(3, dtype=torch.float32, device=seg.device)[None]
    return _smallest_eigvec3(cov)


def _cell_moments(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(N, 10) per-point moments of the cell normals, masked: count, sums,
    xx yy zz xy xz yz (a masked row at a negative coordinate gives -0.0)."""
    w = mask.to(points.dtype)
    x, y, z = points[:, 0] * w, points[:, 1] * w, points[:, 2] * w
    return torch.stack(
        [
            w, x, y, z,
            x * points[:, 0], y * points[:, 1], z * points[:, 2],
            x * points[:, 1], x * points[:, 2], y * points[:, 2],
        ],
        dim=1,
    )


def estimate_normals_cells(
    points: torch.Tensor,
    mask: torch.Tensor,
    cell_size: float = 0.75,
    min_cell_points: int = 5,
    max_planarity: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Voxel-cell PCA normals for a MORTON-SORTED cloud, scatter-free.

    A truncated Morton code IS a spatial octant cell, and in Morton-sorted
    order each cell's points form a CONTIGUOUS RUN, so per-cell moments are
    cumulative-sum differences at run boundaries (two gathers), and the
    smallest eigenvector comes from the analytic 3x3 solver. The cell edge
    is the power-of-2 fraction of the cloud's cube extent nearest above
    `cell_size`. Callers pass the cloud ALREADY sorted by
    `sort_by_morton(..., isotropic=True)`.

    The moments are differences of float32 prefix sums over the whole
    cloud at world coordinates, exactly as the JAX package takes them: the
    sums reach ~1e6 while a cell's variance is ~1e-2, so the scan's order
    of addition decides thin cells' normals. `ordered_scan.cumsum_rows`
    adds in XLA's order (on the card, a kernel bit-equal to the CPU's), so
    the normals agree with the JAX package's to the 3x3 eigen-solve's
    rounding and the valid mask is equal."""
    seg = _cell_segments(points, mask, cell_size)
    cnt = seg[:, 0]
    normals, lam_min, lam_mid = _cell_eigen(seg)
    valid = mask & (cnt >= min_cell_points)
    if max_planarity is not None:
        valid = valid & (lam_min < max_planarity * torch.clamp(lam_mid, min=1e-12))
    return normals, valid


def _cell_segments(points: torch.Tensor, mask: torch.Tensor, cell_size: float) -> torch.Tensor:
    """Each point's cell moments (N, 10: count, sums, xx yy zz xy xz yz) in
    a Morton-sorted cloud: differences of the prefix sums at the runs'
    boundaries (`estimate_normals_cells`)."""
    N = points.shape[0]
    dev = points.device
    lo, hi = cloud_box(Cloud(points, mask), isotropic=True)
    codes = morton_codes(points, mask, lo, hi)

    # level with cell edge <= cell_size: l = ceil(log2(extent / cell_size))
    extent = torch.clamp(hi - lo, min=1e-6).max()
    lvl = torch.clamp(torch.ceil(torch.log2(extent / cell_size)).to(torch.int32), 1, _BITS)
    drop = 3 * (_BITS - lvl)
    cell = codes >> drop  # codes are non-negative

    csum = cumsum_rows(_cell_moments(points, mask))

    idx = torch.arange(N, device=dev)
    boundary = cell[1:] != cell[:-1]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    firstmask = torch.cat([one, boundary])
    # run start per point: last boundary index <= i; run end: next boundary - 1
    start = torch.cummax(torch.where(firstmask, idx, 0), dim=0).values
    nxt = torch.cat([boundary, one])
    end = torch.cummin(torch.where(nxt, idx, N - 1).flip(0), dim=0).values.flip(0)

    seg_hi = csum[end]
    seg_lo = torch.where((start > 0)[:, None], csum[torch.clamp(start - 1, min=0)], 0.0)
    return seg_hi - seg_lo


def _transform_xla(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """(N, 3) points under T as XLA's CPU code computes the JAX
    `transform_points` (an elemental dot, each coordinate an fma chain from
    0 along k, then + t)."""
    R = T[:3, :3]
    rot = [points[:, 0] * R[i, 0] + 0.0 for i in range(3)]
    for k in (1, 2):
        rot = [xm.fma32(points[:, k], R[i, k], rot[i]) for i in range(3)]
    return torch.stack(rot, dim=-1) + T[:3, 3]


#: XLA's CPU library dot (Eigen's contraction) of the GN's (M, 6)^T (M, 6):
#: the M rows go in blocks of `_DOT_BLOCK` at most, balanced and aligned
#: to 8 (the last takes the rest); a block longer than `_DOT_HALF` is two
#: fma chains, its halves (the first the longer); the chains' sums are
#: added in order. Read off the jitted `jax.lax.dot_general` on an x86-64
#: host with a 48 KiB L1 data cache (AVX-512), for up to 9 736 rows; past
#: that XLA shards the rows over its thread pool, an order that depends on
#: the host's cores, which this does not follow
_DOT_BLOCK = 608
_DOT_HALF = 384


def _dot_chains(M: int) -> list[tuple[int, int]]:
    """The [start, end) row ranges of the library dot's fma chains."""
    nb = -(-M // _DOT_BLOCK)
    bs = -(-(M // nb) // 8) * 8
    chains = []
    for s in range(0, M, bs):
        e = min(s + bs, M)
        if e - s <= _DOT_HALF:
            chains.append((s, e))
        else:
            h = s + -(-(e - s) // 2)
            chains += [(s, h), (h, e)]
    return chains


def _jtj_xla(J: torch.Tensor, Jw: torch.Tensor) -> torch.Tensor:
    """sum_m J[m, i] Jw[m, j] as the jitted JAX `einsum("mi,mj,m->ij")`
    sums it on the CPU (`_dot_chains`)."""
    out = torch.zeros((J.shape[1], Jw.shape[1]), dtype=torch.float32)
    for s, e in _dot_chains(J.shape[0]):
        acc = J[s, :, None] * Jw[s, None, :]
        for m in range(s + 1, e):
            acc = xm.fma32(J[m, :, None], Jw[m, None, :], acc)
        out = out + acc
    return out


def _jtr_xla(J: torch.Tensor, rw: torch.Tensor) -> torch.Tensor:
    """sum_m J[m, i] rw[m] as XLA's emitted gemv: one fma chain along m."""
    acc = J[0] * rw[0]
    for m in range(1, J.shape[0]):
        acc = xm.fma32(J[m], rw[m], acc)
    return acc


def _k2_lists(
    source: torch.Tensor,
    source_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    initial_T: torch.Tensor,
    config: PointToPlaneConfig,
) -> tuple[tuple, torch.Tensor]:
    """`point_to_plane_align`'s K2 inputs, built once at the prior: the
    tile-major pair list (start, cnt, tgt) of n_source_tiles * 8 slots and
    the target pages rebased on the prior's translation."""
    M, TM, TN = source.shape[0], config.tile_src, config.tile_tgt
    search_r2 = (math.sqrt(config.max_correspondence_dist_sq) + config.reassoc_margin) ** 2
    pts0 = geometry.transform_points(initial_T, source)
    lo_s, hi_s, cnt_s = tile_bboxes(pts0, source_mask, TM)
    lo_t, hi_t, _ = tile_bboxes(target, target_mask, TN)
    visits, counts, _ = pair_tiles(lo_s, hi_s, cnt_s, lo_t, hi_t, search_r2, config.max_visits)
    pairs = _build_tile_pair_list(visits, counts, M // TM * 8)
    return pairs, make_pages(target, target_mask, initial_T[:3, 3], TN)


def point_to_plane_align(
    source: torch.Tensor,
    source_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    target_normals: torch.Tensor,
    target_normals_valid: torch.Tensor,
    initial_T: torch.Tensor,
    config: PointToPlaneConfig = PointToPlaneConfig(),
) -> PointToPlaneResult:
    """Gauss-Newton point-to-plane alignment of source onto target, one
    association and a handful of tensor ops an iteration. `nn_backend`
    "pallas" associates with K2 on a tile-major pair list built once at the
    prior (capacities must be multiples of the tiles, else the dense sweep
    runs, as in the JAX package); anything else runs the dense sweep."""
    center = initial_T[:3, 3]
    M, N = source.shape[0], target.shape[0]
    TM, TN = config.tile_src, config.tile_tgt
    gate = config.max_correspondence_dist_sq

    if config.nn_backend == "pallas" and M % TM == 0 and N % TN == 0:
        pairs, tgt_pages = _k2_lists(source, source_mask, target, target_mask, initial_T, config)

        def associate(pts):
            pages = make_pages(pts, source_mask, center, TM)
            d2, idx, _ = pair_nn(pages, tgt_pages, *pairs)
            return d2.reshape(M), idx.reshape(M)

    else:

        def associate(pts):
            return nearest_neighbor(pts, source_mask, target, target_mask, center)

    # on the CPU the jitted JAX function's order (`_transform_xla`, the
    # residual and cross product as fma chains, `_jtj_xla`, `_jtr_xla`,
    # sums in windows of 32); the card keeps one tensor op each
    xla = source.device.type == "cpu"

    def linearize(T):
        """Association and residuals at T: (w_in, r, J (M, 6))."""
        pts = _transform_xla(T, source) if xla else geometry.transform_points(T, source)
        d2, idx = associate(pts)
        idx = idx.long()
        q = target[idx]
        n = target_normals[idx]
        nv = target_normals_valid[idx]
        w_in = (source_mask & (d2 < gate) & nv).float()
        # J row: d r / d xi with xi = [rho, phi], T <- exp(xi) T
        if xla:
            d = pts - q
            r = xm.fma32(n[:, 2], d[:, 2], xm.fma32(n[:, 1], d[:, 1], n[:, 0] * d[:, 0] + 0.0))
            pxn = xm.cross3(pts.unbind(-1), n.unbind(-1))
            return w_in, r, torch.cat([n, torch.stack(pxn, dim=-1)], dim=-1)
        r = (n * (pts - q)).sum(dim=-1)  # signed plane distance
        J = torch.cat([n, torch.linalg.cross(pts, n)], dim=-1)
        return w_in, r, J

    def moments(J, w, rw=None):
        """JtJ (and Jtr) of the weighted rows."""
        if xla:
            return _jtj_xla(J, J * w[:, None]), None if rw is None else _jtr_xla(J, rw)
        JtJ = torch.einsum("mi,mj,m->ij", J, J, w)
        return JtJ, None if rw is None else torch.einsum("mi,m->i", J, rw)

    def huber(r):
        # a true division, as XLA's (torch's `delta / x` multiplies by the
        # reciprocal); launches as many kernels on the card
        den = torch.clamp(r.abs(), min=1e-12)
        return torch.clamp(torch.full_like(den, config.huber_delta) / den, max=1.0)

    eye6 = torch.eye(6, dtype=torch.float32, device=source.device)
    T = initial_T
    for _ in range(config.num_iterations):
        w_in, r, J = linearize(T)
        w = w_in * huber(r)
        JtJ, Jtr = moments(J, w, r * w)
        dx = -_solve(JtJ + config.damping * eye6, Jtr)
        step = geometry.se3_exp(dx)
        T = xm.mm3(step, T) if xla else step @ T

    # final stats (+ the GN covariance export: Huber-weighted JtJ at the
    # final transform)
    w, r, J = linearize(T)
    if xla:  # XLA's reduction of the M rows (windows of 32)
        wr2 = _xla_sum_rows((w * r * r)[None, :, None])[0, 0]
        rmse = xm.sqrtf(wr2 / torch.clamp(_xla_sum_rows(w[None, :, None])[0, 0], min=1.0))
    else:
        wr2 = (w * r * r).sum()
        rmse = torch.sqrt(wr2 / torch.clamp(w.sum(), min=1.0))
    JtJ, _ = moments(J, w * huber(r))
    return PointToPlaneResult(
        transformation=T,
        rmse=rmse,
        n_correspondences=w.sum().to(torch.int32),
        cov_pose=pose_covariance_from_jtj(JtJ, T),
        wr2=wr2,
    )
