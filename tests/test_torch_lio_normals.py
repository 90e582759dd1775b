"""The three normal estimators, the analytic 3x3 eigenvector and the GN
covariance mapping of the PyTorch port (ops/point_to_plane) against the JAX
package on the same NumPy clouds.

Valid masks are EQUAL (cell counts are sums of 0/1, exact in float32).
 * voxel and tiled (per-cell sums + `eigh`): the normals are BIT-EQUAL to
   the JAX package's jitted functions, eigenvector signs included. On the
   CPU the port's eigen-solve is jaxlib's own (scipy's `ssyevd`, after
   jax's symmetrization: ops/lapack_cpu); the voxel estimator's moments are
   bit-equal to the JAX package's scatter-add (each cell's rows in row
   order, ops/voxel_segsum), near the origin and 40 m and 140 m off it; the
   tiled estimator's chunk sums follow XLA's reduction (windows of 32 rows)
   and its X^T X XLA's elemental dot (an fma chain along the chunk);
 * cells (moments as differences of a float32 cumulative sum over the whole
   cloud at world coordinates): the prefix sums reach ~1e6 while a cell's
   variance is ~1e-2, so the scan's order of addition decides the normals
   of thin cells. The port adds in XLA's order (ops/ordered_scan,
   tests/test_torch_ordered_scan.py) and rounds the covariance and the 3x3
   eigen-solve as XLA compiles them inside the jitted normals, as the LIO
   path runs them, fusion by fusion (fma(-E[a], E[b], E[ab]), the solve's
   fused chains, each fusion's own contraction of what it recomputes,
   XLA's arccos, glibc's cosf, correctly rounded sqrt: ops/xla_math,
   `_smallest_eigvec3`), so every normal, valid or not, is BIT-EQUAL to the
   jitted JAX function's within 12 m of the origin and shifted by
   (40, 30, 0) m and (140, -60, 2) m, with EQUAL valid masks, the planarity
   gate's too. The JAX function run op by op (eager, no fusion, no
   contraction) rounds otherwise. Against the same formula in float64, the
   port is no further than the JAX package is."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_sensor_fusion_tpu.ops import point_to_plane as jp
from slam_sensor_fusion_tpu.ops.cloud import Cloud as JCloud
from slam_sensor_fusion_tpu.ops.morton import sort_by_morton as jsort
from slam_sensor_fusion_tpu_torch.ops import point_to_plane as tp
from slam_sensor_fusion_tpu_torch.ops import xla_math as xm
from slam_sensor_fusion_tpu_torch.utils import synthetic as syn
from slam_sensor_fusion_tpu_torch.ops.geometry import transform_points
from slam_sensor_fusion_tpu_torch.ops.nn_pallas import make_pages, pair_nn_plain
from torch_lio_world import ground_and_walls, p2p_scene
from torch_parity import DEFAULT_THREADS, t


def _ring(seed, radius=25.0, shift=(0.0, 0.0, 0.0), cap=8192, n=7000):
    """A Morton-sorted (isotropic) masked cloud of ground, walls and poles
    within `radius` of a synthetic world's origin, moved by `shift`, as the
    LIO anchor is."""
    rng = np.random.default_rng(seed)
    world = syn.make_world(rng, extent=50.0, n_buildings=15, n_poles=40, points_per_m2=24.0)
    near = world[np.linalg.norm(world, axis=1) < radius]
    pts = near[rng.choice(len(near), n, replace=False)] + np.asarray(shift, np.float32)
    buf = np.zeros((cap, 3), np.float32)
    mask = np.zeros(cap, bool)
    slots = rng.choice(cap, n, replace=False)
    buf[slots], mask[slots] = pts, True
    s = jsort(JCloud(jnp.asarray(buf), jnp.asarray(mask)), isotropic=True)
    return np.asarray(s.points), np.asarray(s.mask)


@functools.partial(jax.jit, static_argnums=2)
def _jax_voxel_moments(points, mask, voxel):
    """The per-cell moments of the JAX package's `estimate_normals`
    (slam_sensor_fusion_tpu/ops/point_to_plane.py:124-157), jitted as the
    LIO runs it, `voxel` static (a field of its static config): XLA turns
    the division by it into a product with its float32 reciprocal. Its
    scatter-adds over the sorted cell ids."""
    N, grid_dim = points.shape[0], 1024
    origin = jnp.min(jnp.where(mask[:, None], points, jnp.inf), axis=0)
    origin = jnp.where(jnp.isfinite(origin), origin, 0.0)
    ijk = jnp.clip(jnp.floor((points - origin[None]) / voxel).astype(jnp.int32), 0, grid_dim - 1)
    lin = jnp.where(mask, (ijk[:, 0] * grid_dim + ijk[:, 1]) * grid_dim + ijk[:, 2],
                    jnp.iinfo(jnp.int32).max)
    order = jnp.argsort(lin)
    lin_s, pts_s, valid_s = lin[order], points[order], mask[order]
    first = jnp.concatenate([jnp.array([True]), lin_s[1:] != lin_s[:-1]]) & valid_s
    seg = jnp.where(valid_s, jnp.cumsum(first.astype(jnp.int32)) - 1, N)
    w = valid_s.astype(jnp.float32)
    outer = pts_s[:, :, None] * pts_s[:, None, :] * w[:, None, None]
    return (jnp.zeros((N + 1, 3), jnp.float32).at[seg].add(pts_s * w[:, None], mode="drop"),
            jnp.zeros((N + 1,), jnp.float32).at[seg].add(w, mode="drop"),
            jnp.zeros((N + 1, 3, 3), jnp.float32).at[seg].add(outer, mode="drop"))


def _unsigned_gap(n_t, n_j, valid):
    return 1.0 - np.abs((n_t * n_j).sum(-1))[valid]


#: the JAX package's voxel normals jitted as the LIO runs them
_jax_estimate_normals = jax.jit(jp.estimate_normals, static_argnums=2)


@pytest.mark.parametrize("voxel, shift, cloud", [
    pytest.param(0.75, (3.0, -2.0, 0.0), "ring", id="0.75"),
    pytest.param(1.5, (3.0, -2.0, 0.0), "ring", id="1.5"),
    pytest.param(0.75, (40.0, 30.0, 0.0), "ring", id="0.75-shifted"),
    pytest.param(1.8, (40.0, 30.0, 0.0), "ring", id="1.8-shifted"),
    pytest.param(0.75, (140.0, -60.0, 2.0), "ring", id="0.75-far"),
    pytest.param(1.8, (140.0, -60.0, 2.0), "ring", id="1.8-far"),
    pytest.param(0.75, (0.0, 0.0, 0.0), "edge", id="0.75-edge"),
    pytest.param(0.75, (40.0, 30.0, 0.0), "edge", id="0.75-edge-shifted"),
    pytest.param(1.8, (140.0, -60.0, 2.0), "walls", id="1.8-walls-far"),
])
def test_estimate_normals_voxel_matches_jax(voxel, shift, cloud):
    """Near the origin, and 40 m and 140 m off it (the LIO's ring is at
    world coordinates): the cell ids (the product with the edge's float32
    reciprocal, as XLA compiles the JAX LIO's division by its static
    `voxel`) and the per-cell moments, each cell's rows added in row order
    (`voxel_segsum.segment_sum_sorted`), are bit-equal to the JAX
    package's scatter-add. The "edge" clouds hold a point on a cell's
    edge, which a true division puts in another cell."""
    if cloud == "ring":
        pts, mask = _ring(0, radius=12.0, shift=shift)
    else:
        pts, mask = ground_and_walls(16, shift)
        d = pts - np.where(mask[:, None], pts, np.inf).min(0)
        moved = np.floor(d / np.float32(voxel)) != np.floor(d * (np.float32(1) / np.float32(voxel)))
        assert moved.any() == (cloud == "edge")
    *_, mom_t = tp._voxel_moments(t(pts), t(mask), voxel)
    mom_j = _jax_voxel_moments(jnp.asarray(pts), jnp.asarray(mask), voxel)
    for got, want in zip(mom_t, mom_j):
        np.testing.assert_array_equal(got.numpy().view(np.int32), np.asarray(want).view(np.int32))
    n_j, v_j = _jax_estimate_normals(jnp.asarray(pts), jnp.asarray(mask), voxel)
    n_t, v_t = tp.estimate_normals(t(pts), t(mask), voxel)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    assert np.asarray(v_j).sum() > 1500
    # every row's normal, signs included (jaxlib's eigh on the same bits)
    np.testing.assert_array_equal(n_t.numpy().view(np.int32), np.asarray(n_j).view(np.int32))


#: the JAX package's tiled normals jitted as the LIO runs them (`chunk`, a
#: field of its static config, static)
_jax_estimate_normals_tiled = jax.jit(jp.estimate_normals_tiled, static_argnums=2)


@pytest.mark.parametrize("chunk", [32, 64, 48])
def test_estimate_normals_tiled_matches_jax(chunk):
    """Bit-equal to the jitted JAX function, signs included: at 32 rows a
    chunk's sums are one reduction, at 64 two windows of 32, at 48 two
    windows with XLA's padding; each X^T X an fma chain along the chunk."""
    pts, mask = _ring(1, radius=12.0, shift=(3.0, -2.0, 0.0), cap=8192 + 16)  # a ragged tail
    n_j, v_j = _jax_estimate_normals_tiled(jnp.asarray(pts), jnp.asarray(mask), chunk)
    n_t, v_t = tp.estimate_normals_tiled(t(pts), t(mask), chunk)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    assert np.asarray(v_j).sum() > 1000
    np.testing.assert_array_equal(n_t.numpy().view(np.int32), np.asarray(n_j).view(np.int32))


@pytest.mark.parametrize("shift", [(0.0, 0.0, 0.0), (40.0, 30.0, 0.0), (140.0, -60.0, 2.0)],
                         ids=["origin", "shifted", "far"])
def test_estimate_normals_cells_matches_jax(shift):
    pts, mask = _ring(2, radius=12.0, shift=shift)
    n_j, v_j = jax.jit(lambda p, m: jp.estimate_normals_cells(p, m, 1.8))(
        jnp.asarray(pts), jnp.asarray(mask))
    n_t, v_t = tp.estimate_normals_cells(t(pts), t(mask), 1.8)
    n_64, _ = tp.estimate_normals_cells(t(pts).double(), t(mask), 1.8)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    valid = np.asarray(v_j)
    assert valid.sum() > 5000
    gap = _unsigned_gap(n_t.numpy(), np.asarray(n_j), valid)
    gap_j = _unsigned_gap(n_64.numpy(), np.asarray(n_j), valid)
    gap_t = _unsigned_gap(n_64.numpy(), n_t.numpy(), valid)
    print(f"cells {shift}: port vs jax max gap {gap.max():.3g}; "
          f"vs float64 within 1e-3: jax {np.mean(gap_j < 1e-3):.3f} / {gap_j.mean():.4f}, "
          f"port {np.mean(gap_t < 1e-3):.3f} / {gap_t.mean():.4f}")
    np.testing.assert_array_equal(n_t.numpy().view(np.int32), np.asarray(n_j).view(np.int32))
    assert np.mean(gap_t < 1e-3) > np.mean(gap_j < 1e-3) - 0.05
    assert gap_t.mean() < 2.0 * gap_j.mean() + 0.01


def test_estimate_normals_cells_planarity_gate():
    pts, mask = _ring(3, radius=12.0)
    _, v_all = tp.estimate_normals_cells(t(pts), t(mask), 1.8)
    _, v_j = jax.jit(lambda p, m: jp.estimate_normals_cells(p, m, 1.8, max_planarity=0.25))(
        jnp.asarray(pts), jnp.asarray(mask))
    _, v_t = tp.estimate_normals_cells(t(pts), t(mask), 1.8, max_planarity=0.25)
    # the gate compares two float32 eigenvalues of equal moments: none flips
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    assert v_t.sum() < v_all.sum()


def test_smallest_eigvec3_matches_jax_and_eigh():
    rng = np.random.default_rng(4)
    A = rng.normal(0, 1, (500, 3, 3)).astype(np.float32)
    cov = A @ A.transpose(0, 2, 1) * rng.uniform(0.01, 1, (500, 1, 1)).astype(np.float32)
    cov[0] = np.eye(3)  # isotropic: the arbitrary unit vector (eigenvalues 0/0 in XLA)
    v_j, lo_j, mid_j = (np.asarray(x) for x in jp._smallest_eigvec3(jnp.asarray(cov)))
    v_t, lo_t, mid_t = (x.numpy() for x in tp._smallest_eigvec3(t(cov)))
    np.testing.assert_allclose(lo_t[1:], lo_j[1:], rtol=0, atol=1e-5)
    np.testing.assert_allclose(mid_t[1:], mid_j[1:], rtol=0, atol=1e-5)
    assert (1.0 - np.abs((v_t * v_j).sum(-1))).max() < 1e-4
    np.testing.assert_array_equal(v_t[0], [0.0, 0.0, 1.0])
    w, vecs = np.linalg.eigh(cov.astype(np.float64))
    sep = (w[:, 1] - w[:, 0]) / w[:, 2] > 0.05  # a separated smallest eigenvalue
    assert (1.0 - np.abs((v_t * vecs[:, :, 0]).sum(-1)))[sep].max() < 1e-3


def test_pose_covariance_from_jtj_matches_jax():
    """An ill-conditioned JtJ (a corridor: one direction barely observed)
    with reg = 1e-6, at three translations: bit-equal to the jitted JAX
    function. Its inverse is jaxlib's LAPACK on both sides (getrf + trsm,
    ops/lapack_cpu); torch's CPU inverse had parted by 6e-7 relative on the
    diagonal at condition 1.3e5."""
    rng = np.random.default_rng(5)
    J = rng.normal(0, 1, (400, 6)).astype(np.float32)
    J[:, 1] *= 3e-3
    JtJ = (J.T @ J).astype(np.float32)
    cov_j = jax.jit(jp.pose_covariance_from_jtj)
    for trans in ([3.0, -2.0, 0.5], [40.0, 30.0, 0.0], [140.0, -60.0, 2.0]):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = _rotation(0.3)
        T[:3, 3] = trans
        got = tp.pose_covariance_from_jtj(t(JtJ), t(T)).numpy()
        want = np.asarray(cov_j(jnp.asarray(JtJ), jnp.asarray(T)))
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _rotation(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)


def test_eigh_in_parts_equals_one_call():
    """The card's eigen-solve in parts of `_EIGH_BATCH` matrices (its
    batched solver refuses larger batches) gives the bits of one call over
    the whole batch, in order; the CPU's is jaxlib's over the batch."""
    rng = np.random.default_rng(6)
    A = rng.normal(0, 1, (2 * tp._EIGH_BATCH + 3, 3, 3)).astype(np.float32)
    cov = t(A @ A.transpose(0, 2, 1))
    w, v = tp._eigh_in_parts(torch.linalg.eigh, cov)
    w1, v1 = torch.linalg.eigh(cov)
    assert torch.equal(w, w1) and torch.equal(v, v1)
    # and the CPU's eigen-solve, jaxlib's, on the whole batch
    w_j, v_j = jax.jit(jnp.linalg.eigh)(cov.numpy())
    w, v = tp._eigh(cov)
    np.testing.assert_array_equal(w.numpy().view(np.int32), np.asarray(w_j).view(np.int32))
    np.testing.assert_array_equal(v.numpy().view(np.int32), np.asarray(v_j).view(np.int32))


def _voxel_normals_case():
    pts, mask = (t(a) for a in ground_and_walls(16, (40.0, 30.0, 0.0)))
    return (*tp._voxel_moments(pts, mask, 0.75)[3], *tp.estimate_normals(pts, mask, 0.75))


def _k2_case():
    src, sm, tgt, tm, _, _, T0 = (t(a) for a in p2p_scene(7, n_tgt=6000, M=2048, N=8192))
    cfg = tp.PointToPlaneConfig(tile_src=512, tile_tgt=1024, max_visits=64)
    pairs, tgt_pages = tp._k2_lists(src, sm, tgt, tm, T0, cfg)
    src_pages = make_pages(transform_points(T0, src), sm, T0[:3, 3], 512)
    return pair_nn_plain(src_pages, tgt_pages, *pairs)


def _angle_sweep(lo: float, hi: float) -> torch.Tensor:
    """98 310 seeded float32 values: in [lo, hi], of 1e-8 to 1e6 in
    magnitude, with +-0, subnormals and +-1; no NaN."""
    rng = np.random.default_rng(11)
    special = np.array([0.0, -0.0, 1e-45, -1e-39, 1.0, -1.0], np.float32)
    mags = np.sign(rng.normal(size=1 << 15)) * 10.0 ** rng.uniform(-8, 6, 1 << 15)
    return t(np.concatenate([special, rng.uniform(lo, hi, 1 << 16), mags]).astype(np.float32))


def _acos_case():
    return (xm.acosf(_angle_sweep(-1.0, 1.0).clamp(-1.0, 1.0)),)


def _atan2_case():
    y = _angle_sweep(-np.pi, np.pi)
    return (xm.atan2f(y, y.flip(0)),)


@pytest.mark.parametrize("case", [_voxel_normals_case, _k2_case, _acos_case, _atan2_case],
                         ids=["voxel-normals", "k2", "acos", "atan2"])
def test_plain_versions_bits_equal_at_default_threads(case):
    """The port's CPU tests run torch on one thread (tests/torch_parity.py):
    the voxel normals (moments, normals, valid flags), K2's plain version at
    the LIO's 512 x 1024 tiles, and XLA's acos and atan2 (whose sqrt takes
    numpy's: torch's CPU sqrt, MKL's, rounded one thread's share apart on
    its first call from several threads) give the same bits at torch's
    default thread count."""
    one = case()
    torch.set_num_threads(DEFAULT_THREADS)
    try:
        many = case()
    finally:
        torch.set_num_threads(1)
    for a, b in zip(one, many):
        assert torch.equal(a, b) and (not a.is_floating_point() or torch.equal(
            a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)))
