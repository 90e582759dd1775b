"""The PyTorch port's last public helpers against the JAX package's: the
device voxel grid (`ops/cloud.voxel_downsample`), `masked_points`,
`to_numpy`, `rotation`, `translation`, `svd3x3`, the one-call gated NN on
K2 (`ops/nn_pallas.gated_nn_pallas`) and the config classes the package
exports.

Inputs come from a NumPy seed. The port runs on the CPU, where K2 and the
segment sum run their plain versions; JAX's K2 runs in interpret mode.
`voxel_downsample` must give the JAX function's bits, its int32 voxel ids
wrapping as the JAX function's do (at 0.2 m and the default 2048-cell
grid, cells 1024 apart in x share an id and x >= 102.4 m sorts first).
`gated_nn_pallas` gives equal idx and overflow and d2 to 1e-5 relative.
The singular vectors' signs are the backend's, so `svd3x3` is held by its
singular values and by how well U diag(S) Vh rebuilds H."""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slam_sensor_fusion_tpu_torch as tpkg
from slam_sensor_fusion_tpu.ops import cloud as jcl
from slam_sensor_fusion_tpu.ops import geometry as jgeo
from slam_sensor_fusion_tpu.ops import morton as jmo
from slam_sensor_fusion_tpu.ops import nn_pallas as jnp_nn
from slam_sensor_fusion_tpu.utils import config as jc
from slam_sensor_fusion_tpu_torch.ops import cloud as tcl
from slam_sensor_fusion_tpu_torch.ops import geometry as tgeo
from slam_sensor_fusion_tpu_torch.ops import nn_pallas as tnn
from slam_sensor_fusion_tpu_torch.ops.nn_gated import build_visit_lists
from torch_parity import jax_config, t



def _voxel_pair(pts, mask, voxel, out_capacity, origin=None):
    """(JAX centroids, mask), (port centroids, mask) as NumPy arrays."""
    jo = None if origin is None else jnp.asarray(origin)
    to = None if origin is None else torch.from_numpy(np.asarray(origin, np.float32))
    a = jcl.voxel_downsample(jcl.Cloud(jnp.asarray(pts), jnp.asarray(mask)), voxel, out_capacity,
                             origin=jo)
    b = tcl.voxel_downsample(tcl.Cloud(t(pts), t(mask)), voxel, out_capacity, origin=to)
    return (np.asarray(a.points), np.asarray(a.mask)), (b.points.numpy(), b.mask.numpy())


def _wrap_cloud():
    """Points 1024 cells apart in x at 0.2 m (one voxel id under the wrap),
    two in a voxel at x = 120 m (i = 600: a negative id), and a few others,
    then masked rows up to 256; the min corner is (0, 0.05, 0.05)."""
    pts = np.zeros((256, 3), np.float32)
    pts[:7] = [
        [0.05, 0.05, 0.05],
        [204.85, 0.05, 0.05],
        [120.0, 1.1, 0.5],
        [120.1, 1.15, 0.5],
        [3.3, 2.2, 1.1],
        [50.0, 60.0, 7.0],
        [0.0, 30.0, 3.0],
    ]
    return pts, np.arange(256) < 7


def _voxel_case(kind):
    """(points, mask, voxel, out_capacity, origin) of each case: 256 rows
    and 1024 output rows where the case allows (the JAX side compiles each
    new shape)."""
    rng = np.random.default_rng(0)
    if kind == "cloud500":  # tests/test_cloud.py's cloud
        pts = np.zeros((512, 3), np.float32)
        pts[:500] = rng.uniform(-5, 5, size=(500, 3))
        return pts, np.arange(512) < 500, 0.5, 2048, None
    if kind in ("wrap", "wrap_origin"):
        pts, mask = _wrap_cloud()
        origin = np.zeros(3, np.float32) if kind == "wrap_origin" else None
        return pts, mask, 0.2, 1024, origin
    if kind == "small_capacity":  # fewer output rows than voxels
        pts = rng.uniform(-5, 5, size=(256, 3)).astype(np.float32)
        return pts, np.ones(256, bool), 0.5, 40, None
    if kind == "masked_inf":  # masked rows hold inf, -inf and NaN, unpacked
        pts = rng.uniform(-5, 5, size=(256, 3)).astype(np.float32)
        mask = rng.random(256) < 0.7
        pts[~mask] = np.inf
        pts[np.flatnonzero(~mask)[::3]] = -np.inf
        pts[np.flatnonzero(~mask)[1::3], 1] = np.nan
        return pts, mask, 0.5, 1024, None
    if kind == "origin":  # an explicit anchor, points below it clip to cell 0
        pts = rng.uniform(-5, 5, size=(256, 3)).astype(np.float32)
        return pts, np.ones(256, bool), 0.5, 1024, np.array([-4.0, -4.5, -3.0], np.float32)
    if kind == "all_masked":
        pts = rng.uniform(-5, 5, size=(256, 3)).astype(np.float32)
        return pts, np.zeros(256, bool), 0.5, 1024, None
    raise ValueError(kind)


VOXEL_CASES = ["cloud500", "masked_inf", "origin", "wrap", "wrap_origin", "all_masked",
               "small_capacity"]


@pytest.mark.parametrize("kind", VOXEL_CASES)
def test_voxel_downsample_bits_equal_jax(kind):
    pts, mask, voxel, cap, origin = _voxel_case(kind)
    (ja, jm), (ta, tm) = _voxel_pair(pts, mask, voxel, cap, origin)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(ta, ja)
    if kind == "small_capacity":
        assert tm.all()  # every row taken, the rest of the voxels dropped
    if kind == "all_masked":
        assert not tm.any() and (ta == 0).all()
    if kind == "cloud500":  # and the host merge's cells, as sets
        host = tcl.voxel_downsample_numpy(pts[:500], voxel)
        got = ta[tm]
        np.testing.assert_allclose(got[np.lexsort(got.T)], host[np.lexsort(host.T)], atol=1e-4)


@pytest.mark.parametrize("kind", ["wrap", "wrap_origin"])
def test_voxel_downsample_wraps_ids_as_jax(kind):
    """The pinned int32 wrap: x = 0.05 and x = 204.85 (1024 cells apart)
    merge into one voxel with centroid x = 102.45, and the x = 120 m voxel
    (i = 600, a negative id) comes first."""
    pts, mask, voxel, cap, origin = _voxel_case(kind)
    out = tcl.voxel_downsample(tcl.Cloud(t(pts), t(mask)), voxel, cap,
                               origin=None if origin is None else t(origin))
    cent, m = out.points.numpy(), out.mask.numpy()
    assert m.sum() == 5  # 7 points, the wrapped pair and the 120 m pair merged
    assert abs(cent[0, 0] - 120.05) < 1e-4
    merged = cent[m][np.argmin(np.abs(cent[m, 0] - 102.45))]
    np.testing.assert_allclose(merged, [102.45, 0.05, 0.05], atol=1e-4)


def test_masked_points_and_to_numpy_equal_jax():
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(16, 3)).astype(np.float32)
    mask = rng.random(16) < 0.6
    jc_, tc_ = jcl.Cloud(jnp.asarray(pts), jnp.asarray(mask)), tcl.Cloud(t(pts), t(mask))
    np.testing.assert_array_equal(tcl.masked_points(tc_).numpy(), np.asarray(jcl.masked_points(jc_)))
    np.testing.assert_array_equal(tcl.masked_points(tc_, fill=-7.0).numpy(),
                                  np.asarray(jcl.masked_points(jc_, fill=-7.0)))
    got = tcl.to_numpy(tc_)
    assert got.dtype == np.float32 and got.shape == (mask.sum(), 3)
    np.testing.assert_array_equal(got, jcl.to_numpy(jc_))


def test_rotation_translation_equal_jax():
    rng = np.random.default_rng(2)
    T = rng.normal(size=(5, 4, 4)).astype(np.float32)
    np.testing.assert_array_equal(tgeo.rotation(t(T)).numpy(), np.asarray(jgeo.rotation(jnp.asarray(T))))
    np.testing.assert_array_equal(tgeo.translation(t(T)).numpy(),
                                  np.asarray(jgeo.translation(jnp.asarray(T))))
    np.testing.assert_array_equal(tgeo.translation(t(T[0])).numpy(), T[0, :3, 3])


def test_svd3x3_singular_values_and_rebuild():
    rng = np.random.default_rng(3)
    H = rng.normal(size=(16, 3, 3)).astype(np.float32)
    H[3, 2] = H[3, 0] + H[3, 1]  # rank 2
    U, S, Vh = tgeo.svd3x3(t(H))
    _, Sj, _ = jgeo.svd3x3(jnp.asarray(H))
    assert U.shape == Vh.shape == (16, 3, 3) and S.shape == (16, 3)
    np.testing.assert_allclose(S.numpy(), np.asarray(Sj), rtol=1e-6, atol=1e-6)
    rebuilt = (U * S[:, None, :]) @ Vh
    np.testing.assert_allclose(rebuilt.numpy(), H, atol=1e-5)


def _nn_clouds(rng):
    """1024 Morton-sorted source points near a 4096-point target (8 tiles
    of 512), a few rows of each masked."""
    tgt = jmo.sort_points_numpy(rng.uniform(-8, 8, (4096, 3)).astype(np.float32))
    src = tgt[rng.choice(4096, 1024, replace=False)] + rng.normal(0, 0.05, (1024, 3))
    src = jmo.sort_points_numpy(src.astype(np.float32))
    smask = np.ones(1024, bool)
    smask[-40:] = False
    tmask = np.ones(4096, bool)
    tmask[-100:] = False
    return src, smask, tgt, tmask


@pytest.mark.parametrize("truncate", [False, True], ids=["default_max_pairs", "truncating"])
def test_gated_nn_pallas_matches_jax(truncate):
    rng = np.random.default_rng(4)
    src, smask, tgt, tmask = _nn_clouds(rng)
    center = src[smask].mean(0)
    r2 = (math.sqrt(5.0) + 0.5) ** 2
    TM, TN = 256, 512
    max_pairs = None
    if truncate:  # the port's visit lists hold the JAX package's integers
        _, counts, _ = build_visit_lists(t(src), t(smask), t(tgt), t(tmask), r2, TM, TN, 24)
        max_pairs = int(counts.sum()) - 5
    a = jnp_nn.gated_nn_pallas(jnp.asarray(src), jnp.asarray(smask), jnp.asarray(tgt),
                               jnp.asarray(tmask), jnp.asarray(center), r2, tile_src=TM,
                               tile_tgt=TN, max_pairs=max_pairs, interpret=True)
    b = tnn.gated_nn_pallas(t(src), t(smask), t(tgt), t(tmask), t(center), r2, tile_src=TM,
                            tile_tgt=TN, max_pairs=max_pairs)
    assert isinstance(b, tnn.PallasNNResult)
    assert bool(b.overflow) == bool(a.overflow) == truncate
    np.testing.assert_array_equal(b.idx.numpy(), np.asarray(a.idx))
    np.testing.assert_allclose(b.d2.numpy(), np.asarray(a.d2), rtol=1e-5, atol=1e-6)
    assert (b.d2.numpy()[~smask] == 3.0e38).all()


CONFIGS = ["ICPConfig", "BruteForceConfig", "StochasticFilterConfig", "LocalizationConfig",
           "MappingConfig"]


@pytest.mark.parametrize("name", CONFIGS)
def test_package_exports_the_port_configs(name):
    """Each config class imports from the package, is the port's own, and
    its defaults convert to the JAX package's."""
    from slam_sensor_fusion_tpu_torch.utils import config as tc

    cls = getattr(tpkg, name)
    assert cls is getattr(tc, name) and cls is not getattr(jc, name)
    jcls = getattr(jc, name)
    if name == "LocalizationConfig":
        assert jax_config(cls()) == jcls()
    elif name == "MappingConfig":
        assert jcls(**dataclasses.asdict(cls())) == jcls()
    else:  # through the LocalizationConfig field that holds it
        field = {"ICPConfig": "icp", "BruteForceConfig": "brute_force",
                 "StochasticFilterConfig": "filter"}[name]
        port = tpkg.LocalizationConfig(**{field: cls()})
        assert getattr(jax_config(port), field) == jcls()
