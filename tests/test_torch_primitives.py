"""Primitives of the PyTorch port against the JAX package: geometry, cloud
ops, Morton tile boxes, tile culling and pair lists, and the stochastic
filter (also against tests/oracles.py).

Masks, point orders and every integer (visits, counts, pair lists,
overflow) must be EQUAL; float geometry agrees to 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracles import StochasticFilterOracle
from slam_sensor_fusion_tpu.ops import cloud as jcl
from slam_sensor_fusion_tpu.ops import geometry as jgeo
from slam_sensor_fusion_tpu.ops import morton as jmo
from slam_sensor_fusion_tpu.ops import nn_gated as jng
from slam_sensor_fusion_tpu.ops import stochastic_filter as jsf
from slam_sensor_fusion_tpu.ops.nn_pallas import _build_tile_pair_list as j_build_tile_pair_list
from slam_sensor_fusion_tpu.utils.config import StochasticFilterConfig
from slam_sensor_fusion_tpu_torch.ops import cloud as tcl
from slam_sensor_fusion_tpu_torch.ops import geometry as tgeo
from slam_sensor_fusion_tpu_torch.ops import morton as tmo
from slam_sensor_fusion_tpu_torch.ops import nn_gated as tng
from slam_sensor_fusion_tpu_torch.ops import stochastic_filter as tsf
from slam_sensor_fusion_tpu_torch.ops.nn_pallas import _build_tile_pair_list as t_build_tile_pair_list
from slam_sensor_fusion_tpu_torch.utils.config import StochasticFilterConfig as TStochasticFilterConfig
from torch_parity import t


def _assert_cloud_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a.points), b.points.numpy())
    np.testing.assert_array_equal(np.asarray(a.mask), b.mask.numpy())


def _random_cloud(rng, n=1024, p_valid=0.7, duplicates=True):
    pts = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    if duplicates:  # exact ties for the distance sort
        pts[n // 2 : n // 2 + 64] = pts[:64]
    mask = rng.uniform(size=n) < p_valid
    return pts, mask


def _poses(rng, n):
    out = np.zeros((n, 4, 4), np.float32)
    for i in range(n):
        yaw = rng.uniform(-np.pi, np.pi)
        c, s = np.cos(yaw), np.sin(yaw)
        out[i, :3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        out[i, :3, 3] = rng.normal(0, 5, 3)
        out[i, 3, 3] = 1
    return out


def test_geometry_matches(rng):
    T = _poses(rng, 5)
    pts = rng.normal(0, 10, (5, 100, 3)).astype(np.float32)
    np.testing.assert_allclose(tgeo.inv_T(t(T)).numpy(), np.asarray(jgeo.inv_T(jnp.asarray(T))), atol=1e-6)
    np.testing.assert_allclose(
        tgeo.transform_points(t(T), t(pts)).numpy(),
        np.asarray(jgeo.transform_points(jnp.asarray(T), jnp.asarray(pts))), atol=1e-5,
    )
    yaw = rng.uniform(-3, 3, 7).astype(np.float32)
    np.testing.assert_allclose(tgeo.rot_z(t(yaw)).numpy(), np.asarray(jgeo.rot_z(jnp.asarray(yaw))), atol=1e-6)
    R, tr = T[:, :3, :3], T[:, :3, 3]
    np.testing.assert_array_equal(tgeo.make_T(t(R), t(tr)).numpy(), np.asarray(jgeo.make_T(R, tr)))


@pytest.mark.parametrize("packed", [False, True])
def test_cloud_ops_equal(rng, packed):
    pts, mask = _random_cloud(rng)
    if packed:
        mask = np.arange(len(mask)) < 700
    jc, tc = jcl.Cloud(jnp.asarray(pts), jnp.asarray(mask)), tcl.Cloud(t(pts), t(mask))
    center = np.array([1.5, -2.0, 0.5], np.float32)
    _assert_cloud_equal(jcl.uniform_subsample(jc, 3), tcl.uniform_subsample(tc, 3))
    tiny_j = jcl.Cloud(jc.points, jnp.asarray(np.arange(1024) < 2))
    tiny_t = tcl.Cloud(tc.points, t(np.arange(1024) < 2))
    _assert_cloud_equal(jcl.uniform_subsample(tiny_j, 3), tcl.uniform_subsample(tiny_t, 3))
    _assert_cloud_equal(
        jcl.crop_radius(jc, jnp.asarray(center), 10.0), tcl.crop_radius(tc, t(center), 10.0)
    )
    _assert_cloud_equal(jcl.remove_floor(jc), tcl.remove_floor(tc))
    for cap in (512, 1024, 2048):
        _assert_cloud_equal(jcl.compact(jc, cap), tcl.compact(tc, cap))
        _assert_cloud_equal(
            jcl.compact_by_distance(jc, jnp.asarray(center), cap),
            tcl.compact_by_distance(tc, t(center), cap),
        )
    for cap in (256, 1024, 2048):  # below, at and above the valid count
        _assert_cloud_equal(jcl.sample_to_capacity(jc, cap), tcl.sample_to_capacity(tc, cap))
    assert int(jc.count()) == int(tc.count())


def test_morton_sort_and_tile_boxes(rng):
    pts, mask = _random_cloud(rng, n=2048)
    np.testing.assert_array_equal(tmo.sort_points_numpy(pts), jmo.sort_points_numpy(pts))
    mask[512:1024] = False  # an empty tile -> inverted box
    a = jmo.tile_bboxes(jnp.asarray(pts), jnp.asarray(mask), 256)
    b = tmo.tile_bboxes(t(pts), t(mask), 256)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    lo_b, hi_b, _ = tmo.tile_bboxes(t(pts[::-1].copy()), t(mask), 128)
    d2a = jmo.bbox_pair_dist2(a[0], a[1], jnp.asarray(lo_b.numpy()), jnp.asarray(hi_b.numpy()))
    d2b = tmo.bbox_pair_dist2(b[0], b[1], lo_b, hi_b)
    np.testing.assert_allclose(d2b.numpy(), np.asarray(d2a), rtol=0, atol=1e-6)
    assert np.isinf(d2b.numpy()[2:4]).all()


def _tile_d2(rng, nSt, nTt):
    """A tile-pair distance matrix with the features that decide visit
    order: many exact 0 ties (overlapping boxes), infs (empty tiles)."""
    d2 = rng.uniform(0, 4, (nSt, nTt)).astype(np.float32)
    d2[rng.uniform(size=d2.shape) < 0.3] = 0.0
    d2[:, 5] = np.inf
    return d2


@pytest.mark.parametrize("max_visits,max_pairs", [(64, 512), (6, 512), (64, 20)])
def test_pair_lists_equal(rng, max_visits, max_pairs):
    nSt, nTt = 8, 32
    d2 = _tile_d2(rng, nSt, nTt)
    cnt = np.full(nSt, 100, np.int32)
    cnt[3] = 0
    a = jng.pair_tiles_from_d2(jnp.asarray(d2), jnp.asarray(cnt), 2.0, max_visits)
    b = tng.pair_tiles_from_d2(t(d2), t(cnt), 2.0, max_visits)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    la = j_build_tile_pair_list(a[0], a[1], max_pairs)
    lb = t_build_tile_pair_list(b[0], b[1], max_pairs)
    for x, y in zip(la, lb):
        assert y.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    assert int(jng.pair_demand_from_d2(jnp.asarray(d2), jnp.asarray(cnt), 2.0)) == int(
        tng.pair_demand_from_d2(t(d2), t(cnt), 2.0)
    )


def test_batched_prologue_equals_vmap(rng):
    """The port batches the K frames of a superblock where JAX vmaps."""
    import jax

    K, nSt, nTt = 4, 8, 32
    d2 = np.stack([_tile_d2(rng, nSt, nTt) for _ in range(K)])
    cnt = rng.integers(0, 3, (K, nSt)).astype(np.int32)
    r2 = np.array([1.0, 2.0, 0.5, 3.0], np.float32)
    a = jax.vmap(jng.pair_tiles_from_d2, in_axes=(0, 0, 0, None))(
        jnp.asarray(d2), jnp.asarray(cnt), jnp.asarray(r2), 16
    )
    b = tng.pair_tiles_from_d2(t(d2), t(cnt), t(r2), 16)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    la = jax.vmap(lambda v, c: j_build_tile_pair_list(v, c, 40))(a[0], a[1])
    lb = t_build_tile_pair_list(b[0], b[1], 40)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    da = jax.vmap(jng.pair_demand_from_d2)(jnp.asarray(d2), jnp.asarray(cnt), jnp.asarray(r2))
    np.testing.assert_array_equal(np.asarray(da), tng.pair_demand_from_d2(t(d2), t(cnt), t(r2)).numpy())
    # fine sub-box gating
    lo = rng.uniform(-5, 5, (nSt * 4, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 2, lo.shape).astype(np.float32)
    lot = rng.uniform(-5, 5, (nTt * 2, 3)).astype(np.float32)
    hit = lot + rng.uniform(0, 2, lot.shape).astype(np.float32)
    sa = jng.subtile_pair_dist2(*map(jnp.asarray, (lo, hi, lot, hit)), nSt, nTt)
    sb = tng.subtile_pair_dist2(t(lo), t(hi), t(lot), t(hit), nSt, nTt)
    np.testing.assert_allclose(sb.numpy(), np.asarray(sa), rtol=0, atol=1e-6)


def test_stochastic_filter_matches_jax_and_oracle(rng):
    cfg = StochasticFilterConfig()
    tcfg = TStochasticFilterConfig()
    js, ts = jsf.init_state(cfg), tsf.init_state(tcfg, device="cpu")
    oracle = StochasticFilterOracle()
    poses = _poses(rng, 12)
    # small steps along a track, with one jump the gate must catch
    track = np.cumsum(rng.normal(0, 0.1, (12, 3)), axis=0).astype(np.float32)
    poses[:, :3, 3] = track
    poses[9, :3, 3] += 3.0
    prev = np.eye(4, dtype=np.float32)
    gated = 0
    for p in poses:
        js = jsf.add_pose(js, jnp.asarray(p), cfg)
        ts = tsf.add_pose(ts, t(p), tcfg)
        oracle.add(p.astype(np.float64))
        np.testing.assert_allclose(ts.transitions.numpy(), np.asarray(js.transitions), atol=1e-5)
        assert int(ts.count) == int(js.count)
        za = float(jsf.pose_z_score(js, jnp.asarray(prev), jnp.asarray(p), cfg))
        zb = float(tsf.pose_z_score(ts, t(prev), t(p), tcfg))
        zo = oracle.z_score(prev.astype(np.float64), p.astype(np.float64))
        np.testing.assert_allclose(zb, za, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(zb, zo, rtol=1e-4, atol=1e-4)
        ga = np.asarray(jsf.apply_gate(js, jnp.asarray(prev), jnp.asarray(p), cfg))
        gb = tsf.apply_gate(ts, t(prev), t(p), tcfg).numpy()
        go = oracle.apply(prev.astype(np.float64), p.astype(np.float64))
        np.testing.assert_allclose(gb, ga, atol=1e-5)
        np.testing.assert_allclose(gb, go, atol=1e-4)
        gated += int(zb > cfg.z_score_threshold)
        prev = p
    assert gated >= 1
