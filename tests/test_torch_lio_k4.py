"""K4, K5 and K6 (the whole-GN point-to-plane kernel and its halves,
ops/p2p_fused) of the PyTorch port against the JAX Pallas kernels in
interpret mode. CPU tensors run the port's plain versions
(`_p2p_core_plain`, `_p2p_associate_plain`, `_p2p_gn_corr_plain`), which
follow the kernels' arithmetic in the order XLA compiles the interpreted
kernels for the CPU (its contractions, its reciprocal constants and its
tree reduction of the 29 moments; ops/p2p_fused's scalar tail).

Target pages and boxes are EQUAL; the pair lists are the same integers;
K4's and K6's T, n_correspondences, rmse, wr2 and all 128 stats lanes are
EQUAL bit for bit, in fixed and fresh mode. The association rounds each
operation alone, as the card kernels do (XLA contracts the rotated source
rows and d2; the two part by an ulp of the coordinates, which the card's
K5 must not see against its plain version): K5's d2 to 1e-6 relative and
its matched pages EQUAL on every valid source point. The pose covariance
is taken on the host through a 6x6 inverse, jaxlib's LAPACK on the CPU
(ops/lapack_cpu): EQUAL."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_sensor_fusion_tpu.ops import p2p_fused as jf
from slam_sensor_fusion_tpu.ops.point_to_plane import PointToPlaneConfig as JConfig
from slam_sensor_fusion_tpu_torch.ops import p2p_fused as tf
from slam_sensor_fusion_tpu_torch.ops.point_to_plane import PointToPlaneConfig
from slam_sensor_fusion_tpu_torch.utils.convert import cached_p2p_target_from_numpy
from torch_lio_world import p2p_core_inputs, p2p_scene
from torch_parity import np_tree, t

CENTER = np.asarray([0.5, -0.3, 0.1], np.float32)


def _cfg(**kw):
    base = dict(num_iterations=3, tile_src=256, tile_tgt=512, max_visits=64, nn_backend="fused")
    base.update(kw)
    return PointToPlaneConfig(**base), JConfig(**base)


def _cached(scene, tile_tgt, gate_sub=None):
    _, _, tgt, tmask, nrm, nvalid, _ = scene
    c_j = jf.build_cached_p2p_target(*[jnp.asarray(a) for a in (tgt, tmask, nrm, nvalid, CENTER)],
                                     tile_tgt, gate_sub=gate_sub)
    c_t = tf.build_cached_p2p_target(*[t(a) for a in (tgt, tmask, nrm, nvalid, CENTER)],
                                     tile_tgt, gate_sub=gate_sub)
    return c_t, c_j


@pytest.mark.parametrize("gate_sub", [None, 32])
def test_build_cached_p2p_target_equals_jax(gate_sub):
    c_t, c_j = _cached(p2p_scene(0), 512, gate_sub)
    for name in tf.CachedP2PTarget._fields:
        a, b = getattr(c_t, name), getattr(c_j, name)
        if b is None:
            assert a is None, name
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert c_t.pages.shape == (4, 6, 512) and c_t.pages.is_contiguous()
    # invalid normals are zero vectors, invalid points the sentinel
    assert (c_t.pages[:, 3:].abs().sum(dim=1) == 0).any()
    back = cached_p2p_target_from_numpy(np_tree(c_j), "cpu")
    for a, b in zip(back, c_t):
        assert (a is None and b is None) or torch.equal(a, b)


def _assert_result(got, want):
    np.testing.assert_array_equal(got.transformation.numpy(), np.asarray(want.transformation))
    assert int(got.n_correspondences) == int(want.n_correspondences)
    assert float(got.rmse) == float(want.rmse)
    assert float(got.wr2) == float(want.wr2)
    np.testing.assert_array_equal(got.cov_pose.numpy().view(np.int32),
                                  np.asarray(want.cov_pose).view(np.int32))


@pytest.mark.parametrize("fixed", [False, True], ids=["fresh", "fixed"])
@pytest.mark.parametrize("seed, ties", [(0, False), (1, True)], ids=["plain", "duplicates"])
def test_point_to_plane_align_fused_matches_jax_kernel(seed, ties, fixed):
    """K4 through its host. With `ties` a fifth of the target points have an
    exact duplicate in a later row or tile carrying ANOTHER normal flag, so
    a wrong tie rule changes n_correspondences and the moments."""
    scene = p2p_scene(seed, ties=ties)
    if ties:  # make the duplicate distinguishable: it has no valid normal
        scene[5][:] = scene[5] & ~_is_later_duplicate(scene[2], scene[3])
    cfg_t, cfg_j = _cfg(fixed_correspondences=fixed)
    c_t, c_j = _cached(scene, cfg_t.tile_tgt)
    src, smask, *_, T0 = scene
    want = jf.point_to_plane_align_fused(jnp.asarray(src), jnp.asarray(smask), c_j,
                                         jnp.asarray(T0), cfg_j, interpret=True)
    got = tf.point_to_plane_align_fused(t(src), t(smask), c_t, t(T0), cfg_t)
    _assert_result(got, want)
    assert int(got.n_correspondences) > 400
    np.testing.assert_allclose(got.transformation.numpy()[:3, 3], [0.08, -0.06, 0.03], atol=0.02)


def _is_later_duplicate(tgt, tmask):
    """Rows whose point also stands in an earlier valid row."""
    _, first = np.unique(tgt, axis=0, return_index=True)
    later = np.ones(len(tgt), bool)
    later[first] = False
    return later & tmask


@pytest.mark.parametrize("fixed", [False, True], ids=["fresh", "fixed"])
def test_p2p_core_stats_lanes_match_jax_kernel(fixed):
    """K4's raw outputs on the same pages and pair list: T_out and all 128
    stats lanes [rmse, W, iters, 21 damped JtJ, wr2, 0...]."""
    cfg_t, cfg_j = _cfg(fixed_correspondences=fixed, num_iterations=2)
    core = p2p_core_inputs(p2p_scene(2), cfg_t)
    T_t, st_t = tf._p2p_core(*core, cfg_t)  # CPU tensors -> the plain version
    want = _jax_core(core, cfg_j)
    T_j, st_j = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(T_t.numpy(), T_j)
    st_t = st_t.numpy()
    assert st_t.shape == (1, 128)
    # rmse, W, iterations, the 21 damped JtJ lanes and wr2, bit for bit
    np.testing.assert_array_equal(st_t, st_j)
    np.testing.assert_array_equal(st_t[0, 25:], 0.0)
    # the exported JtJ is the DAMPED one: its smallest diagonal entry
    # exceeds the damping
    assert st_t[0, 3] > cfg_t.damping


def _jax_core(core, cfg_j):
    """The JAX K4 on the port's kernel arguments (pallas_call, interpret)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    import jax

    src_pages, tgt_pages, ps, pc, pt, T0 = [jnp.asarray(x.numpy()) for x in core]
    nSt, _, TM = src_pages.shape
    smem, vmem = pl.BlockSpec(memory_space=pltpu.SMEM), pl.BlockSpec(memory_space=pltpu.VMEM)
    return pl.pallas_call(
        jf._make_p2p_kernel(TM, tgt_pages.shape[2], cfg_j),
        grid=(), in_specs=[smem, smem, smem, vmem, vmem, vmem], out_specs=[vmem, vmem],
        out_shape=[jax.ShapeDtypeStruct((4, 4), jnp.float32),
                   jax.ShapeDtypeStruct((1, 128), jnp.float32)],
        scratch_shapes=[pltpu.VMEM((nSt, 1, TM), jnp.float32),
                        pltpu.VMEM((nSt, 6, TM), jnp.float32)],
        interpret=True,
    )(ps, pc, pt, T0, src_pages, tgt_pages)


@pytest.mark.parametrize("ties", [False, True], ids=["plain", "duplicates"])
def test_associate_p2p_fused_matches_jax_kernel(ties):
    """K5: d2 to 1e-6 relative, matched point + normal pages EQUAL on valid
    source points (the first row of an exact tie within a tile, the earlier
    tile across)."""
    scene = p2p_scene(3, ties=ties)
    cfg_t, cfg_j = _cfg()
    c_t, c_j = _cached(scene, cfg_t.tile_tgt)
    src, smask, *_, T0 = scene
    d2_j, qn_j = jf.associate_p2p_fused(jnp.asarray(src), jnp.asarray(smask), c_j,
                                        jnp.asarray(T0), cfg_j, interpret=True)
    d2_t, qn_t = tf.associate_p2p_fused(t(src), t(smask), c_t, t(T0), cfg_t)
    assert d2_t.shape == (4, 1, 256) and qn_t.shape == (4, 6, 256)
    np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_j), rtol=1e-6)
    # padded source rows sit at the +1e7 sentinel, ~3e14 from every target:
    # there the last bit of d2 picks the winner and XLA's CPU code rounds it
    # otherwise (1 ulp); the gate drops those rows, so they are not compared
    valid = smask.reshape(4, 1, 256)
    np.testing.assert_array_equal(np.where(valid, qn_t.numpy(), 0), np.where(valid, np.asarray(qn_j), 0))
    assert (d2_t.numpy()[~valid] > 1e14).all()


def test_first_row_wins_exact_ties():
    """Two target rows at EXACTLY the same distance from every source point
    (x +- 1/4, dyadic), the + one in the earlier row, with different
    normals: K5 brings back the first row's point AND normal."""
    g = np.stack(np.meshgrid(np.arange(4), np.arange(8), np.arange(8), indexing="ij"), -1)
    src = g.reshape(-1, 3).astype(np.float32)  # 256 points, spacing 1 m
    off = np.asarray([0.25, 0.0, 0.0], np.float32)
    tgt = np.concatenate([src + off, src - off])  # one tile of 512 rows
    nrm = np.concatenate([np.tile([1.0, 0, 0], (256, 1)), np.tile([0, 1.0, 0], (256, 1))]).astype(np.float32)
    ones = np.ones(512, bool)
    cached = tf.build_cached_p2p_target(t(tgt), t(ones), t(nrm), t(ones), torch.zeros(3), 512)
    cfg = PointToPlaneConfig(tile_src=256, tile_tgt=512)
    d2, qn = tf.associate_p2p_fused(t(src), t(ones[:256]), cached, torch.eye(4), cfg)
    np.testing.assert_array_equal(d2.numpy(), 0.0625)
    np.testing.assert_array_equal(qn[0, :3].numpy().T, src + off)
    np.testing.assert_array_equal(qn[0, 3:].numpy().T, nrm[:256])


def test_p2p_gn_from_correspondences_matches_jax_kernel():
    """K6 on the JAX K5's winners, and K6(K5(x)) == K4 with fixed
    correspondences: the single-shard form of the map-sharded registration."""
    scene = p2p_scene(4)
    cfg_t, cfg_j = _cfg(fixed_correspondences=True)
    c_t, c_j = _cached(scene, cfg_t.tile_tgt)
    src, smask, *_, T0 = scene
    d2_j, qn_j = jf.associate_p2p_fused(jnp.asarray(src), jnp.asarray(smask), c_j,
                                        jnp.asarray(T0), cfg_j, interpret=True)
    want = jf.p2p_gn_from_correspondences(jnp.asarray(src), jnp.asarray(smask), d2_j, qn_j,
                                          jnp.asarray(T0), jnp.asarray(CENTER), cfg_j,
                                          interpret=True)
    got = tf.p2p_gn_from_correspondences(t(src), t(smask), t(d2_j), t(qn_j), t(T0), t(CENTER), cfg_t)
    _assert_result(got, want)
    whole = tf.point_to_plane_align_fused(t(src), t(smask), c_t, t(T0), cfg_t)
    halves = tf.p2p_gn_from_correspondences(
        t(src), t(smask), *tf.associate_p2p_fused(t(src), t(smask), c_t, t(T0), cfg_t),
        t(T0), t(CENTER), cfg_t)
    for a, b in zip(whole, halves):
        assert torch.equal(a, b)


def test_fused_starved_frame_is_noop():
    """With the source far outside the gate the kernel returns the prior
    unchanged (the W >= 3 guard) and counts no correspondence."""
    scene = p2p_scene(5)
    src, smask, *_ = scene
    far = np.where(smask[:, None], src + np.float32(50.0), src).astype(np.float32)
    cfg_t, cfg_j = _cfg()
    c_t, c_j = _cached(scene, cfg_t.tile_tgt)
    want = jf.point_to_plane_align_fused(jnp.asarray(far), jnp.asarray(smask), c_j, jnp.eye(4),
                                         cfg_j, interpret=True)
    got = tf.point_to_plane_align_fused(t(far), t(smask), c_t, torch.eye(4), cfg_t)
    np.testing.assert_allclose(got.transformation.numpy(), np.eye(4), atol=1e-6)
    np.testing.assert_allclose(got.transformation.numpy(), np.asarray(want.transformation), atol=1e-6)
    assert int(got.n_correspondences) == int(want.n_correspondences) == 0
    assert float(got.rmse) == float(want.rmse) == 0.0


def test_pair_list_truncates_silently_like_jax():
    """`max_pairs_factor` caps the pair list; what does not fit is dropped
    and not reported, and both packages register on the same truncated
    list."""
    scene = p2p_scene(6)
    cfg_t, cfg_j = _cfg(max_pairs_factor=2, fixed_correspondences=True)
    c_t, c_j = _cached(scene, cfg_t.tile_tgt)
    src, smask, *_, T0 = scene
    core, _, demand = tf.p2p_inputs(t(src), t(smask), c_t, t(T0), cfg_t)
    assert int(demand) > core[4].shape[0] == 8  # more admissible pairs than slots
    assert int(core[3].sum()) == 8
    want = jf.point_to_plane_align_fused(jnp.asarray(src), jnp.asarray(smask), c_j,
                                         jnp.asarray(T0), cfg_j, interpret=True)
    _assert_result(tf.point_to_plane_align_fused(t(src), t(smask), c_t, t(T0), cfg_t), want)


def test_wrappers_reject_malformed_inputs():
    """The wrappers check dtype, shape and layout before they dispatch (a
    kernel reads raw pointers)."""
    cfg, _ = _cfg()
    core = p2p_core_inputs(p2p_scene(0), cfg)
    bad = list(core)
    bad[1] = core[1][:, :3].contiguous()  # 3-row pages
    with pytest.raises(ValueError, match="tgt_pages"):
        tf._p2p_core(*bad, cfg)
    bad = list(core)
    bad[3] = core[3].long()
    with pytest.raises(ValueError, match="pair_cnt"):
        tf._p2p_associate(*bad)
    d2, qn = tf._p2p_associate(*core)
    with pytest.raises(ValueError, match="best_qn"):
        tf._p2p_gn_corr(core[5], core[0], d2, qn.transpose(1, 2).contiguous().transpose(1, 2), cfg)
    with pytest.raises(ValueError, match="best_d2"):
        tf._p2p_gn_corr(core[5], core[0], d2[:, 0], qn, cfg)
