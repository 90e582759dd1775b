"""The map-sharded point-to-plane registration of the PyTorch port
(parallel/map_shard: `shard_p2p_target`, `sp_p2p_align`) against the JAX
package's, whose `sp_p2p_align` runs on conftest's 8-device CPU mesh with
its Pallas kernels (K5, K6) in interpret mode; the port runs K5's and K6's
plain versions on the CPU.

The scene is `tests/test_parallel.py`'s sp-p2p size: 3000 Morton-sorted
target points with normals (some invalid), 455 source points, tiles of 128,
4 shards. At each of the three shard boundaries the last point of a shard
is duplicated as the first of the next, the earlier copy with an invalid
normal, and a source point sits on it: the copies tie exactly, and only the
earlier shard's winner leaves the point out of the correspondence count.

Pages and boxes are EQUAL at center 0 and agree to 1e-5 at a nonzero
center (the rebasing rounds in another order, ROADMAP §3); the port runs
on the JAX package's pages (carried across by
`sharded_p2p_target_from_numpy`), and n_correspondences is EQUAL, T agrees
to 1e-4, rmse and wr2 to 1e-4 relative and the covariance's diagonal to
1e-3 relative: the tolerances tests/test_torch_lio_k4.py holds K6 to."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_sensor_fusion_tpu.ops.point_to_plane import PointToPlaneConfig as JConfig
from slam_sensor_fusion_tpu.parallel import map_shard as jms
from slam_sensor_fusion_tpu.parallel.mesh import make_mesh
from slam_sensor_fusion_tpu_torch.ops import p2p_fused as tf
from slam_sensor_fusion_tpu_torch.ops.point_to_plane import PointToPlaneConfig
from slam_sensor_fusion_tpu_torch.parallel import map_shard as tms
from slam_sensor_fusion_tpu_torch.parallel.mesh import make_mesh as t_make_mesh
from slam_sensor_fusion_tpu_torch.utils.convert import sharded_p2p_target_from_numpy
from torch_lio_world import p2p_scene
from torch_parity import np_tree, t

N_SHARDS = 4
N_TGT = 3000
CENTER = np.asarray([0.5, -0.3, 0.1], np.float32)
CFG = dict(tile_src=128, tile_tgt=128, fixed_correspondences=True, max_pairs_factor=32)


def _scene():
    """(src, src_mask, tgt (N_TGT, 3), normals, normals_valid, tie rows of
    the source): p2p_scene's walls, floor and pole with a copy of each
    shard's last point opening the next shard."""
    src, smask, tgt, _, nrm, nvalid, _ = p2p_scene(8, n_tgt=N_TGT, M=512, N=3072)
    tgt, nrm, nvalid = tgt[:N_TGT].copy(), nrm[:N_TGT].copy(), nvalid[:N_TGT].copy()
    per = -(-N_TGT // N_SHARDS)
    ties = []
    for b in range(per, N_TGT, per):
        tgt[b], nrm[b] = tgt[b - 1], nrm[b - 1]
        nvalid[b - 1], nvalid[b] = False, True
        k = int(smask.sum())
        src[k], smask[k] = tgt[b - 1], True  # on both copies (the prior is the identity)
        ties.append(k)
    return src, smask, tgt, nrm, nvalid, np.asarray(ties)


@pytest.fixture(scope="module")
def world():
    """The scene, the JAX package's sharded target and its sp_p2p_align."""
    src, smask, tgt, nrm, nvalid, ties = _scene()
    target = jms.shard_p2p_target(tgt, nrm, nvalid, N_SHARDS, CFG["tile_tgt"], CENTER)
    want = jms.sp_p2p_align(jnp.asarray(src), jnp.asarray(smask), target, jnp.eye(4),
                            JConfig(**CFG), make_mesh(N_SHARDS, axis="sp"), interpret=True)
    return (src, smask, tgt, nrm, nvalid, ties), target, want


@pytest.mark.parametrize("center", ["zero", "offset"])
@pytest.mark.parametrize("n_shards", [1, N_SHARDS])
def test_shard_p2p_target_equals_jax(world, n_shards, center):
    (_, _, tgt, nrm, nvalid, _), _, _ = world
    ctr = CENTER if center == "offset" else np.zeros(3, np.float32)
    want = jms.shard_p2p_target(tgt, nrm, nvalid, n_shards, CFG["tile_tgt"], ctr)
    got = tms.shard_p2p_target(tgt, nrm, nvalid, n_shards, CFG["tile_tgt"], ctr, device="cpu")
    # 3000 points: one shard of 24 tiles of 128, or four of 750 points in 6 tiles
    assert got.n_shards == n_shards and got.pages.shape == (24, 6, 128)
    atol = 0 if center == "zero" else 1e-5
    for name in ("pages", "lo", "hi", "center"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=0, atol=atol, err_msg=name)
    np.testing.assert_array_equal(got.lo.numpy(), np.asarray(want.lo))  # boxes: original frame
    back = sharded_p2p_target_from_numpy(np_tree(want), "cpu")
    assert back.n_shards == n_shards
    for name in ("pages", "lo", "hi", "center"):
        np.testing.assert_array_equal(getattr(back, name).numpy(), np.asarray(getattr(want, name)))


def _port(world):
    (src, smask, *_), target, _ = world
    return t(src), t(smask), sharded_p2p_target_from_numpy(np_tree(target), "cpu")


def test_sp_p2p_align_matches_jax(world):
    _, _, want = world
    src, smask, target = _port(world)
    got = tms.sp_p2p_align(src, smask, target, torch.eye(4), PointToPlaneConfig(**CFG))
    np.testing.assert_allclose(got.transformation.numpy(), np.asarray(want.transformation),
                               rtol=0, atol=1e-4)
    assert int(got.n_correspondences) == int(want.n_correspondences) > 300
    np.testing.assert_allclose(float(got.rmse), float(want.rmse), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(float(got.wr2), float(want.wr2), rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(np.diag(got.cov_pose.numpy()), np.diag(np.asarray(want.cov_pose)),
                               rtol=1e-3)
    # the registration recovers the scene's offset
    np.testing.assert_allclose(got.transformation.numpy()[:3, 3], [0.08, -0.06, 0.03], atol=0.02)


def test_cross_shard_tie_keeps_the_earlier_shard(world):
    """Each tie point's winner is the earlier shard's copy (invalid normal:
    a zero vector), and the JAX package's count agrees with that rule, not
    with the later shard winning."""
    (*_, ties), _, want = world
    src, smask, target = _port(world)
    cfg = PointToPlaneConfig(**CFG)
    d2s, qns = zip(*[tf.associate_p2p_fused(src, smask, target.shard(s), torch.eye(4), cfg)
                     for s in range(N_SHARDS)])
    mesh = t_make_mesh(N_SHARDS, "sp", "cpu", single_process=True)
    d2, qn = mesh.combine_winners(list(d2s), list(qns))
    TM = cfg.tile_src
    for s, k in enumerate(ties):
        i, r = divmod(int(k), TM)
        assert float(d2[i, 0, r]) == 0.0
        # both shards s and s + 1 matched the point at distance 0
        assert float(d2s[s][i, 0, r]) == float(d2s[s + 1][i, 0, r]) == 0.0
        assert torch.equal(qn[i, :, r], qns[s][i, :, r])
        assert float(qn[i, 3:, r].abs().sum()) == 0.0  # the earlier copy's invalid normal
        assert float(qns[s + 1][i, 3:, r].abs().sum()) > 0.5
    # the later shard winning instead would count every tie point
    d2_r, qn_r = mesh.combine_winners(list(d2s[::-1]), list(qns[::-1]))
    first = tf.p2p_gn_from_correspondences(src, smask, d2, qn, torch.eye(4), target.center, cfg)
    later = tf.p2p_gn_from_correspondences(src, smask, d2_r, qn_r, torch.eye(4), target.center,
                                           cfg)
    assert int(later.n_correspondences) == int(first.n_correspondences) + len(ties)
    assert int(want.n_correspondences) == int(first.n_correspondences)


def test_one_shard_equals_associate_then_gn(world):
    """At one shard the combine is the identity: sp_p2p_align equals K5 then
    K6 on the same pages, bit for bit."""
    (src, smask, tgt, nrm, nvalid, _), _, _ = world
    target = tms.shard_p2p_target(tgt, nrm, nvalid, 1, CFG["tile_tgt"], CENTER, device="cpu")
    cfg = PointToPlaneConfig(**CFG)
    got = tms.sp_p2p_align(t(src), t(smask), target, torch.eye(4), cfg)
    d2, qn = tf.associate_p2p_fused(t(src), t(smask), target.shard(0), torch.eye(4), cfg)
    want = tf.p2p_gn_from_correspondences(t(src), t(smask), d2, qn, torch.eye(4), target.center,
                                          cfg)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
