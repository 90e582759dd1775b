"""The multi-launch point-to-plane GN of the PyTorch port
(`point_to_plane_align`, on the dense sweep and on K2's plain version) and
the dense nearest-neighbour sweep against the JAX package, same NumPy
inputs. The dense sweep's expanded distance cancels, and XLA and torch sum
its K=3 products in another order, so d2 agrees to 1e-5 absolute and the
index wherever the two nearest candidates are not within that; the
registration's T agrees to 1e-4, the correspondence count to 0.5%, rmse to
1e-4, cov_pose to 1e-3 relative on its diagonal."""

import jax.numpy as jnp
import numpy as np
import pytest

from slam_sensor_fusion_tpu.ops import nn as jn
from slam_sensor_fusion_tpu.ops import point_to_plane as jp
from slam_sensor_fusion_tpu_torch.ops import nn as tn
from slam_sensor_fusion_tpu_torch.ops import point_to_plane as tp
from torch_lio_world import p2p_scene
from torch_parity import t


@pytest.mark.parametrize("chunk", [4096, 512])
def test_nearest_neighbor_matches_jax(chunk):
    src, smask, tgt, tmask, *_ = p2p_scene(0)
    center = np.asarray([0.5, -0.3, 0.1], np.float32)
    d2_j, idx_j = jn.nearest_neighbor(*[jnp.asarray(a) for a in (src, smask, tgt, tmask, center)],
                                      chunk=chunk)
    d2_t, idx_t = tn.nearest_neighbor(*[t(a) for a in (src, smask, tgt, tmask, center)], chunk=chunk)
    d2_j, idx_j, d2_t, idx_t = np.asarray(d2_j), np.asarray(idx_j), d2_t.numpy(), idx_t.numpy()
    np.testing.assert_allclose(d2_t, d2_j, rtol=0, atol=1e-5)
    differ = idx_t != idx_j
    assert differ.mean() < 0.01
    # where the index differs the two candidates are equally near
    far = np.linalg.norm(src[differ] - tgt[idx_t[differ]], axis=1) ** 2
    np.testing.assert_allclose(far, d2_j[differ], rtol=0, atol=2e-5)
    assert tmask[idx_t[smask]].all()
    np.testing.assert_array_equal(
        tn.min_dist_to_set(t(src), t(smask), t(tgt), t(tmask), t(center)).numpy(),
        tn.nearest_neighbor(t(src), t(smask), t(tgt), t(tmask), t(center))[0].numpy())
    np.testing.assert_array_equal(tn.gather_neighbors(t(tgt), t(idx_t)).numpy(), tgt[idx_t])


def test_nearest_neighbor_without_targets():
    src, smask, tgt, tmask, *_ = p2p_scene(0)
    d2, idx = tn.nearest_neighbor(t(src), t(smask), t(tgt), t(np.zeros_like(tmask)))
    assert (d2.numpy() > 1e37).all() and (idx.numpy() == 0).all()


def _assert_result(got, want, n_rel=0.005):
    np.testing.assert_allclose(got.transformation.numpy(), np.asarray(want.transformation),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(got.rmse), float(want.rmse), rtol=0, atol=1e-4)
    n = int(want.n_correspondences)
    assert abs(int(got.n_correspondences) - n) <= n_rel * n
    np.testing.assert_allclose(float(got.wr2), float(want.wr2), rtol=2e-3)
    np.testing.assert_allclose(np.diag(got.cov_pose.numpy()), np.diag(np.asarray(want.cov_pose)),
                               rtol=1e-3)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("seed", [0, 1])
def test_point_to_plane_align_matches_jax(seed, backend):
    """The port's backend against the JAX package's dense (`xla`) GN: the
    JAX `pallas` backend needs a TPU or interpret mode and takes the same
    neighbours; the port's runs K2's plain version on a tile-major list."""
    scene = p2p_scene(seed)
    cfg = dict(num_iterations=4, tile_src=256, tile_tgt=512, max_visits=64)
    want = jp.point_to_plane_align(*[jnp.asarray(a) for a in scene],
                                   jp.PointToPlaneConfig(nn_backend="xla", **cfg))
    got = tp.point_to_plane_align(*[t(a) for a in scene],
                                  tp.PointToPlaneConfig(nn_backend=backend, **cfg))
    _assert_result(got, want)
    assert int(got.n_correspondences) > 600
    # it found the 0.1 m / 1 degree offset
    np.testing.assert_allclose(got.transformation.numpy()[:3, 3], [0.08, -0.06, 0.03], atol=0.01)


def test_point_to_plane_align_pallas_interpret_matches_jax():
    """And against the JAX package's own K2 path in interpret mode."""
    scene = p2p_scene(2)
    cfg = dict(num_iterations=3, tile_src=256, tile_tgt=512, max_visits=64)
    want = jp.point_to_plane_align(
        *[jnp.asarray(a) for a in scene],
        jp.PointToPlaneConfig(nn_backend="pallas", pallas_interpret=True, **cfg))
    got = tp.point_to_plane_align(*[t(a) for a in scene],
                                  tp.PointToPlaneConfig(nn_backend="pallas", **cfg))
    _assert_result(got, want)


def test_point_to_plane_align_ragged_capacity_runs_dense():
    """Capacities that are not multiples of the tiles fall back to the
    dense sweep, as in the JAX package."""
    scene = p2p_scene(3, M=1000, N=2000)
    cfg = dict(num_iterations=2, tile_src=256, tile_tgt=512)
    want = jp.point_to_plane_align(*[jnp.asarray(a) for a in scene],
                                   jp.PointToPlaneConfig(nn_backend="xla", **cfg))
    got = tp.point_to_plane_align(*[t(a) for a in scene],
                                  tp.PointToPlaneConfig(nn_backend="pallas", **cfg))
    _assert_result(got, want)
