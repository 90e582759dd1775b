"""K3 (the whole-ICP kernel, ops/icp_fused) of the PyTorch port against the
JAX Pallas kernel in interpret mode: `_fused_core_plain` vs `_fused_core`,
fresh and lazy; `icp_align_fused` with and without a cached target;
`icp_align_fused_paged` lazy; the first-row tie rule.

Both get the same inputs, made from a NumPy seed. Poses agree to 3e-4 and
the mean error to 1e-3 (tests/test_superblock_kernel.py's bounds: the
moment sums round in another order); iterations, correspondence counts and
the converged flags are EQUAL."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_sensor_fusion_tpu.ops import icp_fused as jif
from slam_sensor_fusion_tpu.utils.config import ICPConfig as JICPConfig
from slam_sensor_fusion_tpu_torch.ops import icp_fused as tif
from slam_sensor_fusion_tpu_torch.ops.nn_pallas import make_pages
from slam_sensor_fusion_tpu_torch.utils.config import ICPConfig
from torch_parity import t
from torch_world import K3_CONFIG, k3_inputs, k3_scene

CFG = K3_CONFIG


def _jcfg(cfg: ICPConfig) -> JICPConfig:
    return JICPConfig(**dataclasses.asdict(cfg))


def _assert_core_equal(got, want):
    T_p, st_p = (x.numpy() for x in got)
    T_j, st_j = (np.asarray(x) for x in want)
    np.testing.assert_allclose(T_p, T_j, rtol=0, atol=3e-4)
    np.testing.assert_array_equal(st_p[0, 1:3], st_j[0, 1:3])  # iterations, n_corr
    np.testing.assert_allclose(st_p[0, 0], st_j[0, 0], rtol=0, atol=1e-3)
    np.testing.assert_allclose(st_p[0, 3], st_j[0, 3], rtol=1e-3)  # det_min
    np.testing.assert_array_equal(st_p[0, 4:], 0.0)


def _assert_result_equal(got, want):
    np.testing.assert_allclose(got.transformation.numpy(), np.asarray(want.transformation),
                               rtol=0, atol=3e-4)
    np.testing.assert_allclose(float(got.error), float(want.error), rtol=0, atol=1e-3)
    for name in ("iterations", "n_correspondences", "has_converged", "pair_overflow"):
        assert int(getattr(got, name)) == int(getattr(want, name)), name


@pytest.mark.parametrize("lazy", [False, True], ids=["fresh", "lazy"])
@pytest.mark.parametrize("seed, tile_src", [(0, 256), (1, 256), (0, 2048)],
                         ids=["0", "1", "0-2048"])
def test_fused_core_plain_matches_jax_kernel(seed, tile_src, lazy):
    """4 source tiles of 256, and one tile of 2048 rows: wider than a block
    of the port's kernel, as the JAX package's stress configuration's
    4096."""
    cfg = dataclasses.replace(CFG, tile_src=tile_src)
    M = max(1024, tile_src)
    inputs = k3_inputs(cfg, k3_scene(seed, n_src=M - 24, M=M))
    got = tif._fused_core(*inputs, cfg, lazy)  # CPU tensors -> the plain version
    want = jif._fused_core(*[jnp.asarray(x.numpy()) for x in inputs], _jcfg(cfg),
                           interpret=True, lazy=lazy)
    _assert_core_equal(got, want)
    assert got[1][0, 1] >= 2  # several steps: the comparison is not vacuous
    assert got[1][0, 2] > 800


@pytest.mark.parametrize("cached", [False, True], ids=["targets", "cached_target"])
def test_icp_align_fused_matches_jax(cached):
    src, smask, tgt, tmask, T0 = k3_scene(2, n_src=480, M=512, N=2048)
    ct_p = ct_j = None
    if cached:  # a crop centre away from the prior, as after a re-crop
        center = np.asarray([0.5, -0.3, 0.1], np.float32)
        ct_p = tif.build_cached_target(t(tgt), t(tmask), t(center), CFG.tile_tgt)
        ct_j = jif.build_cached_target(jnp.asarray(tgt), jnp.asarray(tmask),
                                       jnp.asarray(center), CFG.tile_tgt)
    got = tif.icp_align_fused(t(src), t(smask), t(tgt), t(tmask), t(T0), CFG, cached_target=ct_p)
    want = jif.icp_align_fused(jnp.asarray(src), jnp.asarray(smask), jnp.asarray(tgt),
                               jnp.asarray(tmask), jnp.asarray(T0), _jcfg(CFG),
                               interpret=True, cached_target=ct_j)
    _assert_result_equal(got, want)
    np.testing.assert_allclose(float(got.det_min), float(want.det_min), rtol=1e-3)
    assert int(got.iterations) >= 2


def test_icp_align_fused_paged_lazy_matches_jax():
    scene = k3_scene(3, n_src=480, M=512, N=2048)
    src, smask, tgt, tmask, T0 = scene
    inputs = k3_inputs(CFG, scene)
    src_pages, _, start, cnt, lst, _ = inputs
    ct_p = tif.build_cached_target(t(tgt), t(tmask), t(T0)[:3, 3], CFG.tile_tgt)
    ct_j = jif.build_cached_target(jnp.asarray(tgt), jnp.asarray(tmask),
                                   jnp.asarray(T0)[:3, 3], CFG.tile_tgt)
    ovf = torch.tensor(False)
    got = tif.icp_align_fused_paged(src_pages, start, cnt, lst, t(T0), ct_p, CFG,
                                    pair_overflow=ovf, lazy=True)
    want = jif.icp_align_fused_paged(
        *[jnp.asarray(x.numpy()) for x in (src_pages, start, cnt, lst)], jnp.asarray(T0),
        ct_j, _jcfg(CFG), interpret=True, pair_overflow=jnp.bool_(False), lazy=True,
    )
    _assert_result_equal(got, want)
    assert int(got.iterations) >= 2


def test_first_row_wins_exact_ties():
    """Every source point has two target points at EXACTLY the same
    distance (x +- 1/4, dyadic coordinates, so no rounding), the + one in
    the earlier row of the same tile: K3 takes the first row (K1 would
    average the two to the source point itself). Held against the JAX
    kernel over a whole ICP as well."""
    g = np.stack(np.meshgrid(np.arange(4), np.arange(8), np.arange(8), indexing="ij"), -1)
    src = g.reshape(-1, 3).astype(np.float32)  # 256 points, spacing 1 m
    off = np.asarray([0.25, 0.0, 0.0], np.float32)
    tgt = np.concatenate([src + off, src - off])  # one tile of 512 rows
    ones = np.ones(256, bool)
    pages = make_pages(t(src), t(ones), torch.zeros(3), 256)
    tpages = make_pages(t(tgt), t(np.ones(512, bool)), torch.zeros(3), 512)
    start, cnt = [0], [1]
    lst = torch.zeros(16, dtype=torch.int32)
    d2, xyz = tif._associate_first(pages, torch.eye(3), torch.zeros(3), start, cnt, lst, tpages)
    np.testing.assert_array_equal(d2.numpy(), 0.0625)
    np.testing.assert_array_equal(xyz[0].numpy().T, src + off)

    inputs = (pages, tpages, torch.zeros(1, dtype=torch.int32), torch.ones(1, dtype=torch.int32),
              lst, torch.eye(4))
    cfg = dataclasses.replace(CFG, tile_src=256, acceptable_mean_error=1e-3)
    for lazy in (False, True):
        got = tif._fused_core(*inputs, cfg, lazy)
        want = jif._fused_core(*[jnp.asarray(x.numpy()) for x in inputs], _jcfg(cfg),
                               interpret=True, lazy=lazy)
        _assert_core_equal(got, want)
        # the first iteration moved the source onto the + copies
        np.testing.assert_allclose(got[0][:3, 3].numpy(), off, atol=1e-6)


def test_fused_core_rejects_malformed_inputs():
    """The wrapper checks dtype, shape and layout before it dispatches (a
    kernel reads raw pointers)."""
    inputs = list(k3_inputs(CFG, k3_scene(0, n_src=480, M=512, N=2048)))
    bad = list(inputs)
    bad[0] = inputs[0].transpose(1, 2).contiguous().transpose(1, 2)  # non-contiguous
    with pytest.raises(ValueError, match="src_pages"):
        tif._fused_core(*bad, CFG)
    bad = list(inputs)
    bad[2] = inputs[2].long()
    with pytest.raises(ValueError, match="pair_start"):
        tif._fused_core(*bad, CFG)
    bad = list(inputs)
    bad[5] = inputs[5][:3]
    with pytest.raises(ValueError, match="T0_rebased"):
        tif._fused_core(*bad, CFG)
    with pytest.raises(ValueError, match="not multiples of the tiles"):
        tif.fused_inputs(torch.zeros(300, 3), torch.ones(300, dtype=torch.bool),
                            torch.zeros(512, 3), torch.ones(512, dtype=torch.bool),
                            torch.eye(4), CFG)
