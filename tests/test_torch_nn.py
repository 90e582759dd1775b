"""K2 (the pair-list gated NN, ops/nn_pallas.pair_nn) of the PyTorch port
against the JAX Pallas kernel in interpret mode.

The port walks the TILE-MAJOR pair list where the JAX kernel walked the
pair-major one; both visit each source tile's targets in the same order,
so d2 agrees to 1e-5 (relative) and idx and the winner coordinates are
EQUAL, exact ties included (first row within a tile, earlier tile across
tiles)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from slam_sensor_fusion_tpu.ops import morton as jmo
from slam_sensor_fusion_tpu.ops.nn_gated import build_visit_lists
from slam_sensor_fusion_tpu.ops.nn_pallas import _build_pair_list, make_pages, pair_nn as j_pair_nn
from slam_sensor_fusion_tpu_torch.ops.nn_pallas import _build_tile_pair_list, pair_nn
from torch_parity import t

TM, TN = 256, 512


def _case(rng, ties: bool, n_src_tiles: int = 4, TM: int = TM):
    """Rescue-sized pages (4 source tiles of 256, 16 target tiles of 512)
    and the visit lists the rescue ICP would build."""
    tgt = rng.uniform(-8, 8, (16 * TN, 3)).astype(np.float32)
    if ties:  # duplicate targets: exact d2 ties within and across tiles
        tgt[1::7] = tgt[0::7][: len(tgt[1::7])]
        tgt[TN * 3 : TN * 4] = tgt[TN * 2 : TN * 3]
    tgt = jmo.sort_points_numpy(tgt)
    src = tgt[rng.choice(len(tgt), n_src_tiles * TM, replace=False)]
    src = src + rng.normal(0, 0.05, src.shape).astype(np.float32)
    if ties:
        src[::5] = tgt[rng.choice(len(tgt), len(src[::5]))]  # zero distances
    src = jmo.sort_points_numpy(src)
    smask = np.ones(len(src), bool)
    smask[-40:] = False
    tmask = np.ones(len(tgt), bool)
    tmask[-100:] = False
    center = jnp.asarray(src[smask].mean(0))
    r2 = (math.sqrt(5.0) + 0.5) ** 2
    visits, counts, _ = build_visit_lists(
        jnp.asarray(src), jnp.asarray(smask), jnp.asarray(tgt), jnp.asarray(tmask), r2, TM, TN, 64
    )
    sp = make_pages(jnp.asarray(src), jnp.asarray(smask), center, TM)
    tp = make_pages(jnp.asarray(tgt), jnp.asarray(tmask), center, TN)
    return sp, tp, visits, counts


@pytest.mark.parametrize(
    "ties, n_src_tiles, tile_src", [(False, 4, 256), (True, 4, 256), (False, 2, 2048)],
    ids=["False", "True", "2x2048"],
)
def test_pair_nn_plain_matches_jax_kernel(rng, ties, n_src_tiles, tile_src):
    """The rescue's tiles, and 2 source tiles of 2048 rows: wider than a
    block of the port's kernel."""
    sp, tp, visits, counts = _case(rng, ties, n_src_tiles, tile_src)
    max_pairs = 4 * 32
    pair_src, pair_tgt, n_pairs = _build_pair_list(visits, counts, max_pairs)
    d2a, idxa, xyza = j_pair_nn(sp, tp, pair_src, pair_tgt, n_pairs, interpret=True)

    lists = _build_tile_pair_list(t(visits), t(counts), max_pairs)
    d2b, idxb, xyzb = pair_nn(t(sp), t(tp), *lists)  # CPU -> the plain version

    np.testing.assert_allclose(d2b.numpy(), np.asarray(d2a), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(idxb.numpy(), np.asarray(idxa))
    np.testing.assert_array_equal(xyzb.numpy(), np.asarray(xyza))
    if ties:
        assert (np.asarray(d2a) == 0).sum() > 50


def test_tile_major_list_visits_pair_major_order(rng):
    """The tile-major list is the pair-major list regrouped: the same
    (source tile, target tile) visits in the same order."""
    _, _, visits, counts = _case(rng, ties=False)
    for max_pairs in (128, 20):  # roomy, and truncating
        pair_src, pair_tgt, n_pairs = map(np.asarray, _build_pair_list(visits, counts, max_pairs))
        start, cnt, flat = (x.numpy() for x in _build_tile_pair_list(t(visits), t(counts), max_pairs))
        major = [(int(s), int(j)) for s, j in zip(pair_src[: int(n_pairs)], pair_tgt[: int(n_pairs)])]
        tile = [(i, int(flat[start[i] + q])) for i in range(len(cnt)) for q in range(cnt[i])]
        assert tile == major


def test_pair_nn_rejects_malformed_inputs(rng):
    """The wrapper checks every input before it dispatches."""
    sp, tp, visits, counts = _case(rng, ties=False)
    start, cnt, flat = _build_tile_pair_list(t(visits), t(counts), 128)
    with pytest.raises(ValueError, match="src_pages"):
        pair_nn(t(sp).transpose(1, 2), t(tp), start, cnt, flat)
    with pytest.raises(ValueError, match="pair_cnt"):
        pair_nn(t(sp), t(tp), start, cnt.long(), flat)
    with pytest.raises(ValueError, match="tgt_pages"):
        pair_nn(t(sp), t(tp).double(), start, cnt, flat)
