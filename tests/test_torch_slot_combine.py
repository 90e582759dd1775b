"""The decomposition K2, K5 and the grid kernels' association rounds rely on,
held on the CPU: each (source tile, pair slot) item's first-row minimum
over its one target tile, then each source row's slots combined in slot
order under a strict `<` from kBig, equals the running walk over the
tile's whole pair list. The plain versions are that walk: K2's
`pair_nn_plain` (expanded-form distance), K3/K4's `_associate_first`
(direct-difference distance, on 3- and 6-row pages) and K5's
`_p2p_associate_plain` (6-row pages under a prior). The inputs are full
of exact ties (duplicated target rows within and across tiles, source
points on target points, coordinates on a 0.25 grid), sentinel rows on
both sides, a target tile of sentinels only and a source tile with no
admitted pair; the comparison is exact."""

import numpy as np
import pytest
import torch

from slam_sensor_fusion_tpu_torch.ops.icp_fused import _associate_first
from slam_sensor_fusion_tpu_torch.ops.nn_pallas import pair_nn_plain
from slam_sensor_fusion_tpu_torch.ops.p2p_fused import _p2p_associate_plain

BIG = 3.0e38
FAR = 1.0e7
TM, TN = 64, 48
#: (start, count) a source tile and the flat target list: tile 1 has no pair
PAIR_START, PAIR_CNT = [0, 3, 3], [3, 0, 5]
PAIR_TGT = [2, 0, 5, 1, 3, 4, 5, 2]


def _fma_dot3(ax, ay, az, bx, by, bz):
    """fma(az, bz, fma(ay, by, ax * bx)), each fma exact in float64 and
    rounded once to float32."""
    p = ax * bx
    p = (ay.double() * by.double() + p.double()).float()
    return (az.double() * bz.double() + p.double()).float()


def _expanded_d2(t, s):
    """K2's (|t|^2 - 2 t.s) + |s|^2; t (3, TN), s (3, TM) -> (TN, TM)."""
    tx, ty, tz = t[0, :, None], t[1, :, None], t[2, :, None]
    sx, sy, sz = s[0], s[1], s[2]
    return (_fma_dot3(tx, ty, tz, tx, ty, tz) - 2.0 * _fma_dot3(tx, ty, tz, sx, sy, sz)) + (
        _fma_dot3(sx, sy, sz, sx, sy, sz))


def _direct_d2(t, s):
    """K3/K4's (t - s)^2 summed x, y, z; t (rows, TN), s (3, TM)."""
    dx = t[0, :, None] - s[0]
    dy = t[1, :, None] - s[1]
    dz = t[2, :, None] - s[2]
    return dx * dx + dy * dy + dz * dz


def _slot_first_min(d2):
    """One item: the tile's minimum a source row under a strict `<` from
    kBig, and its FIRST row (-1 where no row beats kBig)."""
    best = torch.full((d2.shape[1],), BIG, dtype=torch.float32)
    row = torch.full((d2.shape[1],), -1, dtype=torch.int64)
    for c in range(d2.shape[0]):
        better = d2[c] < best
        best = torch.where(better, d2[c], best)
        row = torch.where(better, torch.full_like(row, c), row)
    return best, row


def _slot_combine(src, tgt, dist):
    """Per-slot first-row minima combined in slot order from kBig: best d2
    (nSt, TM), the winning slot and the winner's row (-1 for none)."""
    nSt = src.shape[0]
    best = torch.full((nSt, TM), BIG, dtype=torch.float32)
    slot = torch.full((nSt, TM), -1, dtype=torch.int64)
    row = torch.full((nSt, TM), -1, dtype=torch.int64)
    for i in range(nSt):
        for s in range(PAIR_START[i], PAIR_START[i] + PAIR_CNT[i]):
            m, r = _slot_first_min(dist(tgt[PAIR_TGT[s]], src[i]))
            better = m < best[i]
            best[i] = torch.where(better, m, best[i])
            slot[i] = torch.where(better, torch.full_like(slot[i], s), slot[i])
            row[i] = torch.where(better, r, row[i])
    return best, slot, row


def _winners(tgt, slot, row):
    """The winning rows' page values (nSt, rows, TM), zeros where no slot won."""
    won = slot >= 0
    j = torch.tensor(PAIR_TGT)[slot.clamp(min=0)]
    win = tgt[j, :, row.clamp(min=0)].permute(0, 2, 1)
    return torch.where(won[:, None], win, torch.zeros_like(win)), j


def _scene(seed, rows):
    """Source pages (3, 3, TM) and target pages (6, rows, TN)."""
    rng = np.random.default_rng(seed)
    tgt = np.round(rng.uniform(-2, 2, (6, TN, 3)) * 4) / 4
    tgt[:, 1::2] = tgt[:, 0::2]  # duplicated rows within a tile
    tgt[3] = tgt[1]  # and a tile duplicated across tiles
    tgt[0, ::5] = FAR  # sentinel rows
    tgt[4, 3::7] = -FAR
    tgt[5] = FAR  # a tile of sentinels only
    src = np.round(rng.uniform(-2, 2, (3, TM, 3)) * 4) / 4
    flat = tgt[:5].reshape(-1, 3)
    src[:, ::3] = flat[rng.choice(len(flat), (3, len(range(0, TM, 3))))]  # on target points
    src[:, 5::9] = FAR
    pages = np.zeros((6, rows, TN), np.float32)
    pages[:, :3] = tgt.transpose(0, 2, 1)
    if rows == 6:  # a normal for every row, distinct, so the winner's row shows
        pages[:, 3:] = rng.normal(size=(6, 3, TN))
    return (torch.from_numpy(np.ascontiguousarray(src.transpose(0, 2, 1), np.float32)),
            torch.from_numpy(pages))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("form", ["expanded-3", "direct-3", "direct-6"])
def test_slot_combine_equals_the_running_walk(form, seed):
    rows = 6 if form == "direct-6" else 3
    src, tgt = _scene(seed, rows)
    dist = _expanded_d2 if form == "expanded-3" else _direct_d2
    best, slot, row = _slot_combine(src, tgt, dist)
    won = slot >= 0
    assert not won[1].any() and won[0].any() and won[2].any()
    assert (best[won] == 0).any()  # exact zero distances were taken
    win, j = _winners(tgt, slot, row)
    start, cnt, pt = (torch.tensor(x, dtype=torch.int32) for x in (PAIR_START, PAIR_CNT, PAIR_TGT))
    if form == "expanded-3":
        d2, idx, xyz = pair_nn_plain(src, tgt, start, cnt, pt)
        assert torch.equal(d2[:, 0], best.clamp(min=0.0))
        assert torch.equal(idx[:, 0].long(), torch.where(won, row + j * TN, 0))
        assert torch.equal(xyz, win)
    else:
        eye, zero = torch.eye(3), torch.zeros(3)
        d2, qn = _associate_first(src, eye, zero, PAIR_START, PAIR_CNT, pt, tgt)
        assert torch.equal(d2, best)
        assert torch.equal(qn, win)


#: K5's prior: a quarter turn about z and a dyadic shift, so the transform
#: is exact and the inputs' ties and zero distances survive it
K5_T0 = torch.tensor([[0.0, -1.0, 0.0, 0.5], [1.0, 0.0, 0.0, -0.25], [0.0, 0.0, 1.0, 0.75],
                      [0.0, 0.0, 0.0, 1.0]])


@pytest.mark.parametrize("seed", [0, 1])
def test_k5_slot_combine_equals_p2p_associate_plain(seed):
    """K5's scan and combine: per-slot first-row minima of the source under
    the prior on 6-row pages, combined in slot order, equal
    `_p2p_associate_plain` (d2 and the winner's point and normal)."""
    placed, tgt = _scene(seed, 6)
    R, t = K5_T0[:3, :3], K5_T0[:3, 3]
    # the source in the sensor frame: R^T (x - t), exact on the 0.25 grid
    src = torch.einsum("ab,iat->ibt", R, placed - t[None, :, None])
    px, py, pz = src[:, 0], src[:, 1], src[:, 2]
    moved = torch.stack([R[a, 0] * px + R[a, 1] * py + R[a, 2] * pz + t[a] for a in range(3)], 1)
    best, slot, row = _slot_combine(moved, tgt, _direct_d2)
    won = slot >= 0
    assert not won[1].any() and won[0].any() and won[2].any()
    assert (best[won] == 0).any()  # exact zero distances were taken
    win, _ = _winners(tgt, slot, row)
    start, cnt, pt = (torch.tensor(x, dtype=torch.int32) for x in (PAIR_START, PAIR_CNT, PAIR_TGT))
    d2, qn = _p2p_associate_plain(src, tgt, start, cnt, pt, K5_T0)
    assert d2.shape == (3, 1, TM) and qn.shape == (3, 6, TM)
    assert torch.equal(d2[:, 0], best)
    assert torch.equal(qn, win)
    assert (d2[1] == BIG).all() and (qn[1] == 0).all()  # the tile with no admitted pair
