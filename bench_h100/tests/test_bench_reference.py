"""The plain reference against the port's CPU path at a tiny size: its
pieces equal the port's set-up arithmetic, and a whole tiny run through
the harness (the port's plain versions in the timed path) is correct."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from tiny import make_base, run_tiny

from reference import localizer as ref


def _cloud(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)) * [8.0, 6.0, 1.5]).astype(np.float32)


def test_voxel_map_equals_merge_tiles():
    from slam_sensor_fusion_tpu_torch.models.mapping import merge_tiles

    tiles = [_cloud(3000, 1), _cloud(2000, 2) + 0.05, _cloud(10, 3)]
    got = ref.voxel_map([torch.from_numpy(t) for t in tiles], 0.1).numpy()
    np.testing.assert_array_equal(got, merge_tiles(tiles, 0.1))


def test_morton_order_equals_the_ports():
    from slam_sensor_fusion_tpu_torch.ops.morton import sort_points_numpy

    p = _cloud(5000, 4)
    np.testing.assert_array_equal(ref.morton_sorted(torch.from_numpy(p)).numpy(),
                                  sort_points_numpy(p))


@pytest.mark.parametrize("n", [5, 1024, 3001])
def test_sample_to_capacity_equals_the_ports(n):
    from slam_sensor_fusion_tpu_torch.ops import cloud as cl

    p = torch.from_numpy(_cloud(4096, n))
    mask = torch.zeros(4096, dtype=torch.bool)
    mask[torch.randperm(4096, generator=torch.Generator().manual_seed(n))[:n]] = True
    want = cl.sample_to_capacity(cl.Cloud(p, mask), 1024)
    got = ref.sample_to_capacity(p[mask], 1024)
    np.testing.assert_array_equal(got.numpy(), want.points[want.mask].numpy())


def test_grid_nearest_equals_a_dense_search():
    tgt = torch.from_numpy(_cloud(2000, 5))
    q = torch.from_numpy(_cloud(500, 6))
    g = ref.Grid(tgt, tgt, 0.5)
    d2, win = g.nearest(q, q)
    dense = ((q[:, None, :] - tgt[None]) ** 2).sum(-1)
    near = dense.amin(dim=1) < 0.5
    np.testing.assert_allclose(d2[near].numpy(), dense.amin(dim=1)[near].numpy(), rtol=1e-6)
    assert torch.equal(win[near], dense.argmin(dim=1)[near])


def test_tiny_run_is_correct(tmp_path):
    base, bench = make_base(str(tmp_path))
    rc, res, err = run_tiny(base, bench, seed=2**31 + 3)
    assert rc == 0, err
    assert res["correct"], err
    assert res["checks"]["startup_gap_m"]["value"] < 1e-4
    assert res["checks"]["pose_gap_m"]["value"] < 1e-4
    assert res["failed"] == 0 and res["attempted"] >= 1
