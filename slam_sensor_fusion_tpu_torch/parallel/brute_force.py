"""Brute-force first fix with the candidate grid split over a mesh (port of
the JAX `parallel/brute_force.py`).

The 4-DoF candidate sweep (ops/brute_force.py) is the startup's most
compute-heavy moment. The JAX package splits the candidate axis over its
devices: each scores a contiguous slice of the enumeration order against
the replicated clouds, finds its local first hit and best candidate, and
one all-gather of four numbers a shard reduces the winners. Slices are
contiguous and in shard order, so "the first candidate in enumeration order
under the threshold" stays exact. The port scores each shard this process
holds in turn (`_chunk_scores`, the single-device sweep's scoring) and
gathers the four numbers over the mesh (`Mesh.gather`).
"""

from __future__ import annotations

import numpy as np
import torch

from slam_sensor_fusion_tpu_torch.ops import geometry
from slam_sensor_fusion_tpu_torch.ops.brute_force import (
    BruteForceResult,
    _chunk_scores,
    candidate_grid,
)
from slam_sensor_fusion_tpu_torch.parallel.mesh import Mesh
from slam_sensor_fusion_tpu_torch.utils.config import BruteForceConfig

_BIG = 3.0e38
_IBIG = 2**30


def sharded_brute_force_align(
    source: torch.Tensor,
    source_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    guess: torch.Tensor,
    config: BruteForceConfig,
    mesh: Mesh,
    target_chunk: int = 2048,
) -> BruteForceResult:
    """The candidate sweep of `brute_force_align` split over `mesh`: the
    grid padded to n_shards * ceil(C / n_shards) candidates (the last one
    repeated), every shard scored whole (no early exit), and the earliest
    hit in enumeration order, else the best score, chosen from the shards'
    gathered (first hit, best score, best index, hit score)."""
    dev = source.device
    n = mesh.n_shards
    offs_np, yaws_np = candidate_grid(config)
    C = offs_np.shape[0]
    per = -(-C // n)
    pad = per * n - C
    if pad:
        offs_np = np.concatenate([offs_np, np.repeat(offs_np[-1:], pad, 0)])
        yaws_np = np.concatenate([yaws_np, np.repeat(yaws_np[-1:], pad, 0)])
    offsets = torch.from_numpy(offs_np).to(dev)
    yaws = torch.from_numpy(yaws_np).to(dev)
    center = guess[:3, 3]
    big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
    local = []
    for s in mesh.local_shards:
        sl = slice(s * per, (s + 1) * per)
        scores = _chunk_scores(guess, offsets[sl], yaws[sl], source, source_mask, target,
                               target_mask, center, target_chunk)
        hits = scores < config.mean_error_threshold
        has_hit = hits.any()
        first_local = torch.argmax(hits.to(torch.int32))  # the first True
        best_local = torch.argmin(scores)
        local.append(torch.stack([
            torch.where(has_hit, s * per + first_local, _IBIG).float(),
            scores[best_local],
            (s * per + best_local).float(),
            torch.where(has_hit, scores[first_local], big),
        ]))
    stats = mesh.gather(torch.stack(local))  # (n_shards, 4)
    hit_idx_all = stats[:, 0].to(torch.int64)
    best_scores = stats[:, 1]
    best_idx_all = stats[:, 2].to(torch.int64)
    hit_scores = stats[:, 3]
    found = (hit_idx_all < _IBIG).any()
    first_dev = torch.argmin(hit_idx_all)  # the earliest hit in enumeration order
    best_dev = torch.argmin(best_scores)
    idx = torch.where(found, hit_idx_all[first_dev], best_idx_all[best_dev])
    idx = torch.clamp(idx, 0, offsets.shape[0] - 1)
    T = guess @ geometry.make_T(geometry.rot_z(yaws[idx]), offsets[idx])
    score = torch.where(found, hit_scores[first_dev], best_scores[best_dev])
    return BruteForceResult(success=found, transformation=T, score=score)
