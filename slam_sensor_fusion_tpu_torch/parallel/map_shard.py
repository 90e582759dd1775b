"""Map-sharded point-to-plane registration (port of the point-to-plane half
of the JAX `parallel/map_shard.py`): registration against a map split into
Morton-contiguous shards.

The JAX package shards the MAP over a mesh's `sp` axis: each device holds
one chunk of the Morton-sorted map as complete 6-row pages, runs the
association-only kernel (K5) against it, all-gathers the per-point winners
(d2, matched point + normal), takes the first argmin over the shards and
runs the fixed-correspondence GN kernel (K6) on the combined matched set.
On one card the process holds every shard: `sp_p2p_align` runs K5 once a
shard, stacks the winners and combines them with `torch.argmin(dim=0)`,
whose first index on a tie is `jnp.argmin`'s, then runs K6 once. That
computes what the JAX function computes over a mesh of `n_shards` devices.
The `torch.distributed` form, `shard_cloud`, `sp_icp_align` and
`sp_run_chunk` are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slam_sensor_fusion_tpu_torch.ops.p2p_fused import (
    CachedP2PTarget,
    associate_p2p_fused,
    build_cached_p2p_target,
    p2p_gn_from_correspondences,
)
from slam_sensor_fusion_tpu_torch.ops.point_to_plane import (
    PointToPlaneConfig,
    PointToPlaneResult,
)


class ShardedP2PTarget(NamedTuple):
    """Per-shard point-to-plane target pages (xyz + normals): shard s is the
    complete `CachedP2PTarget` of rows [s * cap, (s + 1) * cap) of the page
    and box arrays, all rebased by the SAME `center` so winners combine in
    one frame."""

    pages: torch.Tensor  # (n_shards * nTt_cap, 6, TN)
    lo: torch.Tensor  # (n_shards * nTt_cap, 3) tile bbox minima (original frame)
    hi: torch.Tensor
    center: torch.Tensor  # (3,)
    n_shards: int

    def shard(self, s: int) -> CachedP2PTarget:
        """Shard s as the cached target its device would hold."""
        cap = self.pages.shape[0] // self.n_shards
        rows = slice(s * cap, (s + 1) * cap)
        return CachedP2PTarget(
            pages=self.pages[rows], lo=self.lo[rows], hi=self.hi[rows], center=self.center
        )


def shard_p2p_target(
    points: np.ndarray,  # (N, 3) Morton-sorted valid points
    normals: np.ndarray,  # (N, 3)
    normals_valid: np.ndarray,  # (N,) bool
    n_shards: int,
    tile_tgt: int,
    center: np.ndarray | None = None,
    device: torch.device | str = torch.device("cuda"),
) -> ShardedP2PTarget:
    """Split a Morton-sorted cloud + normals into `n_shards` contiguous
    chunks of ceil(N / n_shards) points, each padded to a multiple of
    `tile_tgt`, and pack each as 6-row pages (`build_cached_p2p_target`)
    on `device`."""
    dev = torch.device(device)
    if center is None:
        center = np.zeros(3, np.float32)
    n = len(points)
    per = -(-n // n_shards)  # ceil
    cap = -(-per // tile_tgt) * tile_tgt
    ctr = torch.as_tensor(np.asarray(center, np.float32), device=dev)
    pages, lo, hi = [], [], []
    for s in range(n_shards):
        sl = slice(s * per, (s + 1) * per)
        k = len(points[sl])
        pts = np.zeros((cap, 3), np.float32)
        nrm = np.zeros((cap, 3), np.float32)
        nv = np.zeros(cap, bool)
        pts[:k] = points[sl]
        nrm[:k] = normals[sl]
        nv[:k] = normals_valid[sl]
        cached = build_cached_p2p_target(
            torch.from_numpy(pts).to(dev), torch.arange(cap, device=dev) < k,
            torch.from_numpy(nrm).to(dev), torch.from_numpy(nv).to(dev), ctr, tile_tgt,
        )
        pages.append(cached.pages)
        lo.append(cached.lo)
        hi.append(cached.hi)
    return ShardedP2PTarget(
        pages=torch.cat(pages), lo=torch.cat(lo), hi=torch.cat(hi), center=ctr,
        n_shards=n_shards,
    )


def combine_shard_winners(
    d2s: list[torch.Tensor], qns: list[torch.Tensor]
) -> tuple[torch.Tensor, torch.Tensor]:
    """The first argmin over shards of each point's winner: (d2 (nSt, 1,
    TM), qn (nSt, 6, TM)) from the shards' (d2, qn) in shard order; an exact
    tie keeps the earlier shard."""
    d2_all = torch.stack(d2s)  # (n, nSt, 1, TM)
    qn_all = torch.stack(qns)  # (n, nSt, 6, TM)
    win = torch.argmin(d2_all, dim=0, keepdim=True)  # (1, nSt, 1, TM)
    d2 = torch.gather(d2_all, 0, win)[0]
    qn = torch.gather(qn_all, 0, win.expand(1, *qn_all.shape[1:]))[0]
    return d2, qn


def sp_p2p_align(
    source: torch.Tensor,  # (M, 3) padded scan
    source_mask: torch.Tensor,  # (M,)
    target: ShardedP2PTarget,
    initial_T: torch.Tensor,  # (4, 4)
    config: PointToPlaneConfig,
) -> PointToPlaneResult:
    """Point-to-plane registration with the map split into shards: K5 against
    each shard (its own pair list against that shard's boxes), the winners
    combined by first argmin over the shards, then K6 on the combined
    matched set. Equals `point_to_plane_align_fused` with
    `fixed_correspondences=True` against the whole map, up to distance
    ties, as the JAX function does."""
    d2s, qns = [], []
    for s in range(target.n_shards):
        d2, qn = associate_p2p_fused(source, source_mask, target.shard(s), initial_T, config)
        d2s.append(d2)
        qns.append(qn)
    d2, qn = combine_shard_winners(d2s, qns)
    return p2p_gn_from_correspondences(
        source, source_mask, d2, qn, initial_T, target.center, config
    )
