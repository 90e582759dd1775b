"""Nearest-neighbour search as a streaming distance argmin (port of the
JAX `ops/nn.py`).

The dense form of the search: every source point against every target
point, in tiles,

    d2(s, t) = |s|^2 - 2 s.t + |t|^2

where the ``s.t`` term is one (M, 3) x (3, chunk) matrix product a tile and
a running (min, argmin) is carried across target tiles. The JAX package
leaves this product to XLA outside any Pallas kernel, and the port leaves
it to `torch.matmul` (full float32 on the card by default). It is the
`nn_backend="xla"` association of `ops/point_to_plane.point_to_plane_align`,
the cross-check of the fused kernels.

The expanded form cancels catastrophically when |coords| is large, so
callers pass a ``center`` that rebases both clouds. Distances returned are
SQUARED.
"""

from __future__ import annotations

import torch

_BIG = float(3.0e38)


def nearest_neighbor(
    src: torch.Tensor,
    src_mask: torch.Tensor,
    tgt: torch.Tensor,
    tgt_mask: torch.Tensor,
    center: torch.Tensor | None = None,
    chunk: int = 4096,
) -> tuple[torch.Tensor, torch.Tensor]:
    """For each source point, its nearest valid target point: (d2 (M,),
    idx (M,) int32). Invalid queries still get outputs (callers mask them);
    invalid targets can never be neighbours; with no valid target d2 is
    ~3e38. The first row of an exact tie within a tile and the earlier tile
    across tiles win."""
    del src_mask
    M, N = src.shape[0], tgt.shape[0]
    if center is not None:
        src = src - center[None, :]
        tgt = tgt - center[None, :]
    src = src.float()
    tgt = tgt.float()
    s_norm = (src * src).sum(dim=-1)
    best_d2 = torch.full((M,), _BIG, dtype=torch.float32, device=src.device)
    best_idx = torch.zeros((M,), dtype=torch.int32, device=src.device)
    for j0 in range(0, N, chunk):
        t = tgt[j0 : j0 + chunk]
        m = tgt_mask[j0 : j0 + chunk]
        t_norm = (t * t).sum(dim=-1)
        cross = torch.matmul(src, t.T)  # (M, chunk), float32 accumulation
        # d2 = (s_norm - 2 cross) + t_norm, masked targets at _BIG, each
        # step in place in the product's buffer (the same roundings, one
        # (M, chunk) buffer a tile)
        d2 = torch.sub(s_norm[:, None], cross.mul_(2.0), out=cross)
        d2.add_(t_norm[None, :]).masked_fill_(~m[None, :], _BIG)
        tile_min, tile_arg = d2.min(dim=1)  # first column on ties
        better = tile_min < best_d2
        best_d2 = torch.where(better, tile_min, best_d2)
        best_idx = torch.where(better, (tile_arg + j0).to(torch.int32), best_idx)
    # squared distances can go slightly negative from rounding
    return torch.clamp(best_d2, min=0.0), best_idx


def gather_neighbors(tgt: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather matched target coordinates for correspondence pairs."""
    return tgt[idx.long()]


def min_dist_to_set(
    src: torch.Tensor,
    src_mask: torch.Tensor,
    tgt: torch.Tensor,
    tgt_mask: torch.Tensor,
    center: torch.Tensor | None = None,
    chunk: int = 4096,
) -> torch.Tensor:
    """Squared distance from each source point to the target set (no index)."""
    d2, _ = nearest_neighbor(src, src_mask, tgt, tgt_mask, center, chunk)
    return d2
