"""Pair-list gated nearest-neighbour search: K2 and its plain version
(port of the JAX `ops/nn_pallas.py`).

Tile culling (ops/nn_gated.py) yields, per source tile, the admissible
target tiles nearest-first; `_build_tile_pair_list` flattens them into the
TILE-MAJOR list (per-tile start and count into one flat target list) that
both K1 and K2 walk. The JAX package fed K2 a pair-major list instead; the
two visit each source tile's targets in the same order, so K2's outputs do
not change (tests/test_torch_nn.py holds them equal).

`pair_nn` launches the CUDA kernel (csrc/nn_pallas.cu: a scan of (source
tile, pair slot) items over the whole card, then a combine of each row's
slots in order) for tensors on the card and runs `pair_nn_plain` for
tensors on the CPU. `gated_nn_pallas` is the one-call form: culling, pair
list, pages and K2 for two Morton-sorted clouds.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam_sensor_fusion_tpu_torch.ops import cuda_lib
from slam_sensor_fusion_tpu_torch.ops import xla_math as xm

_BIG = 3.0e38
_FAR = 1.0e7  # sentinel coordinate for invalid points (d2 ~ 1e14 << _BIG)


class PallasNNResult(NamedTuple):
    d2: torch.Tensor
    idx: torch.Tensor
    overflow: torch.Tensor  # () bool: max_pairs or max_visits truncated the list


def _build_tile_pair_list(
    visits: torch.Tensor, counts: torch.Tensor, max_pairs: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flatten (visits (..., nSt, V), counts (..., nSt)) into per-source-tile
    (start, count) offsets and a flat target list (..., max_pairs).

    Same integers as the JAX function: entries past `max_pairs` are
    dropped (counts clipped so start + cnt <= max_pairs), and the unused
    tail of the list repeats the last tile's visits like
    `jnp.repeat(total_repeat_length=...)` pads (nn_pallas.py:92-101)."""
    lead = counts.shape[:-1]
    nSt, V = visits.shape[-2], visits.shape[-1]
    counts = counts.to(torch.int64)
    starts = torch.cumsum(counts, dim=-1) - counts
    p = torch.arange(max_pairs, device=counts.device)
    # source tile of flat slot p: the last tile whose start is <= p
    pair_src = torch.searchsorted(
        starts.contiguous(), p.expand(lead + (max_pairs,)).contiguous(), right=True
    ) - 1
    rank = p - torch.gather(starts, -1, pair_src)
    rank = torch.clamp(rank, 0, V - 1)
    flat = visits.reshape(lead + (nSt * V,)).to(torch.int64)
    pair_tgt = torch.gather(flat, -1, pair_src * V + rank)
    cnt = torch.clamp(torch.minimum(counts, max_pairs - starts), min=0)
    start = torch.clamp(starts, 0, max_pairs - 1)
    return start.to(torch.int32), cnt.to(torch.int32), pair_tgt.to(torch.int32)


def make_pages(
    pts: torch.Tensor,
    mask: torch.Tensor,
    center: torch.Tensor,
    tile: int,
    sentinel: float = _FAR,
) -> torch.Tensor:
    """(N, 3) + mask -> (n_tiles, 3, TILE) pages, rebased on `center`, with
    invalid points moved to the sentinel. Give source and target DIFFERENT
    sentinels where matches are gated only by distance."""
    n = pts.shape[0]
    safe = torch.where(mask[:, None], (pts - center[None, :]).float(), sentinel)
    return safe.reshape(n // tile, tile, 3).transpose(1, 2).contiguous()


def _tile_chunk(TN: int, TM: int) -> int:
    """Target tiles per vectorized step of a plain version: the (C, TN, TM)
    distance temporaries held to ~128K elements, so a step's passes stay in
    the host's caches (K2's plain version over 19 calls of a test world:
    14.9 s a process at ~16M elements, 7.8 s at 128K, one thread). Any
    chunk gives the same bits: the first tile wins a tie within a step and
    a strict `<` keeps the earlier step's."""
    return max(1, (1 << 17) // (TN * TM))


def pair_nn_plain(
    src_pages: torch.Tensor,  # (nSt, 3, TM)
    tgt_pages: torch.Tensor,  # (nTt, 3, TN)
    pair_start: torch.Tensor,  # (nSt,)
    pair_cnt: torch.Tensor,  # (nSt,)
    pair_tgt: torch.Tensor,  # (max_pairs,)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 written as masked distance sweeps: per source tile, the expanded
    d2 = (|t|^2 - 2 t.s) + |s|^2 against each admitted target tile (each
    product sum a fused multiply-add chain, `xla_math.dot3`), first argmin within
    a tile, strict `<` across tiles in visit order, d2 clamped at 0.
    Returns d2 (nSt,1,TM), idx (nSt,1,TM) int32 and the winner
    coordinates xyz (nSt,3,TM) in the pages' frame."""
    nSt, _, TM = src_pages.shape
    TN = tgt_pages.shape[2]
    dev = src_pages.device
    d2_out = torch.full((nSt, 1, TM), _BIG, dtype=torch.float32, device=dev)
    idx_out = torch.zeros((nSt, 1, TM), dtype=torch.int32, device=dev)
    xyz_out = torch.zeros((nSt, 3, TM), dtype=torch.float32, device=dev)
    starts = pair_start.tolist()
    cnts = pair_cnt.tolist()
    chunk = _tile_chunk(TN, TM)
    cols = torch.arange(TM, device=dev)
    for i in range(nSt):
        s = src_pages[i]
        sx, sy, sz = s[0], s[1], s[2]
        s_norm = xm.dot3(sx, sy, sz, sx, sy, sz)
        best, bidx, bxyz = d2_out[i, 0], idx_out[i, 0], xyz_out[i]
        for c0 in range(0, cnts[i], chunk):
            js = pair_tgt[starts[i] + c0 : starts[i] + min(cnts[i], c0 + chunk)].long()
            t = tgt_pages[js]  # (C, 3, TN)
            tx, ty, tz = t[:, 0, :, None], t[:, 1, :, None], t[:, 2, :, None]
            t_norm = xm.dot3(tx, ty, tz, tx, ty, tz)
            cross = xm.dot3(tx, ty, tz, sx, sy, sz)  # (C, TN, TM)
            d2 = (t_norm - 2.0 * cross) + s_norm
            tile_min, arg = d2.min(dim=1)  # first row on ties
            cmin, carg = tile_min.min(dim=0)  # first tile on ties
            row = arg[carg, cols]
            better = cmin < best
            best.copy_(torch.where(better, cmin, best))
            bidx.copy_(torch.where(better, (row + js[carg] * TN).int(), bidx))
            win = t[carg, :, row].T  # (3, TM)
            bxyz.copy_(torch.where(better[None], win, bxyz))
    return torch.clamp(d2_out, min=0.0), idx_out, xyz_out


def pair_nn(
    src_pages: torch.Tensor,
    tgt_pages: torch.Tensor,
    pair_start: torch.Tensor,
    pair_cnt: torch.Tensor,
    pair_tgt: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 on prebuilt pages and a tile-major pair list; page-layout outputs
    as `pair_nn_plain`. CPU tensors run the plain version; CUDA tensors
    launch the kernel (csrc/nn_pallas.cu) or raise."""
    dev = src_pages.device
    nSt, _, TM = src_pages.shape
    nTt, _, TN = tgt_pages.shape
    f32, i32 = torch.float32, torch.int32
    cuda_lib.require(src_pages, "src_pages", f32, (nSt, 3, TM), dev)
    cuda_lib.require(tgt_pages, "tgt_pages", f32, (nTt, 3, TN), dev)
    cuda_lib.require(pair_start, "pair_start", i32, (nSt,), dev)
    cuda_lib.require(pair_cnt, "pair_cnt", i32, (nSt,), dev)
    cuda_lib.require(pair_tgt, "pair_tgt", i32, tuple(pair_tgt.shape), dev)
    if dev.type == "cpu":
        return pair_nn_plain(src_pages, tgt_pages, pair_start, pair_cnt, pair_tgt)
    if dev.type != "cuda":
        raise ValueError(f"pair_nn: unsupported device {dev}")
    cuda_lib.check_tile_src("pair_nn", TM)
    d2 = torch.empty((nSt, 1, TM), dtype=f32, device=dev)
    idx = torch.empty((nSt, 1, TM), dtype=i32, device=dev)
    xyz = torch.empty((nSt, 3, TM), dtype=f32, device=dev)
    # each admitted pair slot's tile minimum and first winning row, from
    # the scan spread over the card, combined per source row in slot order
    max_pairs = pair_tgt.shape[0]
    slot_d2 = torch.empty((max_pairs, TM), dtype=f32, device=dev)
    slot_row = torch.empty((max_pairs, TM), dtype=i32, device=dev)
    err = cuda_lib.lib().sfk_pair_nn(
        src_pages.data_ptr(), tgt_pages.data_ptr(), pair_start.data_ptr(),
        pair_cnt.data_ptr(), pair_tgt.data_ptr(), nSt, TM, TN, max_pairs,
        d2.data_ptr(), idx.data_ptr(), xyz.data_ptr(), slot_d2.data_ptr(), slot_row.data_ptr(),
        cuda_lib.stream_ptr(src_pages),
    )
    cuda_lib.check(err, "pair_nn")
    pair_nn.launches += 1
    pair_nn.scratch_bytes = max(pair_nn.scratch_bytes, slot_d2.nbytes + slot_row.nbytes)
    return d2, idx, xyz


#: calls of `pair_nn` that launched K2 (CUDA tensors only): one a call,
#: though K2 is two launches (the scan and the combine)
pair_nn.launches = 0
#: the largest per-slot scratch (bytes, slot_d2 and slot_row) a launch has
#: allocated since this was last set to 0
pair_nn.scratch_bytes = 0


def gated_nn_pallas(
    src: torch.Tensor,
    src_mask: torch.Tensor,
    tgt: torch.Tensor,
    tgt_mask: torch.Tensor,
    center: torch.Tensor,
    radius2: float,
    tile_src: int = 256,
    tile_tgt: int = 512,
    max_visits: int = 24,
    max_pairs: int | None = None,
) -> PallasNNResult:
    """Gated NN over Morton-sorted clouds in one call (the JAX function,
    nn_pallas.py:232-274): the visit lists of ops/nn_gated, the tile-major
    pair list truncated at `max_pairs` (default 8 a source tile; the same
    entries the JAX package's pair-major list keeps), pages of both clouds
    rebased on `center`, then K2 (`pair_nn`: the kernel for CUDA tensors,
    the plain version for CPU ones). d2 (M,) is _BIG on masked source
    rows, idx (M,) a flat target index. Exact, as the dense search, for
    every source row whose nearest neighbour lies within the gate;
    `overflow` reports a truncated visit or pair list."""
    # imported here: ops/nn_gated imports this module
    from slam_sensor_fusion_tpu_torch.ops.nn_gated import build_visit_lists

    M = src.shape[0]
    nSt = M // tile_src
    if max_pairs is None:
        max_pairs = nSt * 8
    visits, counts, v_overflow = build_visit_lists(
        src, src_mask, tgt, tgt_mask, radius2, tile_src, tile_tgt, max_visits
    )
    pair_start, pair_cnt, pair_tgt = _build_tile_pair_list(visits, counts, max_pairs)
    overflow = v_overflow | (counts.sum() > max_pairs)
    src_pages = make_pages(src, src_mask, center, tile_src)
    tgt_pages = make_pages(tgt, tgt_mask, center, tile_tgt)
    d2, idx, _ = pair_nn(src_pages, tgt_pages, pair_start, pair_cnt, pair_tgt)
    d2 = torch.where(src_mask, d2.reshape(M), _BIG)
    return PallasNNResult(d2=d2, idx=idx.reshape(M), overflow=overflow)


def kernel_grid(tile_src: int, max_pairs: int) -> dict:
    """K2's scan grid on the current card for source tiles of `tile_src`
    rows and a pair list of `max_pairs` slots: blocks, threads a block and
    the blocks a multiprocessor could hold."""
    return cuda_lib.grid_shape(cuda_lib.lib().sfk_pair_nn_grid, tile_src, max_pairs)
