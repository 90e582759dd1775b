"""A prefix sum along the rows in XLA's order of addition, and its plain
version.

The cell normals (ops/point_to_plane.estimate_normals_cells) take each
cell's moments as differences of a float32 prefix sum over the whole
anchor at world coordinates: the sums reach ~1e6 while a cell's variance
is ~1e-2, so the order in which the scan adds decides the normals of thin
cells. The JAX package's `jnp.cumsum` does not add row after row: XLA on
the CPU lowers it to a reduce-window that its rewriter splits into blocks
of `BLOCK_ROWS` rows,

1. each block summed row by row, starting from +0.0;
2. the blocks' totals scanned recursively in the same way;
3. the exclusive prefix of the totals added to every row of its block
   (+0.0 to block 0).

`torch.cumsum` adds in other orders (in float64 on the CPU, CUB's on the
card), so `cumsum_rows` keeps XLA's:

- for CPU tensors it runs `cumsum_rows_plain`;
- for CUDA float32 tensors it launches csrc/ordered_scan.cu once (one
  pass: chunks of the tree scanned in shared memory, their totals summed
  up a tree of flagged items in the scratch in the same order, each
  chunk's prefix read from its predecessors' and added down) or raises.

The +0.0 start matters: a masked row at a negative coordinate gives -0.0
moments, and the scan turns a leading -0.0 into +0.0 as XLA's does, except
in a scan of one row, which XLA returns as it is.
"""

from __future__ import annotations

import torch

from slam_sensor_fusion_tpu_torch.ops import cuda_lib

#: rows a block of the scan: XLA's CPU reduce-window rewriter's base length
#: (found against jaxlib 0.9.0; tests/test_torch_ordered_scan.py pins it)
BLOCK_ROWS = 16


def cumsum_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """The inclusive prefix sum of `x` (N, C) along dim 0, in `x`'s dtype,
    added in the order of XLA's blocked scan (the module's docstring)."""
    N, C = x.shape
    if N <= 1:  # XLA leaves a scan of one row as it is, -0.0 included
        return x.clone()
    nb = -(-N // BLOCK_ROWS)
    blocks = torch.zeros((nb * BLOCK_ROWS, C), dtype=x.dtype, device=x.device)
    blocks[:N] = x
    blocks = blocks.view(nb, BLOCK_ROWS, C)
    out = torch.empty_like(blocks)
    acc = torch.zeros((nb, C), dtype=x.dtype, device=x.device)
    for j in range(BLOCK_ROWS):
        acc = acc + blocks[:, j]
        out[:, j] = acc
    excl = torch.zeros((nb, C), dtype=x.dtype, device=x.device)
    if nb > 1:
        excl[1:] = cumsum_rows_plain(acc)[:-1]
    out = out + excl[:, None, :]
    return out.view(nb * BLOCK_ROWS, C)[:N]


def cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    """The prefix sum of `x` (N, C) along dim 0 in XLA's order, as
    `cumsum_rows_plain`. CPU tensors run the plain version; CUDA float32
    tensors launch the kernel (csrc/ordered_scan.cu) once, bit-equal to it;
    any other tensor raises (C from 1 to 256)."""
    dev = x.device
    if x.dim() != 2:
        raise ValueError(f"cumsum_rows: shape {tuple(x.shape)}, expected (N, C)")
    if dev.type == "cpu":
        return cumsum_rows_plain(x)
    if dev.type != "cuda":
        raise ValueError(f"cumsum_rows: unsupported device {dev}")
    N, C = x.shape
    cuda_lib.require(x, "x", torch.float32, (N, C), dev)
    out = torch.empty((N, C), dtype=torch.float32, device=dev)
    if N == 0 or C == 0:
        return out
    so = cuda_lib.lib()
    S = so.sfk_cumsum_scratch_floats(N, C)
    scratch = torch.empty(max(S, 1), dtype=torch.float32, device=dev)
    err = so.sfk_cumsum_rows(x.data_ptr(), N, C, out.data_ptr(), scratch.data_ptr(), S,
                             cuda_lib.stream_ptr(x))
    cuda_lib.check(err, "cumsum_rows")
    cumsum_rows.launches += 1
    return out


#: kernel launches made by `cumsum_rows` (CUDA tensors only)
cumsum_rows.launches = 0
