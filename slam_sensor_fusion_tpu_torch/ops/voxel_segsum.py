"""The order-exact segment sum of the device voxel stores, and its plain
version.

Both stores (ops/voxel_map, ops/voxel_map_sorted) reduce an insert group
to one moment per voxel cell: the group's rows sorted by cell, each cell a
run of consecutive rows (a segment), each segment's rows summed. The JAX
package does it with an XLA scatter-add over the sorted segment ids, which
adds each segment's rows one at a time in row order. On the card
`index_add_` adds with atomics in no fixed order, so the sums would move by
ulps from run to run; `segment_sum_sorted` keeps the row order:

- for CUDA tensors it launches csrc/voxel_segsum.cu (parallel over rows:
  tiles staged in shared memory, each segment chained in row order by one
  thread, a segment longer than its tile finished by its block) or
  raises;
- for CPU tensors it runs `segment_sum_sorted_plain`, which adds in the
  same order.
"""

from __future__ import annotations

import torch

from slam_sensor_fusion_tpu_torch.ops import cuda_lib


def segment_sum_sorted_plain(values: torch.Tensor, seg: torch.Tensor, n_out: int) -> torch.Tensor:
    """(n_out, C): row u is 0.0 plus the rows of `values` whose id in `seg`
    (nondecreasing) is u, added one at a time in row order; rows with an id
    outside [0, n_out) belong to no output row.

    A loop over the position in a run, vectorised across segments: step j
    adds row j of every segment longer than j. Segments are taken longest
    first, so the live ones are a prefix and the work is one addition a
    row. Rows of +0.0 or -0.0 in every column are left out first, as the
    kernel skips them: a sum starts at +0.0 and never becomes -0.0 under
    round-to-nearest (+0 + -0 = +0, x + -x = +0), and s + (+-0.0) = s for
    every other s, NaN included, so no bit moves; a masked run (zero
    payload) then costs no steps."""
    C = values.shape[1]
    dev = values.device
    out = torch.zeros((n_out, C), dtype=torch.float32, device=dev)
    keep = (values != 0).any(dim=1)
    values, seg = values[keep], seg[keep]
    if n_out == 0 or values.shape[0] == 0:
        return out
    ids = torch.arange(n_out + 1, dtype=seg.dtype, device=dev)
    bounds = torch.searchsorted(seg, ids)
    start, length = bounds[:-1], bounds[1:] - bounds[:-1]
    length, order = torch.sort(length, descending=True, stable=True)
    start = start[order]
    lens = length.tolist()
    live = n_out
    for j in range(lens[0]):
        while lens[live - 1] <= j:
            live -= 1
        rows = order[:live]
        out[rows] = out[rows] + values[start[:live] + j]
    return out


def segment_sum_sorted(values: torch.Tensor, seg: torch.Tensor, n_out: int) -> torch.Tensor:
    """The segment sums of `values` (S, C) float32 over the nondecreasing
    int32 ids `seg` (S,): (n_out, C), each row 0.0 plus its segment's rows
    in row order, as `segment_sum_sorted_plain`. CPU tensors run the plain
    version; CUDA tensors launch the kernel (csrc/voxel_segsum.cu), which
    takes C = 4 (every caller's (sum x, y, z, count)), or raise."""
    dev = values.device
    S, C = values.shape
    cuda_lib.require(values, "values", torch.float32, (S, C), dev)
    cuda_lib.require(seg, "seg", torch.int32, (S,), dev)
    if dev.type == "cpu":
        return segment_sum_sorted_plain(values, seg, n_out)
    if dev.type != "cuda":
        raise ValueError(f"segment_sum_sorted: unsupported device {dev}")
    if C != 4:
        raise ValueError(f"segment_sum_sorted: {C} columns, the kernel takes 4")
    out = torch.empty((n_out, C), dtype=torch.float32, device=dev)
    if n_out == 0:
        return out
    if values.data_ptr() % 16:  # the kernel copies a row as one 16-byte word
        values = values.clone()
    err = cuda_lib.lib().sfk_segment_sum_sorted(
        values.data_ptr(), seg.data_ptr(), S, C, n_out, out.data_ptr(),
        cuda_lib.stream_ptr(values),
    )
    cuda_lib.check(err, "segment_sum_sorted")
    segment_sum_sorted.launches += 1
    return out


#: kernel launches made by `segment_sum_sorted` (CUDA tensors only)
segment_sum_sorted.launches = 0
