"""The yardstick's peaks and the operation and byte counts of the port's
kernels, from their shapes (the arithmetic of `chip_smoke.py`'s `bound`
and `utils/roofline.association_model`, divided here by the kernel's own
device time, not by a rate end to end)."""

from __future__ import annotations

#: NVIDIA H100 SXM (80 GB HBM3) data sheet, dense, at its 700 W limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "bytes_per_s": 3.35e12},
}
#: a squared distance (t - s)^2 over three axes: 3 subtractions, 3
#: products, 2 additions
FLOP_PER_DISTANCE = 8
F32 = 4


def peak(device_name: str) -> dict:
    if device_name not in PEAKS:
        raise KeyError(f"no peak for {device_name!r}")
    return PEAKS[device_name]


def bound_ms(flops: float, n_bytes: float, pk: dict) -> tuple[float, str]:
    """The least time the card could take (ms) and what bounds it: the
    larger of operations over the f32 peak and bytes over the memory rate."""
    t_ops, t_bytes = flops / pk["f32_flops"], n_bytes / pk["bytes_per_s"]
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def k1_flops(tile_pairs: int, tile_src: int, tile_tgt: int) -> float:
    """K1's distances over the admitted tile pairs, one association a frame
    (the lazy ICP's floor: a plateau re-associates, which is not counted)."""
    return float(tile_pairs) * tile_src * tile_tgt * FLOP_PER_DISTANCE


def k1_bytes(K: int, n_src_tiles: int, tile_src: int, n_tgt_tiles: int, tile_tgt: int,
             max_pairs: int, queue: int) -> int:
    """Each input and output byte of one K1 launch once: source pages, pair
    lists, the frames' poses and traces, the carried state, the target
    pages; poses, priors, predictions, stats and the new state out."""
    inputs = (
        K * n_src_tiles * 3 * tile_src  # src_pages
        + 2 * K * n_src_tiles  # pair_start, pair_cnt
        + K * max_pairs  # pair_tgt
        + K  # valid
        + 2 * K * 16 + 2 * K  # odom_T, gps_T, their traces
        + 16 + 16 + queue * 16 + 1 + 16 + 3  # pose, odom_prev, filter, centre
        + n_tgt_tiles * 3 * tile_tgt  # tgt_pages
    )
    outputs = 3 * K * 16 + K * 128 + (queue + 3) * 16 + 128
    return (inputs + outputs) * F32
