"""Analytic roofline/utilization accounting for the hot kernels (port of
the JAX `utils/roofline.py`: the same op/byte model, other peaks).

Turns scans/s into "how far from the card's ceiling": an analytic op/byte
model of the dominant kernel — gated tile-pair association: admitted
(src, tgt) tile pairs x one (TN, TM) distance/argmin pass each — plus the
Kabsch/GN moment reductions, evaluated against the peaks of one NVIDIA
H100 SXM from NVIDIA's data sheet (dense rates, at the 700 W power limit;
a card set to a lower limit runs slower under load):

* float32 outside the tensor cores: 67e12 FLOP/s (the association kernels
  use no tensor cores: their distance pass is elementwise f32 work);
* HBM3: 3.35e12 B/s.

These are data-sheet figures, not measurements. The association model is
a LOWER bound on executed ops: one association sweep per frame (the lazy
default's floor) plus the per-live-iteration moment reductions; plateau
re-association sweeps add more work that the fused kernel does not
expose. A low reported utilization is therefore conservative: the real
kernel does at least this much useful work per second.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet, float32 on the CUDA cores
H100_F32_FLOPS = 67e12
#: NVIDIA H100 SXM data sheet, HBM3 bandwidth
H100_HBM_BYTES = 3.35e12

#: elementwise ops per (target, source) element of one association pass:
#: 3 sub + 3 mul + 2 add (direct-difference d2) + compare + 2 select for
#: the running (min, argmin)
_OPS_PER_DIST_ELEM = 11
#: ops per matched point per Kabsch/GN iteration: ~9 products for the
#: cross-moment accumulation + 6 for centroids/error, masked
_OPS_PER_MOMENT_ELEM = 15


def association_model(
    pairs_per_frame: float,
    tile_src: int,
    tile_tgt: int,
    live_iters_per_frame: float,
    scan_points: int,
    target_points: int,
    frames_per_sec: float,
    superstep: int = 1,
    assoc_passes_per_frame: float = 1.0,
) -> dict:
    """Per-frame op/byte counts -> achieved rates vs the data-sheet peaks.

    `pairs_per_frame` is the measured pair demand (`StepOutput.
    pair_demand`); `live_iters_per_frame` the measured mean ICP/GN
    iterations. HBM bytes per frame: the scan pages once per frame + the
    target pages amortized over the superblock (one launch a superblock).
    """
    dist_ops = (
        assoc_passes_per_frame
        * pairs_per_frame
        * tile_src
        * tile_tgt
        * _OPS_PER_DIST_ELEM
    )
    moment_ops = live_iters_per_frame * scan_points * _OPS_PER_MOMENT_ELEM
    ops_per_frame = dist_ops + moment_ops

    bytes_per_frame = (
        scan_points * 3 * 4  # scan pages in
        + (target_points * 3 * 4) / max(superstep, 1)  # amortized target
        + scan_points * 4 * 4  # matched winner pages out (d2 + coords)
    )

    achieved_ops = ops_per_frame * frames_per_sec
    achieved_bytes = bytes_per_frame * frames_per_sec
    f32_frac = achieved_ops / H100_F32_FLOPS
    hbm_frac = achieved_bytes / H100_HBM_BYTES
    return {
        "assoc_gops_per_frame": round(ops_per_frame / 1e9, 4),
        "achieved_f32_tops": round(achieved_ops / 1e12, 3),
        "f32_util_frac": round(f32_frac, 4),
        "hbm_gbps": round(achieved_bytes / 1e9, 3),
        "hbm_util_frac": round(hbm_frac, 5),
        "bound": "f32" if f32_frac > hbm_frac else "hbm",
        "peaks": "NVIDIA H100 SXM data sheet: 67 TFLOP/s f32, 3.35 TB/s HBM3",
        "model": "lower-bound: 1 assoc sweep/frame + per-iter moments",
    }


def frame_time_budget(frames_per_sec: float) -> dict:
    """The latency identity the utilization is judged against."""
    return {
        "ms_per_frame": round(1000.0 / frames_per_sec, 4),
        "x_realtime_10hz": round(frames_per_sec / 10.0, 1),
    }
