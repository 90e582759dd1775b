"""bench_kitti's LIO through both packages on the CPU from one initial
state: the ATE-RMSE of each, and how far apart their poses are.

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/kitti_lio_ate.py [--frames 64]

bench.py bench_kitti's LIOConfig word for word (chip_smoke.py
`bench_kitti_lio_config`: registration subsample 8, cell normals at 1.2 m,
the fused backend, source tiles of 512) on its own fixture (129 frames of
16 384 points over 140 m, of which the first `--frames` after the seeding
frame run), through `run_lio_superblocks` with deskew in each package,
both starting from the port's `init_state` (the JAX side's K7 in Pallas
interpret mode, the port's K7 its plain version). The JAX package runs
twice: in one call over every frame (its loop over blocks), and a block a
call, each call continuing from the last one's state (one-block programs,
which XLA compiles into other fusions than the loop's). Prints one JSON
line: each package's ATE-RMSE against the fixture's poses, the worst pose
difference between them in the first block, in each block and over the
run, the port's against the block-a-call run, and how many
of the first anchor's valid cell normals differ by more than 1e-3 in
direction. A minute or more of interpret-mode Pallas: not a tier-1 test.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
jax.config.update("jax_platforms", "cpu")

import chip_smoke as cs  # noqa: E402  (its fixture and configuration)
from slam_sensor_fusion_tpu.models import lio as jl  # noqa: E402
from slam_sensor_fusion_tpu_torch.models import lio as tl  # noqa: E402
from slam_sensor_fusion_tpu_torch.utils import kitti  # noqa: E402
from test_torch_lio_superblock import jax_lio_config  # noqa: E402
from test_torch_lio_wide import _jax_state  # noqa: E402
from torch_parity import np_tree, t  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=64)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        kitti.make_synthetic_kitti(tmp, n_frames=cs.BENCH_KITTI_FRAMES,
                                   max_points=cs.BENCH_KITTI_POINTS, extent=cs.KITTI_EXTENT)
        seq = kitti.load_sequence(tmp, "00")
    cfg = cs.bench_kitti_lio_config(seq.scans, cs.WIDE_TILES[0])
    sp, sm, tp, gyro, accel, dts, gps = cs.lio_inputs(seq, cfg.scan_capacity)
    n = args.frames
    poses = seq.poses[: n + 1]
    frames = (sp[1:n + 1], sm[1:n + 1], gyro[:n], accel[:n], dts[:n], gps[:n],
              np.full(n, 0.5**2, np.float32), np.ones(n, bool))
    tau = tp[1:n + 1]
    v0 = ((poses[1, :3, 3] - poses[0, :3, 3]) / 0.1).astype(np.float32)
    st_t = tl.init_state(cfg, t(sp[0]), t(sm[0]), t(poses[0].astype(np.float32)))
    st_t = st_t._replace(ekf_state=st_t.ekf_state._replace(v=t(v0)))
    st_j = _jax_state(st_t)
    _, out_j = jl.run_lio_superblocks(st_j, *[jnp.asarray(a) for a in frames],
                                      jax_lio_config(cfg), scan_tau=jnp.asarray(tau),
                                      interpret=True)
    # the JAX package a block a call (one-block programs, each continuing
    # from the last one's state)
    R, st_b, blocks = cfg.refresh_every, st_j, []
    for lo in range(0, n, R):
        st_b, out_b = jl.run_lio_superblocks(
            st_b, *[jnp.asarray(a[lo:lo + R]) for a in frames], jax_lio_config(cfg),
            scan_tau=jnp.asarray(tau[lo:lo + R]), interpret=True)
        blocks.append(np.asarray(out_b.world_T_body))
    est_b = np.concatenate(blocks)
    _, out_t = tl.run_lio_superblocks(st_t, *[t(a) for a in frames], cfg, scan_tau=t(tau))
    est_j, est_t = np_tree(out_j).world_T_body, out_t.world_T_body.numpy()
    d = np.abs(est_t - est_j).max(axis=(1, 2))
    d_b = np.abs(est_t - est_b).max(axis=(1, 2))
    # each package's first refresh of the same ring (the JAX one jitted, as
    # the LIO runs it): their cell normals
    a_j = jax.jit(jl._refresh_anchor, static_argnums=3)(
        st_j.ring, st_j.ring_mask, st_j.ekf_state.p, jax_lio_config(cfg))
    a_t = tl._refresh_anchor(st_t.ring, st_t.ring_mask, st_t.ekf_state.p, cfg)
    valid = np.asarray(a_j[3])
    gap = 1.0 - np.abs((a_t[2].numpy() * np.asarray(a_j[2])).sum(-1))[valid]
    print(json.dumps({
        "frames": n, "ate_rmse_m_port": cs.ate_rmse(est_t, poses[1:]),
        "ate_rmse_m_jax": cs.ate_rmse(est_j, poses[1:]),
        "pose_diff_first_block": float(d[:cfg.refresh_every].max()),
        "pose_diff_run": float(d.max()),
        "pose_diff_by_block": [float(d[i:i + cfg.refresh_every].max())
                               for i in range(0, n, cfg.refresh_every)],
        "ate_rmse_m_jax_block_a_call": cs.ate_rmse(est_b, poses[1:]),
        "pose_diff_run_vs_jax_block_a_call": float(d_b.max()),
        "jax_call_vs_jax_block_a_call": float(np.abs(est_j - est_b).max()),
        "valid_normals": int(valid.sum()),
        "valid_masks_equal": bool(np.array_equal(a_t[3].numpy(), valid)),
        "normals_apart_1e-3": int((gap > 1e-3).sum()), "normals_max_gap": float(gap.max()),
    }), flush=True)


if __name__ == "__main__":
    main()
