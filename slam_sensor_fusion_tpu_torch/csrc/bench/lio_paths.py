#!/usr/bin/env python3
"""The LIO paths of chip_smoke.py's phases 6, 7 and 13 on one GPU: ATE-RMSE
and scans/s of each.

    python3 slam_sensor_fusion_tpu_torch/csrc/bench/lio_paths.py [--package DIR] [--label NAME]

Imports the package of the checkout at DIR (default: this one; a `git
archive` of a parent commit unpacked under the git-ignored `_parent/`
gives the parent's package, its kernels built into DIR's own `_build/`)
and takes the worlds and configurations from this checkout's
chip_smoke.py, so two trees run the same inputs. Paths, each run twice
from one state (the second pass timed, host clock around a synchronised
call):

- phase 6: `run_lio_blocks` (one K4 launch a frame) and `LIOSession.push`
  over bench_lio's world at its width (129 frames; the session's rate is
  frames over the pushes' summed time, its single pass);
- phase 7: `run_lio_superblocks` (one K7 launch a 16-frame block) over the
  same frames;
- phase 13: `run_lio_superblocks` at bench_kitti's own LIO settings at
  source tiles of 512, 2048 and 4096 rows on (a) bench_kitti's fixture
  (129 frames of 16 384 points) and (b) the seq-00-density fixture of
  phase 10 (its first 65 frames).

Every anchor refresh runs the cell normals, so a change there shows in
each path's ATE. One JSON line a path, with the card's name and power
limit. Run parent, change, change, parent in one call to compare two
trees on one card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))


def smoke_helpers():
    """This checkout's chip_smoke.py as a module (its worlds, configurations
    and constants), whichever package is on the path."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", default=ROOT, help="checkout whose package runs")
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.package))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("lio_paths: no CUDA device")
    from slam_sensor_fusion_tpu_torch.models import lio
    from slam_sensor_fusion_tpu_torch.models.session import LIOSession
    from slam_sensor_fusion_tpu_torch.utils import kitti

    cs = smoke_helpers()
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def emit(path, frames, seconds, est, gt, **extra):
        print(json.dumps({"label": args.label, "path": path, "frames": frames,
                          "scans_s": frames / seconds, "ate_rmse_m": cs.ate_rmse(est, gt),
                          **extra, "card": card}), flush=True)

    def twice(run, frames):
        """Two passes of `run`: (the second's seconds, its output)."""
        for _ in range(2):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
        return dt, out

    # ---- phases 6 and 7: bench_lio's world at its width ----
    lcfg = cs.lio_config()
    poses, v0, sp, sm, tp, gyro, accel, dts, gps = cs.build_lio_world(cs.LIO_FRAMES,
                                                                       lcfg.scan_capacity)
    Tl = cs.LIO_FRAMES - 1
    gps_var = np.full(Tl, 0.5**2, np.float32)
    arrays = [up(a) for a in (sp[1:], sm[1:], gyro, accel, dts, gps, gps_var, np.ones(Tl, bool))]
    tau = up(tp[1:])
    state0 = lio.init_state(lcfg, up(sp[0]), up(sm[0]), up(poses[0]))
    state0 = state0._replace(ekf_state=state0.ekf_state._replace(v=up(v0)))
    for path, fn in (("phase 6 run_lio_blocks", lio.run_lio_blocks),
                     ("phase 7 run_lio_superblocks", lio.run_lio_superblocks)):
        dt, (_, out) = twice(lambda: fn(state0, *arrays, lcfg, scan_tau=tau), Tl)
        emit(path, Tl, dt, out.world_T_body.cpu().numpy(), poses[1:],
             n_corr_mean=float(out.n_correspondences.float().mean()))
    sess = LIOSession(lcfg, sp[0], sm[0], poses[0], device=dev)
    sess.state = sess.state._replace(ekf_state=sess.state.ekf_state._replace(v=up(v0)))
    est, spent = [], 0.0
    for k in range(Tl):
        t1 = time.perf_counter()
        r = sess.push(sp[k + 1], sm[k + 1], gyro[k], accel[k], dts[k], gps[k],
                      float(gps_var[k]), True, tau=tp[k + 1])
        spent += time.perf_counter() - t1
        est.append(r.world_T_body)
    emit("phase 6 LIOSession", Tl, spent, np.stack(est), poses[1:])

    # ---- phase 13: bench_kitti's own LIO settings on its fixture and at
    # seq-00 density ----
    with tempfile.TemporaryDirectory() as tmp:
        kitti.make_synthetic_kitti(tmp, n_frames=cs.BENCH_KITTI_FRAMES,
                                   max_points=cs.BENCH_KITTI_POINTS, extent=cs.KITTI_EXTENT)
        seq_a = kitti.load_sequence(tmp, "00")
    with tempfile.TemporaryDirectory() as tmp:
        kitti.make_synthetic_kitti(tmp, n_frames=cs.KITTI_FRAMES, max_points=cs.KITTI_POINTS,
                                   extent=cs.KITTI_EXTENT, points_per_m2=cs.KITTI_DENSITY)
        seq_b = kitti.load_sequence(tmp, "00")
    fixtures = {"a": seq_a, "b": SimpleNamespace(scans=seq_b.scans[:cs.SEQ00_LIO_FRAMES],
                                                 poses=seq_b.poses[:cs.SEQ00_LIO_FRAMES])}
    for fx, seq in fixtures.items():
        cfg0 = cs.bench_kitti_lio_config(seq.scans, cs.WIDE_TILES[0])
        sp, sm, tp, gyro, accel, dts, gps = cs.lio_inputs(seq, cfg0.scan_capacity)
        Tl = len(seq.scans) - 1
        arrays = [up(a) for a in (sp[1:], sm[1:], gyro, accel, dts, gps,
                                  np.full(Tl, 0.5**2, np.float32), np.ones(Tl, bool))]
        tau = up(tp[1:])
        v0 = up(((seq.poses[1, :3, 3] - seq.poses[0, :3, 3]) / 0.1).astype(np.float32))
        rows = cfg0.scan_capacity // cfg0.reg_subsample
        for W in cs.WIDE_TILES:
            if rows % W:
                continue
            cfg = cfg0._replace(p2p=cfg0.p2p._replace(tile_src=W))
            st = lio.init_state(cfg, up(sp[0]), up(sm[0]), up(seq.poses[0].astype(np.float32)))
            st = st._replace(ekf_state=st.ekf_state._replace(v=v0))
            dt, (_, out) = twice(lambda: lio.run_lio_superblocks(st, *arrays, cfg, scan_tau=tau), Tl)
            emit(f"phase 13 ({fx}) run_lio_superblocks at {rows // W} x {W}", Tl, dt,
                 out.world_T_body.cpu().numpy(), seq.poses[1:],
                 pair_overflow=int(out.pair_overflow.sum()))


if __name__ == "__main__":
    main()
