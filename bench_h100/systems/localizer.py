"""The map-based localizer as a replay service: segments of a log through
the port's `models.pipeline_fast.run_chunk_fast`, state carried.

Set-up makes the log on the device (gen/sensor.py), builds the site's
prior map from its survey tiles with the port's own
`models.mapping.merge_tiles`, loads it in a `Localizer`
(host subsample, Morton pre-sort), starts up on frame 0 (`init_state`
from the GPS fix, one `coarse_attempt`: brute force, a rescue ICP on a
miss) and stages the other frames with `build_paged_frames` into
segments. A request is one `run_chunk_fast` call on one segment; it ends
when the segment's outputs are on the host. After the last segment the
state goes back to the one kept after start-up and the log replays.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch
from torch.profiler import record_function

from gen import sensor
from harness.trace import COLLECT
from reference import localizer as ref

#: the program's per-frame outputs a request brings back to the host
FIELDS = ("map_T_sensor", "icp_error", "icp_iterations", "n_correspondences", "icp_converged",
          "recropped", "pair_overflow", "slack_violation", "pair_demand")


def localization_config(fields: dict):
    """The port's LocalizationConfig from the configuration file's fields."""
    from slam_sensor_fusion_tpu_torch.utils import config as C

    f = dict(fields)
    nested = {"icp": C.ICPConfig, "rescue_icp": C.ICPConfig, "brute_force": C.BruteForceConfig,
              "filter": C.StochasticFilterConfig, "capacity": C.CloudCapacity}
    for k, cls in nested.items():
        f[k] = cls(**f[k])
    return C.LocalizationConfig(**f)


class System:
    def __init__(self, config: dict, traffic: dict, seed: int, device, log):
        from slam_sensor_fusion_tpu_torch.models import localization as lz
        from slam_sensor_fusion_tpu_torch.models import pipeline_fast as pf
        from slam_sensor_fusion_tpu_torch.models.mapping import MapData, merge_tiles

        self.fields = config["localization"]
        self.limits = config["correct"]
        self.cfg = cfg = localization_config(self.fields)
        self.dev = dev = torch.device(device)
        self.log = log
        self.pf = pf
        site = dict(config["site"], extent=config["world_extent_m"])
        logp = dict(config["log"], frames=config["log_frames"])
        self.lg = lg = sensor.make_log(site, logp, config["assumed"], seed, dev,
                                       cfg.scan_subsample_step)
        tiles = sensor.survey_tiles(lg, logp["map_every"], logp["max_range"])
        self.tiles = tiles
        map_pts = merge_tiles([t.cpu().numpy() for t in tiles], cfg.map_voxel_size)
        self.loc = lz.Localizer(MapData(map_pts, np.eye(4), np.zeros((0, 3))), cfg, dev)
        st = lg.streams
        self.host = {k: getattr(st, k).cpu().numpy() for k in st._fields}
        h = self.host
        T = len(lg.scans)
        scans = [s.deskewed.cpu().numpy() for s in lg.scans]
        sizes = [len(s.deskewed) for s in lg.scans]
        valid = np.ones(T, bool)
        self.valid = valid

        # start-up on frame 0: the GPS fix, then one coarse attempt
        state = lz.init_state(cfg, self.loc.map_cloud.capacity,
                              torch.from_numpy(h["map_T_sensor_gps"][0]).to(dev),
                              torch.from_numpy(h["odom_T_sensor"][0]).to(dev))
        f0 = lz.build_frame_batch(cfg, scans[:1], h["odom_T_sensor"][:1],
                                  h["map_T_sensor_gps"][:1], h["odom_cov_trace"][:1],
                                  h["gps_cov_trace"][:1], valid[:1], dev)
        cmap, cache, ref_T, _, coarse = lz.coarse_attempt(
            state, f0.scan_points[0], f0.scan_mask[0], self.loc.map_cloud,
            f0.map_T_sensor_gps[0], cfg)
        if not bool(coarse.success):
            raise RuntimeError("start-up: the coarse attempt on frame 0 failed")
        self.state0 = state._replace(cropped_map=cmap, cached_target=cache, map_T_ref=ref_T,
                                     map_T_sensor=coarse.map_T_sensor)
        self.startup_pose = coarse.map_T_sensor.cpu().numpy()
        self.truth = lg.poses.cpu().numpy()

        seg = int(traffic["segment_frames"])
        if (T - 1) % seg or seg % cfg.superstep:
            raise ValueError(f"{T - 1} replayed frames in segments of {seg}, superblocks of "
                             f"{cfg.superstep}")
        self.seg = seg
        self.segments = []
        for a in range(1, T, seg):
            b = a + seg
            self.segments.append(pf.build_paged_frames(
                cfg, scans[a:b], h["odom_T_sensor"][a:b], h["map_T_sensor_gps"][a:b],
                h["odom_cov_trace"][a:b], h["gps_cov_trace"][a:b], valid[a:b], dev))
        self.requests_per_pass = len(self.segments)
        self.state = self.state0
        self.out_bufs = None  # the outputs' page-locked host buffers
        print(f"localizer: {T} frames, {min(sizes)}-{max(sizes)} points a scan, map "
              f"{len(map_pts)} points, {self.requests_per_pass} segments of {seg}", file=log)

    # ---- the loop's interface ----

    def request(self, i: int) -> dict:
        """One segment through the program; its outputs as the program made
        them, each copied once into a page-locked buffer made on the first
        request (the copies are the harness's: the trace leaves them out of
        the program's operations)."""
        j = i % self.requests_per_pass
        if j == 0:
            self.state = self.state0
        self.state, out = self.pf.run_chunk_fast(self.state, self.segments[j],
                                                 self.loc.map_cloud, self.cfg)
        with record_function(COLLECT):
            if self.out_bufs is None:
                self.out_bufs = {f: torch.empty_like(getattr(out, f), device="cpu",
                                                     pin_memory=self.dev.type == "cuda")
                                 for f in FIELDS}
            for f in FIELDS:
                self.out_bufs[f].copy_(getattr(out, f), non_blocking=True)
            self.sync()
        return {f: t.numpy().copy() for f, t in self.out_bufs.items()}

    def counters(self) -> dict:
        from slam_sensor_fusion_tpu_torch.utils.profiling import kernel_launches

        return kernel_launches()

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def frames(self, result: dict) -> int:
        """Scans a request completed."""
        return int(result["map_T_sensor"].shape[0])

    def pair_demand(self, result: dict) -> np.ndarray:
        """Admissible tile pairs of each frame of a request (0 on invalid)."""
        return result["pair_demand"]

    def shapes(self) -> dict:
        """K1's launch shapes, for the metric arithmetic."""
        c = self.cfg
        nSt = c.capacity.cropped_scan // c.icp.tile_src
        return {"K": c.superstep, "n_src_tiles": nSt, "tile_src": c.icp.tile_src,
                "n_tgt_tiles": c.capacity.cropped_map // c.icp.tile_tgt,
                "tile_tgt": c.icp.tile_tgt, "max_pairs": nSt * c.icp.max_pairs_factor,
                "queue": c.filter.queue_size}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.segments = self.state = self.state0 = self.loc = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ---- correctness ----

    def reference_inputs(self) -> ref.Inputs:
        h = self.host
        return ref.Inputs(
            tiles=self.tiles, scans=[s.deskewed for s in self.lg.scans[1:]],
            odom=h["odom_T_sensor"], gps=h["map_T_sensor_gps"], odom_tr=h["odom_cov_trace"],
            gps_tr=h["gps_cov_trace"], valid=self.valid, startup_pose=self.startup_pose,
            scan0=self.lg.scans[0].deskewed)

    def check(self, records, seed: int) -> dict:
        """A sample of the window's requests, drawn from the seed, against
        the reference following the program step by step; the start-up
        pose against the reference's own start-up."""
        inp, cfg = self.reference_inputs(), dataclasses.asdict(self.cfg)
        self.mp = ref.prepared_map(inp.tiles, cfg)
        ok, self.start_ref = ref.startup(inp.scan0, self.mp, inp.gps[0], cfg)
        if not ok:
            self.start_ref = np.full((4, 4), np.inf, np.float32)
        return self.compare(records, seed)

    def check_control(self, dtype) -> dict:
        """The control in the program's place: the reference with its point
        arithmetic in `dtype`, running free over one pass of the log,
        checked as the program is (after `check`)."""
        from harness.loop import Record

        got = pack(ref.run(self.reference_inputs(), dataclasses.asdict(self.cfg),
                           point_dtype=dtype, mp=self.mp))
        seg = self.seg
        recs = [Record(j, 0.0, 0.0, {k: v[j * seg:(j + 1) * seg] for k, v in got.items()})
                for j in range(self.requests_per_pass)]
        return self.compare(recs, 0)

    def compare(self, records, seed: int) -> dict:
        """Each number is the worst over the sampled requests: two of each
        segment, drawn from the seed. A request with a pair overflow or a
        slack violation failed (all of the window's are read)."""
        inp, cfg = self.reference_inputs(), dataclasses.asdict(self.cfg)
        per, seg = self.requests_per_pass, self.seg
        rng = np.random.default_rng(seed)
        picked = []
        for j in range(per):
            mine = [r for r in records if r.index % per == j]
            picked += [mine[i] for i in sorted(rng.choice(len(mine), min(2, len(mine)),
                                                          replace=False))] if mine else []
        by_index = {r.index: r for r in records}
        worst: dict = {}
        for r in picked:
            j = r.index % per
            T = 1 + (j + 1) * seg
            poses = np.zeros((T, 4, 4), np.float32)
            iters = np.zeros(T, np.int64)
            for q in range(r.index - j, r.index + 1):
                u = by_index[q].result
                a = 1 + (q % per) * seg
                poses[a:a + seg], iters[a:a + seg] = u["map_T_sensor"], u["icp_iterations"]
            want = ref.run(inp, cfg, mp=self.mp, follow=(poses, iters),
                           frames=range(1 + j * seg, T))
            got = r.result
            for k, v in gaps(got, want).items():
                worst[k] = max(worst.get(k, 0.0), v)
            err = np.linalg.norm(got["map_T_sensor"][:, :3, 3] - self.truth[1 + j * seg:T, :3, 3],
                                 axis=1)
            worst["program_ate_m"] = max(worst.get("program_ate_m", 0.0),
                                         float(np.sqrt(np.mean(err ** 2))))
        failed = [int((r.result["pair_overflow"] | r.result["slack_violation"]).sum())
                  for r in records]
        worst["failed_frames"] = float(sum(failed))
        worst["startup_gap_m"] = float(np.linalg.norm(self.startup_pose[:3, 3]
                                                      - self.start_ref[:3, 3]))
        checks = {k: (worst[k], self.limits[k]) for k in self.limits if k in worst}
        for k in sorted(set(worst) - set(checks)):
            print(f"number {k}: {worst[k]!r} (not compared)", file=sys.stderr)
        correct = bool(records) and all(v <= lim for v, lim in checks.values())
        return {"correct": correct, "failed": sum(f > 0 for f in failed), "checks": checks,
                "numbers": worst}


def pack(frames: ref.Frames) -> dict:
    """Reference frames as a request's outputs (no overflow, no demand)."""
    n = frames.pose.shape[0]
    return {"map_T_sensor": frames.pose.astype(np.float32), "icp_error": frames.icp_error,
            "icp_iterations": frames.iterations, "n_correspondences": frames.n_corr,
            "icp_converged": frames.converged, "recropped": frames.recropped,
            "pair_overflow": np.zeros(n, bool), "slack_violation": frames.slack_violation,
            "pair_demand": np.zeros(n, np.int32)}


def gaps(got: dict, want: ref.Frames) -> dict:
    """The distances between one request's outputs and the reference's."""
    P, Q = got["map_T_sensor"], want.pose
    dt = np.linalg.norm(P[:, :3, 3] - Q[:, :3, 3], axis=1)
    dR = np.abs(P[:, :3, :3].astype(np.float64) - Q[:, :3, :3]).max(axis=(1, 2))
    n_ref = np.maximum(want.n_corr, 1)
    flags = (got["icp_converged"] != want.converged) | (got["recropped"] != want.recropped) \
        | (got["slack_violation"] != want.slack_violation)
    return {
        "pose_gap_m": float(dt.max()),
        "rot_gap": float(dR.max()),
        "ncorr_gap": float((np.abs(got["n_correspondences"] - want.n_corr) / n_ref).max()),
        "flip_margin_m": float(np.max(want.margin)),
        "iteration_flips": float((got["icp_iterations"] != want.iterations).sum()),
        "flag_mismatches": float(flags.sum()),
    }
