"""A tiny cell for the CPU tests: the loc-kitti00 configuration cut to a
small world and short scans, run through the same harness on the CPU
(the port's plain versions stand in for its kernels)."""

from __future__ import annotations

import copy
import io
import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
for p in (ROOT, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny_config() -> dict:
    with open(os.path.join(HERE, "configs", "loc-kitti00.json")) as f:
        c = json.load(f)
    c = copy.deepcopy(c)
    c["name"] = "loc-tiny"
    c["world_extent_m"] = 30.0
    c["log_frames"] = 17
    c["site"].update(n_buildings=10, n_poles=20, points_per_m2=12.0, radius_div=4.7)
    c["log"].update(max_points=3000, max_range=15.0, speed_per_frame=0.15, map_every=4)
    c["assumed"].update(gps_noise_m=0.3)
    loc = c["localization"]
    loc["icp"].update(tile_src=512, tile_tgt=128, max_visits=64, max_pairs_factor=64)
    loc["rescue_icp"].update(num_iterations=10)
    loc["brute_force"].update(x_range=0.2, y_range=0.2, z_range=0.05, yaw_range=0.1,
                              yaw_step=0.1)
    loc["capacity"].update(scan=2048, cropped_scan=2048, cropped_map=8192, map=65536,
                           bf_source=256, bf_target=1024)
    return c


def tiny_bench(config_file: str, traffic: str = "replay-tiny", metrics=()) -> dict:
    """A BENCHMARK.json for the tiny cell."""
    e2e = [{"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
            "source": "host_clock"},
           {"name": "loc_scans_per_s", "unit": "scans/s", "better": "higher", "bound": 0.25,
            "source": "host_clock"}]
    return {
        "command": ["python3", "bench_h100/run.py"], "paths": ["bench_h100"], "run_seconds": 1,
        "configs": [{"name": "loc-tiny", "source": "test", "file": config_file, "reduced": [],
                     "why": "test"}],
        "workloads": [{"name": "loc-tiny.replay", "config": "loc-tiny", "traffic": traffic,
                       "chips": 1, "why": "test"}],
        "end_to_end": e2e,
        "per_layer": [dict(m) for m in metrics],
    }


TINY_TRAFFIC = {"loop": "closed", "clients": 1, "segment_frames": 8, "warmup_passes": 1}


def make_base(tmp: str, config: dict | None = None, per_layer=(), extra=None) -> tuple[str, str]:
    """A copy of the harness under `tmp` with the tiny cell's mix, its
    configuration and a BENCHMARK.json naming them; `extra` maps relative
    paths to file contents dropped in beside. Returns (base, bench path)."""
    base = os.path.join(tmp, "bench")
    shutil.copytree(HERE, base, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(base, "traffic", "replay-tiny.json"), "w") as f:
        json.dump(TINY_TRAFFIC, f)
    cfg_path = os.path.join(base, "configs", "loc-tiny.json")
    with open(cfg_path, "w") as f:
        json.dump(config or tiny_config(), f)
    for rel, text in (extra or {}).items():
        with open(os.path.join(base, rel), "w") as f:
            f.write(text)
    bench = tiny_bench(cfg_path, metrics=per_layer)
    path = os.path.join(tmp, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(bench, f)
    return base, path


def run_tiny(base: str, bench: str, seed: int = 7, trace: int = 0) -> tuple[int, dict | None, str]:
    """One run of the tiny cell on the CPU: (exit code, result, stderr)."""
    import run

    out, err = io.StringIO(), io.StringIO()
    rc = run.main(["--workload", "loc-tiny.replay", "--seed", str(seed), "--seconds", "0.5",
                   "--trace", str(trace)], bench_path=bench, base=base, root=ROOT,
                   require_chip=False, device="cpu", out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
