"""Run one cell of the port's benchmark once and print its result.

    python3 bench_h100/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (BENCHMARK.json's `workloads`) names a configuration
(`configs/<config>.json`, whose `system` is `systems/<system>.py`) and a
traffic mix (`traffic/<mix>.json`, read by `harness/loop.py`); each metric
is read by `metrics/<metric>.py`. Set-up (imports, the kernel library,
the log, the map, staging, start-up, warm-up) is timed from the process's
start to the first timed request. The window then runs for `--seconds`
under the mix; with `--trace 1` under torch.profiler, and the cell's
per-layer metrics are reported instead of its end-to-end ones. After the
window the system's plain reference decides `correct`. The last line of
standard output is one JSON object.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level module names that must not be loaded in the measured process
FORBIDDEN = ("jax", "jaxlib", "flax", "slam_sensor_fusion_tpu")


def process_start() -> float:
    """The process's start on the perf_counter clock (from /proc, to a
    clock tick); the top of this file where /proc is not readable."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return T_IMPORT


T_START = min(process_start(), T_IMPORT)


def set_cache_dirs(root: str) -> None:
    """Every build and kernel cache at a fixed place inside the checkout
    (the port's own library builds into its package's `_build/`)."""
    cache = os.path.join(root, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


class Context:
    """What a metric reader sees: the window, the system, the cell."""

    def __init__(self, cell, system, window, setup_s, device_name):
        self.cell, self.system, self.window = cell, system, window
        self.setup_s, self.device_name = setup_s, device_name
        self.trace = window.trace


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, bench_path=None, base=HERE, root=ROOT, require_chip=True,
         device="cuda", out=None, err=None) -> int:
    """Run the cell; returns the exit code. The keywords let the CPU tests
    drive a run at a tiny size without a card."""
    out, err = out or sys.stdout, err or sys.stderr
    args = parse(argv)
    set_cache_dirs(root)
    sys.path.insert(0, base)
    sys.path.insert(0, root)
    from harness import loop
    from harness.common import Cell, load_json

    bench = load_json(bench_path or os.path.join(root, "BENCHMARK.json"))
    cell = Cell(bench, args.workload, root=root, base=base)

    import torch

    torch.set_num_threads(1)
    if require_chip:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"bench: the cell needs {cell.chips} CUDA device(s), {n} present", file=err)
            return 3
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    device_name = torch.cuda.get_device_name(0) if on_card else "cpu"

    system = cell.system().System(cell.config, cell.traffic, args.seed, dev, log=err)
    win = loop.run(system, cell.traffic, args.seconds, bool(args.trace))
    setup_s = win.t0 - T_START
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    ctx = Context(cell, system, win, setup_s, device_name)
    metrics = {}
    for m in cell.per_layer if args.trace else cell.end_to_end:
        v = cell.metric(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    lat = [r.t_done - r.t_submit for r in win.records]
    if lat:
        fifths = [0] * 5
        for r in win.records:
            fifths[min(int(5 * (r.t_done - win.t0) / (win.t1 - win.t0)), 4)] += 1
        lat.sort()
        print(f"bench: {len(lat)} requests in {win.t1 - win.t0:.3f} s, latency median "
              f"{1e3 * lat[len(lat) // 2]:.3f} ms (n={len(lat)}); set-up {setup_s:.3f} s; "
              f"requests done in each fifth of the window {fifths}", file=err)

    breakdown = None
    dev_info = {"platform": "gpu" if on_card else "cpu", "kind": device_name,
                "count": cell.chips, "memory_peak_bytes": int(peak)}
    if args.trace and win.trace is not None:
        dev_info["busy_s"] = win.trace.busy_s()
        dev_info["window_s"] = win.trace.window_s
        breakdown = {"device_ops": win.trace.top_ops(10), "idle_gaps": win.trace.idle_gaps(10)}
        print(f"bench: trace: {len(win.trace.device)} device operations, "
              f"{win.trace.harness_ops} of them the harness's copies", file=err)

    system.release()
    verdict = system.check(win.records, args.seed)
    found = loaded_forbidden()
    if found:
        print(f"bench: the measured process loaded {found}", file=err)
        return 4
    for name, (value, limit) in verdict["checks"].items():
        print(f"check {name}: {value!r} limit {limit!r}", file=err)
    result = {
        "correct": bool(verdict["correct"]),
        "attempted": len(win.records),
        "failed": int(verdict["failed"]),
        "metrics": metrics,
        "device": dev_info,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in verdict["checks"].items()}
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
