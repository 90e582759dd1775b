"""Readings for the limits of `correct`: the program against the plain
reference, the control (the reference with its point arithmetic in a
lower precision, in the program's place) against the same reference, and
the program with each named fault planted (faults.py), on several seeds
at the cell's own size, in one process.

    python3 bench_h100/control.py --workload loc-kitti00.replay --seeds 11 12 13 \\
        [--control bfloat16] [--faults NAME ...] [--passes 1] [--out FILE]

Each seed prints one JSON line: the program's numbers (one pass of the
log through the timed path), the control's, each fault's, and the seconds
the reference took. No window is timed here.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def program_numbers(cell, seed: int, device, passes: int, log):
    """The system after one or more passes of its log, and the program's
    numbers against the reference."""
    from harness.loop import Record

    system = cell.system().System(cell.config, cell.traffic, seed, device, log=log)
    records = []
    for i in range(passes * system.requests_per_pass):
        ts = time.perf_counter()
        records.append(Record(i, ts, time.perf_counter(), system.request(i)))
    system.release()
    t0 = time.perf_counter()
    got = system.check(records, seed)
    return system, got, time.perf_counter() - t0


def readings(cell, seed: int, device, control: str, passes: int, log, faults_=()) -> dict:
    import torch

    import faults

    t0 = time.perf_counter()
    system, got, ref_s = program_numbers(cell, seed, device, passes, log)
    out = {"seed": seed, "seconds": time.perf_counter() - t0, "reference_s": ref_s,
           "program": got["numbers"], "program_correct": got["correct"]}
    if control:
        ctrl = system.check_control(getattr(torch, control))
        out.update(control=ctrl["numbers"], control_correct=ctrl["correct"])
    for name in faults_:
        with faults.planted(name):
            _, f, _ = program_numbers(cell, seed, device, passes, log)
        out[f"fault.{name}"] = f["numbers"]
        out[f"fault.{name}_correct"] = f["correct"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", default="bfloat16", help="'' for none")
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--passes", type=int, default=1)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.insert(0, ROOT)
    import torch

    from harness.common import Cell, load_json

    cell = Cell(load_json(os.path.join(ROOT, "BENCHMARK.json")), args.workload)
    dev = torch.device("cuda")
    for seed in args.seeds:
        line = json.dumps(readings(cell, seed, dev, args.control, args.passes, sys.stderr,
                                   args.faults))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
