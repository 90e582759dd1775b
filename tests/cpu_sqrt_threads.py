"""Not a test: counts the fresh processes in which a square root on the CPU
gives other bits at torch's default thread count than on one thread.

    PYTHONPATH=. python tests/cpu_sqrt_threads.py [--processes 240] [--parallel 4]

Each process makes the 98 321 seeded acos inputs of
tests/test_torch_xla_math_host.py (uniform in [-1, 1], random bits and
the special values) and, in this order, at torch's default thread count:
the port's `xla_math.acosf` plain version (its `sqrtf`, numpy's sqrt) and
`torch.sqrt` of float64 `|1 - x^2|` (MKL's vector sqrt); then both again
on one thread. It prints how many processes parted in each, and the
largest number of values that parted in one process. NaN matches NaN.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

_CHILD = r"""
import json
import numpy as np
import torch
from slam_sensor_fusion_tpu_torch.ops import xla_math as xm

rng = np.random.default_rng(5)
n = 1 << 16
special = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-39, 1.17e-38, np.inf, -np.inf, np.nan,
                    1.0, -1.0, 0.78539816, 120.0, -120.0, 119.99999, 3.4e38, 2.0**-12], np.float32)
a = rng.uniform(-1.0, 1.0, n)
bits = rng.integers(0, 2**32, n // 2, dtype=np.uint64).astype(np.uint32).view(np.float32)
x = torch.from_numpy(np.concatenate([special, a.astype(np.float32), bits]))
d = ((1 - x) * (1 + x)).abs().to(torch.float64)


def run():
    return xm.acosf(x).view(torch.int32).clone(), torch.sqrt(d).view(torch.int64).clone()


def parted(p, q, dtype):
    nan = p.view(dtype).isnan() & q.view(dtype).isnan()
    return int(((p != q) & ~nan).sum())


many = run()
torch.set_num_threads(1)
one = run()
print(json.dumps({"acosf": parted(many[0], one[0], torch.float32),
                  "torch_sqrt": parted(many[1], one[1], torch.float64)}))
"""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--processes", type=int, default=240)
    ap.add_argument("--parallel", type=int, default=4)
    args = ap.parse_args()
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    env = dict(os.environ, PYTHONPATH=root)

    def child(_):
        out = subprocess.run([sys.executable, "-c", _CHILD], env=env, capture_output=True,
                             text=True, check=True).stdout
        return json.loads(out.strip().splitlines()[-1])

    with ThreadPoolExecutor(args.parallel) as pool:
        runs = list(pool.map(child, range(args.processes)))
    for key in ("acosf", "torch_sqrt"):
        counts = [r[key] for r in runs]
        print(f"{key}: {sum(c > 0 for c in counts)} of {len(counts)} processes parted, "
              f"at most {max(counts)} values in one")


if __name__ == "__main__":
    main()
