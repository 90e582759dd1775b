"""What the benchmark loads: nothing of JAX or of the JAX package in the
measured process, and nothing of the program in the plain reference. Each
check runs in a fresh interpreter and compares whole top-level names."""

from __future__ import annotations

import json
import subprocess
import sys

from tiny import HERE, ROOT

JAX = {"jax", "jaxlib", "flax", "slam_sensor_fusion_tpu"}
PORT = "slam_sensor_fusion_tpu_torch"

HARNESS = f"""
import json, os, sys
sys.path[:0] = [{ROOT!r}, {HERE!r}]
import run
from harness import common, kernels, loop, roofline, trace
bench = common.load_json(os.path.join({ROOT!r}, "BENCHMARK.json"))
for c in bench["configs"]:
    cfg = common.load_json(os.path.join({ROOT!r}, c["file"]))
    common.load_module(os.path.join({HERE!r}, "systems", cfg["system"] + ".py"))
for w in bench["workloads"]:
    common.load_json(os.path.join({HERE!r}, "traffic", w["traffic"] + ".json"))
for m in bench["end_to_end"] + bench["per_layer"]:
    common.load_module(os.path.join({HERE!r}, "metrics", m["name"] + ".py"))
# the program the systems drive
import slam_sensor_fusion_tpu_torch.models.localization
import slam_sensor_fusion_tpu_torch.models.mapping
import slam_sensor_fusion_tpu_torch.models.pipeline_fast
import slam_sensor_fusion_tpu_torch.utils.config
import slam_sensor_fusion_tpu_torch.utils.profiling
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""

REFERENCE = f"""
import json, sys
sys.path[:0] = [{HERE!r}]
import reference.localizer
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _top_level(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = _top_level(HARNESS)
    assert PORT in names and "torch" in names
    assert not names & JAX, names & JAX


def test_reference_loads_nothing_of_the_program():
    names = _top_level(REFERENCE)
    assert "torch" in names
    assert not names & (JAX | {PORT}), names & (JAX | {PORT})
