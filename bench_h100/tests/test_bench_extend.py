"""A configuration, a traffic mix and a per-layer metric are added by new
files and new BENCHMARK.json entries alone: the harness finds them by
name."""

from __future__ import annotations

import io

from tiny import make_base, run_tiny, tiny_config

METRIC = '''"""requests_in_window: requests the window completed (a count)."""


def read(ctx):
    return float(len(ctx.window.records))
'''


def test_new_config_mix_and_metric_are_files_only(tmp_path):
    cfg = tiny_config()
    cfg["log"]["max_points"] = 2500  # another configuration of the same system
    metric = {"name": "requests_in_window", "unit": "requests", "better": "higher",
              "source": "program_counter", "layer": "entry", "moves": "loc_scans_per_s"}
    base, bench = make_base(str(tmp_path), config=cfg, per_layer=[metric],
                            extra={"metrics/requests_in_window.py": METRIC})
    rc, res, err = run_tiny(base, bench, trace=1)
    assert rc == 0, err
    assert res["metrics"]["requests_in_window"]["value"] == res["attempted"]
    assert res["correct"], err


def test_no_card_no_result(tmp_path):
    import pytest
    import torch

    import run

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would go ahead")

    base, bench = make_base(str(tmp_path))
    out, err = io.StringIO(), io.StringIO()
    rc = run.main(["--workload", "loc-tiny.replay", "--seed", "1", "--seconds", "1",
                   "--trace", "0"], bench_path=bench, base=base, out=out, err=err)
    assert rc != 0 and out.getvalue() == ""
