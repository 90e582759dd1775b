"""The control: the plain reference with its point arithmetic in bfloat16,
in the program's place, must fail the cell's limits, while the program's
own run passes them (the chip's readings at the cell's size are in
PERF.md; this is the same control at a size a test run holds)."""

from __future__ import annotations

import sys

import pytest
import torch
from tiny import TINY_TRAFFIC, make_base

from harness.common import Cell, load_json


@pytest.mark.parametrize("seed", [11, 2**31 + 12, 13])
def test_bfloat16_control_fails_the_limits(tmp_path, seed):
    import control

    base, bench = make_base(str(tmp_path))
    cell = Cell(load_json(bench), "loc-tiny.replay", base=base)
    assert cell.traffic == TINY_TRAFFIC
    r = control.readings(cell, seed, torch.device("cpu"), "bfloat16", 1, sys.stderr)
    assert r["program_correct"], r
    assert not r["control_correct"], r
