"""A run with the timed path broken underneath (the look for a card
skipped, the rest of the run as it is) must come out not correct: once for
each fault the localizer cell can have (faults.py). The cell runs on one
card, so it has no exchange between chips to leave out."""

from __future__ import annotations

import pytest
from tiny import make_base, run_tiny

import faults


@pytest.mark.parametrize("name", sorted(faults.FAULTS))
def test_fault_is_not_correct(tmp_path, name):
    base, bench = make_base(str(tmp_path))
    with faults.planted(name):
        rc, res, err = run_tiny(base, bench, seed=2**31 + 5)
    assert rc == 0, err
    assert not res["correct"], err
