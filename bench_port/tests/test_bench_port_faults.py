"""A run on the CPU at a small size, with the timed path sound, broken
underneath, or replaced by the control: ``correct`` comes out true only
for the sound run, and the number that each fault breaks is past its
limit.

The control is the program with its own nearest-neighbour matching
switched on in place of KM: it breaks the configuration's one-to-one
guarantee.  The faults (``bench_port/faults.py``) are those the cells can
have (a one-chip cell has no exchange between chips): a step that returns
its state unchanged, half of the batch left out, an answer altered where
it is produced (a final match, a keypoint), half of the final matching
left out, a wrong one-to-one matching, and a broken suppression in the
keypoint stage."""
import numpy as np
import pytest

import faults
from bench_small import small_run, small_spec
from reference import check


def test_sound_run_is_correct():
    res = small_run(small_spec())
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    for n, c in res["checks"].items():
        assert not check.breaks(n, c["value"], c["limit"])


def test_control_is_not_correct():
    res = small_run(small_spec(engine={"correspondence": "nn"}))
    assert not res["correct"]
    assert res["checks"]["match_broken"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_fault_is_not_correct(fault):
    with faults.planted(fault):
        res = small_run(small_spec())
    assert not res["correct"] and res["failed"] >= 1
    broken = faults.BREAKS[fault]
    c = res["checks"][broken]
    assert check.breaks(broken, c["value"], c["limit"])
    assert np.isfinite(c["value"])
