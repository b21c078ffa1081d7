"""The readers of the program's spans inside its stages (``wait_s.*``,
``host_s.solve``, ``span_s.keypoints.*``) on made-up pairs, and on pairs
that lack their keys (a program without the spans)."""
import math

import pytest

import run

STAGES = {"downsample": 0.05, "keypoints": 0.2, "features": 0.06,
          "coarse_init": 0.1, "register": 1.0}
SPANS = [
    {"downsample.wait": 0.01, "keypoints.pca": 0.08,
     "keypoints.pca.wait": 0.002, "keypoints.detect": 0.05,
     "keypoints.detect.wait": 0.004, "keypoints.refine": 0.02,
     "keypoints.wait": 0.001, "features.wait": 0.5,
     "register.solve": 0.8, "register.solve.wait": 0.05,
     "register.solve.sweep": 0.3, "register.solve.sweep.wait": 0.01,
     "register.estimate": 0.1, "register.estimate.wait": 0.02,
     "register.final": 0.01, "register.wait": 0.03},
    {"downsample.wait": 0.03, "keypoints.pca": 0.1,
     "keypoints.detect": 0.07, "keypoints.detect.wait": 0.006,
     "keypoints.refine": 0.04, "keypoints.wait": 0.001,
     "register.solve": 0.6, "register.solve.wait": 0.01,
     "register.wait": 0.05},
]


def rec(timings):
    return {"setup_s": 1.0, "window_s": 2.0, "trace": None,
            "pairs": [{"pool": i, "wall_s": 1.5, "iterations": 3,
                       "launches": {}, "timings": t}
                      for i, t in enumerate(timings)]}


EXPECTED = {
    "wait_s.register": ((0.05 + 0.01 + 0.02 + 0.03) + (0.01 + 0.05)) / 2,
    "wait_s.preprocess": ((0.01 + 0.002 + 0.004 + 0.001)
                          + (0.03 + 0.006 + 0.001)) / 2,
    "host_s.solve": ((0.8 - 0.05 - 0.01) + (0.6 - 0.01)) / 2,
    "span_s.keypoints.pca": 0.09,
    "span_s.keypoints.detect": 0.06,
    "span_s.keypoints.refine": 0.03,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_made_up_pairs(name):
    got = run.reader(name)(rec([{**STAGES, **t} for t in SPANS]))
    assert math.isclose(got, EXPECTED[name], rel_tol=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_skips_pairs_without_its_keys(name):
    # one pair from a program without the spans: the mean is the other's
    with_spans = [{**STAGES, **t} for t in SPANS]
    both = run.reader(name)(rec(with_spans + [dict(STAGES)]))
    assert math.isclose(both, EXPECTED[name], rel_tol=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_with_no_span_to_read(name):
    assert run.reader(name)(rec([dict(STAGES), dict(STAGES)])) is None
    assert run.reader(name)(rec([])) is None
