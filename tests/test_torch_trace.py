"""The spans of ``register_pair`` (``ghicp_tpu_torch.core.trace``): the
keys of ``RegistrationOutput.timings`` on the dense and the streaming
lanes, their nesting, no profiler range entered while no profiler runs,
and under ``torch.profiler`` the ranges ``pipeline.<path>`` of the stages
and their parts, each part inside its stage's range."""
import dataclasses

import numpy as np
import pytest
import torch

from ghicp_tpu_torch.core import trace
from ghicp_tpu_torch.core.config import GHICPConfig
from ghicp_tpu_torch.io.synthetic import structured_scene
from ghicp_tpu_torch.registration.pipeline import register_pair

torch.set_num_threads(1)

STAGES = {"downsample", "keypoints", "features", "coarse_init", "register"}
# every path either lane runs on this pair: the stages' reads and closing
# synchronisations, the keypoint and feature sub-stages, the engine's
# solve, estimate and final matching
COMMON = STAGES | {
    "downsample.wait", "keypoints.pca", "keypoints.pca.wait",
    "keypoints.detect", "keypoints.detect.wait", "keypoints.slots",
    "keypoints.refine", "keypoints.refine.wait", "keypoints.wait",
    "features.describe", "features.fd", "features.wait", "coarse_init.wait",
    "register.solve", "register.solve.wait", "register.estimate",
    "register.estimate.wait", "register.final", "register.final.wait",
    "register.wait"}
# the streaming solve's sweeps, its compaction of the open rows (forced by
# a 64-row open block) and its bidding rounds
STREAM = COMMON | {"register.solve.sweep", "register.solve.compact",
                   "register.solve.resolve"}


def _pair():
    pts = structured_scene(np.random.default_rng(2), 2000, extent=8.0)
    th = np.deg2rad(12.0)
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]], np.float32)
    t = np.float32([0.6, -0.4, 0.1])
    src = ((pts - t) @ R).astype(np.float32)
    cfg = GHICPConfig(voxel_size=0.2, neighborhood_radius=0.6,
                      non_max_radius=1.0, min_neighbors=8,
                      estimated_overlap=0.9, max_iterations=20,
                      ransac_hypotheses=1024, pca_cell_cap=16)
    return src, pts, cfg


@pytest.fixture(scope="module")
def runs():
    """Each lane's registration, with ``record_function`` counted."""
    src, tgt, cfg = _pair()
    entered = []

    def counted(*args, **kwargs):
        entered.append(args)
        return real(*args, **kwargs)
    real = torch.profiler.record_function
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", counted)
        mp.setattr(torch.autograd.profiler, "record_function", counted)
        out["dense"] = register_pair(src, tgt, cfg, device="cpu")
        out["stream"] = register_pair(
            src, tgt, dataclasses.replace(cfg, streaming_cost="on",
                                          stream_open_cap=64),
            keypoint_capacity=256, device="cpu")
    return out, entered


@pytest.mark.parametrize("lane,keys", [("dense", COMMON),
                                       ("stream", STREAM)])
def test_timings_hold_the_stages_and_the_lanes_spans(runs, lane, keys):
    out = runs[0][lane]
    assert out.streaming == (lane == "stream")
    assert set(out.timings) == keys


@pytest.mark.parametrize("lane", ["dense", "stream"])
def test_children_sum_to_no_more_than_their_parent(runs, lane):
    t = runs[0][lane].timings
    assert all(v >= 0.0 for v in t.values())
    for key, v in t.items():
        kids = [w for k, w in t.items()
                if k.startswith(key + ".") and "." not in k[len(key) + 1:]]
        assert sum(kids) <= v + 1e-3, (key, v, kids)


def test_no_range_is_entered_without_a_profiler(runs):
    assert runs[1] == []


def test_spans_are_profiler_ranges_inside_their_stage():
    src, tgt, cfg = _pair()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = register_pair(src, tgt, cfg, device="cpu")
    ranges = {}
    # the raw events (parsing them into PyTorch's event tree takes longer
    # than the registration)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(trace.PREFIX):
            ranges.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    # the stages and their parts, not the deeper spans
    assert set(ranges) == {trace.PREFIX + k for k in out.timings
                           if k.count(".") < trace.RANGE_DEPTH}
    for child, stage in (("register.solve", "register"),
                         ("keypoints.detect", "keypoints")):
        (a, b), = ranges[trace.PREFIX + stage]
        spans = ranges[trace.PREFIX + child]
        assert len(spans) >= 1
        assert all(a <= s and e <= b for s, e in spans), (child, spans)


def test_a_span_records_only_inside_a_record():
    with trace.span("x"), trace.wait():
        pass
    got = {}
    with trace.record(got):
        for _ in range(2):
            with trace.span("x"):
                assert trace.read(int, torch.tensor(3)) == 3
    assert set(got) == {"x", "x.wait"}
    assert got["x"] >= got["x.wait"] >= 0.0
