"""Each metric reader on a recorded sample, and with nothing to read."""
import math

import pytest

import devtrace
import run

PAIRS = [
    {"pool": i % 2, "wall_s": w,
     "timings": {"downsample": 0.05, "keypoints": 0.2, "features": 0.06,
                 "coarse_init": 0.1, "register": r},
     "iterations": it,
     "launches": {"fused_benefit": 2, "fused_benefit@2048": 2,
                  "auction_phase_gs": 3, "auction_phase_gs@2048": 3,
                  "auction_warm_fused": it - 2, "nms_exact": 2,
                  "stream_sweep": 9, "stream_sweep_wide": 9,
                  "stream_sweep@2048": 9}}
    for i, (w, r, it) in enumerate([(0.5, 0.05, 3), (0.4, 0.04, 2),
                                    (0.6, 0.07, 4), (0.45, 0.05, 3)])]
TRACE = {"pairs": 2, "busy_s": 0.3, "window_s": 1.2,
         "device_ns_by_op": {
             "void gs_phase_kernel<__nv_bfloat16, 0>(GsParams)": 4_000_000,
             "void cost_kernel<__nv_bfloat16, false, false, true>(P)":
                 1_000_000,
             "void hamw_kernel<2, 12, false, false>(SweepParams)": 500_000,
             "nms_kernel(Params)": 600_000,
             "void at::native::elementwise_kernel<128, 2>()": 9_000_000}}
REC = {"setup_s": 17.5, "window_s": 2.0, "pairs": PAIRS, "trace": TRACE}
EMPTY = {"setup_s": 1.0, "window_s": 0.0, "pairs": [], "trace": None}

EXPECTED = {
    "pairs_per_min": 120.0,
    "pair_p90_s.nms1": 0.6,
    "setup_s": 17.5,
    "stage_s.preprocess": 0.25,
    "stage_s.features": 0.06,
    "stage_s.coarse_init": 0.1,
    "stage_s.register": 0.0525,
    "engine_iters": 3.0,
    "solve_launches.dense": 3.0 + 1.0,
    "solve_launches.stream": 9.0,
    "kernel_ms.auction": 2.5,
    "kernel_ms.stream": 0.25,
    "kernel_ms.nms": 0.3,
    "device_idle_share": 75.0,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_sample(name):
    assert math.isclose(run.reader(name)(REC), EXPECTED[name],
                        rel_tol=1e-12)


@pytest.mark.parametrize("name", sorted(set(EXPECTED) - {"setup_s"}))
def test_reader_with_nothing_to_read(name):
    assert run.reader(name)(EMPTY) is None


def test_p90_is_a_measured_pair_with_ten_beyond():
    rec = dict(REC, pairs=[dict(PAIRS[0], wall_s=float(i))
                           for i in range(1, 101)])
    assert run.reader("pair_p90_s.nms1")(rec) == 90.0


def test_trace_summary_of_intervals():
    ev = {"device": [("k1", 10, 20), ("k2", 15, 30), ("k1", 50, 60)],
          "host": [("bench.slice", 0, 100), ("bench.pair", 1, 99),
                   ("pipeline.keypoints", 30, 55)]}
    s = devtrace.summarize(ev, 0, 100)
    assert s["busy_s"] == 30e-9 and s["window_s"] == 100e-9
    assert s["device_ns_by_op"] == {"k1": 20, "k2": 15}
    idle = dict(s["breakdown"]["idle_gaps"])
    # gaps 0-10 and 60-100 under bench.pair (their middles), 30-50 under
    # the stage
    assert idle == {"bench.pair": 50e-9, "pipeline.keypoints": 20e-9}
    assert s["breakdown"]["device_ops"][0] == ["k1", 20e-9]


def test_card_copies_of_host_ranges_are_not_work():
    assert not devtrace._is_work("", "pipeline.register",
                                 {"pipeline.register"})
    assert not devtrace._is_work("gpu_user_annotation", "x", set())
    assert devtrace._is_work("", "void k()", {"pipeline.register"})
    assert devtrace._is_work("kernel", "void k()", set())
