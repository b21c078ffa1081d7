"""chip_smoke.py rehearsed on the CPU: its kernel-comparison phase runs at a
small size with the plain versions on both sides (the card's CUDA events
replaced by host clocks), and without a card the script exits non-zero
before printing a result."""
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import chip_smoke

torch.set_num_threads(1)


class _HostEvent:
    def __init__(self, enable_timing=True):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def test_compare_phase_at_small_size(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "REPS", 1)
    rows = chip_smoke.compare_kernels(
        torch, seed=7, size=512, device="cpu", stream_rows=512,
        stream_cols=384, compact_rows=128,
        top2_shapes=((2, 128, 256, "bfloat16"), (1, 64, 96, "float32")))
    assert [r["name"] for r in rows] == ["fused_benefit", "auction_phase_gs",
                                         "auction_warm_fused",
                                         "fused_benefit_mult",
                                         "auction_warm_fused_mult",
                                         "nms_exact", "stream_sweep",
                                         "top2_rows", "stream_sweep_mult",
                                         "stream_sweep_col",
                                         "stream_sweep_mult_col",
                                         "stream_sweep_none",
                                         "stream_sweep_none_col",
                                         "fused_benefit_f32",
                                         "auction_phase_gs_f32",
                                         "auction_warm_fused_f32",
                                         "auction_rounds",
                                         "auction_rounds_f32",
                                         "auction_phase"]
    jacobi = ("auction_rounds", "auction_rounds_f32", "auction_phase")
    assert set(jacobi) == chip_smoke.OFF_PATH
    for r in rows:
        assert r["max_abs_err"] == 0.0
        assert r["bound_ms"] > 0
        if r["name"] in jacobi:
            # the open rows of each round decide: bytes or operations
            assert r["bound_by"] in ("bytes", "operations")
            continue
        assert r["bound_by"] == ("operations" if r["name"] in (
            "nms_exact", "stream_sweep", "stream_sweep_col",
            "stream_sweep_none", "stream_sweep_none_col") else "bytes")
        if r["name"] == "top2_rows":
            assert r["library_ms"] > 0
        else:
            assert r["library_ms"] is None


def test_close_pairs_counts_each_pair_once():
    pts = np.float32([[0, 0, 0], [0.5, 0, 0], [3, 0, 0], [3, 0.9, 0]])
    assert chip_smoke.close_pairs(torch, pts, 1.0) == 2
    assert chip_smoke.close_pairs(torch, pts, 0.5, chunk=1) == 0


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run for real")
    root = pathlib.Path(chip_smoke.__file__).resolve().parent
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _record():
    d = np.load(chip_smoke.ENGINE_RECORD)
    seen = {k: d[k].copy() for k in ("kp_s", "mask_s", "kp_t", "mask_t",
                                      "bbx", "init_transform", "it_shift")}
    return seen, d["transform"]


@pytest.mark.parametrize("case", ["dense", "moved keypoint", "other lane",
                                  "other seed"])
def test_none_km_record_check(case):
    """Phase 8's hold of a none + KM run to the JAX package's pose: the
    record's own inputs and card pose pass on the dense lane; a moved
    valid keypoint fails as a stale record, the dense pose fails against
    the streaming lane's JAX pose, and another seed is not held."""
    seen, T_card = _record()
    lane, seed = "dense", chip_smoke.RECORD_SEED
    if case in ("moved keypoint", "other seed"):
        seen["kp_s"][int(np.flatnonzero(seen["mask_s"])[-1])] += 1e-3
    if case == "other lane":
        lane = "streaming"
    if case == "other seed":
        seed += 1
    if case in ("dense", "other seed"):
        chip_smoke.hold_to_jax_record(case, lane, seen, T_card, seed)
        return
    with pytest.raises(SystemExit) as e:
        chip_smoke.hold_to_jax_record(case, lane, seen, T_card, seed)
    want = "differ from" if case == "moved keypoint" else "streaming pose"
    assert want in str(e.value)


def test_engine_inputs_records_the_engine_call():
    import dataclasses

    import ghicp_tpu_torch.registration.pipeline as tpl
    from ghicp_tpu_torch.core.config import (CorrespondenceType,
                                             FeatureType, GHICPConfig)
    rng = np.random.default_rng(3)
    kp = rng.uniform(0, 5, (64, 3)).astype(np.float32)
    m = np.ones(64, bool)
    cfg = dataclasses.replace(GHICPConfig(), feature=FeatureType.NONE,
                              correspondence=CorrespondenceType.NN,
                              max_iterations=2)
    engine, seen = tpl.ghicp_register_chunked, {}
    with chip_smoke.engine_inputs(torch, seen):
        assert tpl.ghicp_register_chunked is not engine
        tpl.ghicp_register_chunked(kp, m, kp + 0.01, m,
                                   np.zeros((64, 64), np.float32), 7.5, cfg,
                                   it_shift=2.0, device="cpu")
    assert tpl.ghicp_register_chunked is engine
    np.testing.assert_array_equal(seen["kp_s"], kp)
    np.testing.assert_array_equal(seen["kp_t"], kp + 0.01)
    np.testing.assert_array_equal(seen["init_transform"], np.eye(4))
    assert seen["bbx"] == np.float32(7.5) and seen["it_shift"] == 2.0


def test_compare_nms_times_each_bucket(monkeypatch):
    """Phase 2 holds K4 on each bucket it is given (the verdict pair's and
    config 6's on the card) and keeps every bucket's times and bound under
    its slots; the kernels-line row is the first bucket's."""
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "REPS", 1)
    rng = np.random.default_rng(5)

    def bucket(n, extent):
        t = torch.from_numpy
        return (t(rng.uniform(0, extent, (n, 3)).astype(np.float32)),
                t(rng.random(n).astype(np.float32)), t(rng.random(n) < 0.8),
                1.0)

    row = chip_smoke.compare_nms(torch, rng, torch.device("cpu"),
                                 (bucket(512, 6.0), bucket(1024, 9.0)))
    assert row["name"] == "nms_exact" and row["max_abs_err"] == 0.0
    for k in ("ms_by_rows", "plain_ms_by_rows", "bound_ms_by_rows"):
        assert sorted(row[k]) == [512, 1024]
        assert all(v > 0 for v in row[k].values())
    assert row["ms"] == row["ms_by_rows"][512]
    assert row["bound_ms"] == row["bound_ms_by_rows"][512]


def test_config_helpers_are_the_bench_settings():
    """``bench_config`` / ``config6`` are the settings phases 2-9 run the
    bench pair and config 6 at (bench_configs.py config 6: 51,200 slots,
    NMS 0.155 m, the streaming lane)."""
    b, c6 = chip_smoke.bench_config(), chip_smoke.config6()
    assert b.non_max_radius == 0.5 and b.pca_max_cells == 65536
    assert c6.keypoint_capacity == 51200 and c6.non_max_radius == 0.155
    assert c6.streaming_cost == "on" and c6.pca_max_cells == 262144
    assert chip_smoke.CONFIG6_CUT_SLOTS < c6.keypoint_capacity


def test_save_engine_record_round_trips(tmp_path):
    """``--save-engine-inputs`` writes each record through one writer: the
    engine inputs, the truth, the run's pose and iterations, and the config
    as ``config_to_dict`` JSON, which ``config_from_dict`` reads back."""
    import dataclasses
    import json
    import types

    from ghicp_tpu_torch.core.config import (CorrespondenceType,
                                             FeatureType)
    from ghicp_tpu_torch.interop import config_from_dict
    cfg = dataclasses.replace(chip_smoke.config6(), feature=FeatureType.NONE,
                              correspondence=CorrespondenceType.NNR,
                              keypoint_capacity=chip_smoke.CONFIG6_CUT_SLOTS,
                              non_max_radius=chip_smoke.CONFIG6_CUT_NMS)
    seen = dict(kp_s=np.ones((8, 3), np.float32), mask_s=np.ones(8, bool),
                bbx=np.float32(3.0), init_transform=np.eye(4, dtype=np.float32))
    T = torch.eye(4)
    T[0, 3] = 0.25
    out = types.SimpleNamespace(transform=T,
                                result=types.SimpleNamespace(iterations=30))
    chip_smoke.save_engine_record(torch, str(tmp_path / "records"), "r.npz",
                                  seen, np.eye(4), out, cfg)
    d = np.load(tmp_path / "records" / "r.npz")
    for k, v in seen.items():
        np.testing.assert_array_equal(d[k], v)
    np.testing.assert_array_equal(d["transform"], T.numpy())
    np.testing.assert_array_equal(d["T_gt"], np.eye(4, dtype=np.float32))
    assert int(d["iterations"]) == 30
    assert config_from_dict(json.loads(str(d["config"]))) == cfg
