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
        top2_shapes=((2, 128, 256, "bfloat16"), (1, 64, 96, "float32")),
        big=768, no_table=512, huge=1024, wide_sizes=(384, 256),
        wide_variants=(12, 6), jacobi_many=(128, 256))
    assert [r["name"] for r in rows] == ["fused_benefit",
                                         "fused_benefit_mult",
                                         "fused_benefit_f32",
                                         "fused_benefit_mult_f32",
                                         "auction_phase_gs",
                                         "auction_phase_gs_f32",
                                         "auction_warm_fused",
                                         "auction_warm_fused_mult",
                                         "auction_warm_fused_f32",
                                         "auction_warm_fused_mult_f32",
                                         "nms_exact", "stream_sweep",
                                         "top2_rows", "stream_sweep_mult",
                                         "stream_sweep_col",
                                         "stream_sweep_mult_col",
                                         "stream_sweep_none",
                                         "stream_sweep_none_col",
                                         "auction_rounds",
                                         "auction_rounds_f32",
                                         "auction_phase",
                                         "auction_phase_f32",
                                         "stream_sweep_wide",
                                         "stream_sweep_wide_col"]
    jacobi = ("auction_rounds", "auction_rounds_f32", "auction_phase",
              "auction_phase_f32")
    assert set(jacobi) == chip_smoke.OFF_PATH
    for r in rows:
        assert r["max_abs_err"] == 0.0
        assert r["bound_ms"] > 0
        if r["name"] in jacobi:
            # the open rows of each round decide: bytes or operations; K1's
            # benefits, the many-round matrix and a warm state, each timed
            # as a call and as the kernel alone, with its rounds
            assert r["bound_by"] in ("bytes", "operations")
            assert [c["input"] for c in r["cases"]] == ["(a)", "(b)",
                                                        "(warm)"]
            assert all(c["ms"] > 0 and c["kernel_ms"] > 0
                       and c["bound_ms"] > 0 and c["rounds"] >= 1
                       for c in r["cases"])
            assert r["plain_ms"] > 0 and r["kernel_ms"] > 0
            assert r["cases"][1]["held_rounds"] == (
                chip_smoke.JACOBI_MANY_HELD)
            continue
        # K3-mult at this size: the 132 blocks' FD factor tables outweigh
        # the FD's bytes, so operations bound it; K5-mult's pairs count
        # __fsqrt_rn, expf and logf by their SASS instructions
        assert r["bound_by"] == ("operations" if r["name"] in (
            "nms_exact", "stream_sweep", "stream_sweep_col",
            "stream_sweep_wide", "stream_sweep_wide_col",
            "stream_sweep_none", "stream_sweep_none_col",
            "stream_sweep_mult", "stream_sweep_mult_col",
            "auction_warm_fused_mult") else "bytes")
        if r["name"].startswith(("fused_benefit", "auction_phase_gs")):
            # K1 at both sizes; K2 cold and warm at both, the larger in
            # its own replica form and the all-global one
            assert r["route"] == "cuda" and r["kernel_ms"] > 0
            want = ([512, 768] if r["name"].startswith("fused") else
                    [(512, 0), (512, 0), (768, 0), (768, 0), (768, 2),
                     (768, 2)])
            if r["name"] == "auction_phase_gs":
                # past 1024 row tiles on the card (36,864^2), cold and warm
                want += [(1024, 0), (1024, 0)]
            got = [c["S"] if r["name"].startswith("fused") else
                   (c["S"], c["form"]) for c in r["cases"]]
            assert got == want
        if r["name"] in ("stream_sweep_mult", "stream_sweep_col",
                         "stream_sweep_mult_col", "stream_sweep_wide",
                         "stream_sweep_wide_col", "fused_benefit",
                         "fused_benefit_mult", "fused_benefit_f32",
                         "fused_benefit_mult_f32", "auction_phase_gs",
                         "auction_phase_gs_f32"):
            # each case timed as a call and as the kernel alone
            assert r["cases"] and all(
                c["ms"] > 0 and c["kernel_ms"] > 0 and c["bound_ms"] > 0
                for c in r["cases"])
        if r["name"] == "stream_sweep_mult":
            assert [c["D"] for c in r["cases"]] == [33, 135, 33, 33]
            assert sorted(r["ms_by_rows"]) == [128, 384, 512]
            assert min(r["ms_no_stats"], r["compact_ms"],
                       r["kernel_ms"]) > 0
        if r["name"].startswith("auction_warm_fused"):
            # the call and the kernel alone, at the engine budget and 16
            assert min(r["kernel_ms"], r["budget16_ms"],
                       r["budget16_kernel_ms"]) > 0
            assert r["budget16_bound_ms"] >= r["bound_ms"]
        if r["name"] == "auction_warm_fused":
            # past the shared-memory replica (on the card 24,576^2 in its
            # own form and forced into form 2, and 36,864^2)
            assert [(c["S"], c["form"]) for c in r["cases"]] == [
                (768, 0), (768, 2), (1024, 0)]
            assert all(c["kernel_ms"] > 0 and c["bound_ms"] > 0
                       for c in r["cases"])
        if r["name"] in ("stream_sweep_wide", "stream_sweep_wide_col"):
            # past four variants (hamw_kernel): V = 12 and 6 at two sizes
            # and on a compacted block of the second, the column side at
            # V = 12 at the first, and every other instantiation's width
            # (V = 3, 5, 16, 20, 28) on the block, with the column side
            more = [(v, 128, 256) for v in (3, 5, 16, 20, 28)]
            wide = [(c["V"], c["rows"], c["cols"]) for c in r["cases"]]
            assert wide == ([(12, 384, 384), (12, 256, 256), (12, 128, 256),
                             (6, 384, 384), (6, 256, 256), (6, 128, 256)]
                            + more if r["name"] == "stream_sweep_wide"
                            else [(12, 384, 384)] + more)
            assert r["ms"] == r["cases"][0]["ms"]
        if r["name"] == "auction_warm_fused_mult":
            # the bf16 mult form without its table (on the card at
            # 20,480 slots), then past the shared-memory replica as K3
            case, *forms = r["cases"]
            assert not case["table"] and case["kernel_ms"] > 0
            assert [(c["S"], c["form"], c["mult"]) for c in forms] == [
                (768, 0, True), (768, 2, True), (1024, 0, True)]
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


def _calls(file: str, func: str, callee: str) -> list:
    """The keyword arguments (literals; an enum by its member's name) of
    each ``callee(...)`` call inside ``file::func``, read from its source
    (``bench_configs.py`` imports JAX)."""
    import ast
    root = pathlib.Path(chip_smoke.__file__).resolve().parent
    tree = ast.parse((root / file).read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == func)
    out = []
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == callee):
            kw = {}
            for k in node.keywords:
                try:
                    kw[k.arg] = ast.literal_eval(k.value)
                except ValueError:
                    kw[k.arg] = k.value.attr
            out.append(kw)
    return out


@pytest.mark.parametrize("which", ["config4", "config7"])
def test_option_configs_are_the_bench_settings(which):
    """Phase 11 writes out bench_configs.py's configs 4 and 7 (which import
    JAX): every setting of their GHICPConfig, and config 7's scan pair
    arguments."""
    import dataclasses
    (want,) = _calls("bench_configs.py", which, "GHICPConfig")
    got = dataclasses.asdict(getattr(chip_smoke, which)())
    for k, v in want.items():
        g = got[k]
        assert (g.name if hasattr(g, "name") else g) == v, k
    if which == "config7":
        assert (_calls("chip_smoke.py", "config7_pair", "make_tls_scan_pair")
                == _calls("bench_configs.py", which, "make_tls_scan_pair"))


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


def test_k3_traces_logs_the_engine_launches(capsys):
    """k3_traces around an engine run at S = T = 1024 (the smallest size
    that takes K3; the plain version writes the same trace): the launches
    of each budget, the rows open after the keep test, the sweeps and the
    active tiles, the first launch held again at its budget and at 16;
    and K3's operations an entry without a CUDA toolkit."""
    from ghicp_tpu_torch.core.config import GHICPConfig
    from ghicp_tpu_torch.io.synthetic import registration_problem
    from ghicp_tpu_torch.registration.ghicp import ghicp_register_chunked
    src, tgt, fd, _, _, _ = registration_problem(1024, 1024, seed=3)
    ones = np.ones(1024, bool)
    cfg = GHICPConfig(max_iterations=5, converge_translation=0.0,
                      converge_rotation=0.0)
    with chip_smoke.k3_traces("rehearsal", hold=1):
        ghicp_register_chunked(src, ones, tgt, ones, fd, 40.0, cfg,
                               device="cpu")
    out = capsys.readouterr().out
    assert ("K3 traces, rehearsal, budget 2: 3 launches, rows open after "
            "the keep test") in out
    for budget in (2, 16):
        assert (f"K3 on the engine's state (rehearsal), budget {budget}: "
                "trace [") in out
    assert out.count("bit-equal to the plain version True") == 2
    assert "sweeps [" in out and "active tiles of sweep 1" in out
    c = chip_smoke.SASS_COUNTS
    base = chip_smoke.K3_ENTRY_OPS + c["sqrt"]
    exp_log = c["exp"] + c["log"]
    assert chip_smoke.k3_ops(8192, 8192, 256, False, False, 132) == (base, 0)
    # the bf16 mult form looks its factor up in the table each block fills
    # once; float32, or a shape where the table does not fit, computes it
    table = 132 * 0x3F81 * (exp_log + chip_smoke.K3_TABLE_EXTRA_OPS)
    assert chip_smoke.k3_ops(8192, 8192, 256, True, False, 132) == (
        base + chip_smoke.K3_LUT_OPS, table)
    assert chip_smoke.k3_ops(8192, 8192, 256, True, True, 132) == (
        base + exp_log, 0)
    assert chip_smoke.k3_ops(20480, 20480, 64, True, False, 132) == (
        base + exp_log, 0)


def test_k5_mult_bound_counts_what_desc_kernel_runs():
    """K5-mult's operations a valid pair count the square root the kernel
    calls (stream.cu's sqrt_rn, whose source the SASS probe compiles),
    expf and logf by their SASS instructions beside the 14 others; its
    bytes count the ceil(D / 8) 16-byte chunks the kernel reads a row."""
    src = chip_smoke.sqrt_rn_source()
    assert src.startswith("__device__ __forceinline__ float sqrt_rn(")
    assert src.rstrip().endswith("}") and "rsqrt.approx" in src
    assert "sqrt_rn(x[threadIdx.x])" in chip_smoke.SASS_PROBE
    c = chip_smoke.SASS_COUNTS
    base = chip_smoke.K5_MULT_PAIR_OPS + c["sqrt_rn"] + c["exp"] + c["log"]
    assert chip_smoke.K5_MULT_PAIR_OPS == 14
    assert chip_smoke.k5_mult_ops(False) == base
    assert chip_smoke.k5_mult_ops(True) == base + chip_smoke.K5_STATS_OPS
    assert chip_smoke.k5_mult_ops(True, True) == (
        base + chip_smoke.K5_STATS_OPS + chip_smoke.K5_COL_OPS)
    # no valid pair: the bytes alone, D = 33 read as 5 chunks and D = 135
    # as 17, not a row padded to 128 or 256 values
    for D, chunks in ((33, 5), (135, 17)):
        ms, by, _ = chip_smoke.k5_mult_bound(1000, 3000, 0.0, D, False)
        n = 4000 * (16 + 16 * chunks) + 1000 * 37 + 3000 * 5
        assert by == "bytes"
        assert ms == pytest.approx(n / chip_smoke.HBM_BYTES_PER_S * 1e3)


def test_register_spread_repeats_without_counting(monkeypatch, capsys):
    """register_spread times ENGINE_REPEATS registrations (the first one
    given), logs each register stage and its spread, and leaves the launch
    counts as the first registration left them."""
    import types

    from ghicp_tpu_torch.ops import LAUNCHES, count_launch
    from ghicp_tpu_torch.registration import pipeline

    def fake(reg_s):
        return types.SimpleNamespace(
            timings={"register": reg_s},
            result=types.SimpleNamespace(iterations=1))

    calls = []

    def register_pair(s, t, c):
        calls.append((s, t, c))
        count_launch("stream_sweep_mult")
        return fake(0.02 + 0.001 * len(calls))

    monkeypatch.setattr(pipeline, "register_pair", register_pair)
    before = dict(LAUNCHES)
    secs = chip_smoke.register_spread("engine", "s", "t", "c", fake(0.03))
    assert LAUNCHES == before
    assert len(calls) == chip_smoke.ENGINE_REPEATS - 1
    assert all(x == ("s", "t", "c") for x in calls)
    assert secs[0] == 0.03 and len(secs) == chip_smoke.ENGINE_REPEATS
    out = capsys.readouterr().out
    assert (f"engine register stage over {chip_smoke.ENGINE_REPEATS} "
            "registrations") in out
    assert f"spread {min(secs):.5f}-{max(secs):.5f} s" in out


def test_k1_bound_counts_what_cost_kernel_runs():
    """K1's operations an entry, form by form, as csrc/cost.cu runs them:
    __fsqrt_rn by its SASS instructions; the bf16 mult form's FD factor
    from the table each block fills once (expf and logf there, by their
    SASS instructions, LUT_N entries a block), the float32 one's expf and
    logf an entry; the statistics and bf16's packing where the form has
    them."""
    from ghicp_tpu_torch.ops.auction_rounds import LUT_N
    c = chip_smoke.SASS_COUNTS
    base = chip_smoke.K1_ENTRY_OPS + c["sqrt"]
    st, bf = chip_smoke.K1_STATS_OPS, chip_smoke.K1_BF16_OPS
    k1 = chip_smoke.k1_ops
    assert k1(8192, False, False, True, 128) == (
        base + st + bf + chip_smoke.K1_BSC_OPS, 0)
    assert k1(8192, False, True, False, 128) == (
        base + chip_smoke.K1_BSC_OPS, 0)
    assert k1(8192, True, False, True, 128) == (
        base + st + bf + chip_smoke.K1_MULT_OPS + chip_smoke.K1_LUT_OPS,
        128 * LUT_N * (c["exp"] + c["log"] + chip_smoke.K3_TABLE_EXTRA_OPS))
    assert k1(8192, True, True, True, 128) == (
        base + st + chip_smoke.K1_MULT_OPS + chip_smoke.K1_FLOOR_OPS
        + c["exp"] + c["log"], 0)
    # a band of 64 rows a block, at most one block an SM
    assert chip_smoke.k1_blocks(torch, 8192) == 128
    assert chip_smoke.k1_blocks(torch, 24576) == 132


@pytest.mark.parametrize("integral", [True, False])
def test_engine_inputs_keeps_the_fd(integral):
    """With ``with_fd`` the record keeps the engine's FD: as uint16 where it
    is the BSC's integer Hamming distances (the verdict record), else as
    float32."""
    import dataclasses

    import ghicp_tpu_torch.registration.pipeline as tpl
    from ghicp_tpu_torch.core.config import CorrespondenceType, GHICPConfig
    rng = np.random.default_rng(4)
    kp = rng.uniform(0, 5, (64, 3)).astype(np.float32)
    m = np.ones(64, bool)
    fd = rng.integers(0, 441, (64, 64)).astype(np.float32)
    if not integral:
        fd = fd / 441.0
    cfg = dataclasses.replace(GHICPConfig(),
                              correspondence=CorrespondenceType.NN,
                              max_iterations=1)
    seen = {}
    with chip_smoke.engine_inputs(torch, seen, with_fd=True):
        tpl.ghicp_register_chunked(kp, m, kp + 0.01, m, fd, 7.5, cfg,
                                   device="cpu")
    assert seen["fd"].dtype == (np.uint16 if integral else np.float32)
    np.testing.assert_array_equal(seen["fd"].astype(np.float32), fd)


def test_kernels_line_keeps_its_rows():
    """The kernels line lists phase 2's 23 comparisons (the Hamming lane
    past four variants, ``hamw_kernel``, last, with its column side), then
    phase 13's ring lane, under the names it has always had (the script
    fails if the rows it built differ)."""
    assert chip_smoke.KERNEL_ROWS == (
        "fused_benefit", "fused_benefit_mult", "fused_benefit_f32",
        "fused_benefit_mult_f32", "auction_phase_gs", "auction_phase_gs_f32",
        "auction_warm_fused", "auction_warm_fused_mult",
        "auction_warm_fused_f32", "auction_warm_fused_mult_f32",
        "nms_exact", "stream_sweep", "top2_rows", "stream_sweep_mult",
        "stream_sweep_col", "stream_sweep_mult_col", "stream_sweep_none",
        "stream_sweep_none_col", "auction_rounds", "auction_rounds_f32",
        "auction_phase", "auction_phase_f32", "stream_sweep_wide",
        "stream_sweep_wide_col", "ring_sweep")
    assert chip_smoke.OFF_PATH < set(chip_smoke.KERNEL_ROWS)


def test_surface_phase_rehearsal(capsys):
    """Phase 14 on the CPU at a small size (a structured scene of 6000
    points, 12 degrees apart): the traced registration against the
    untraced one, then the helpers, each read back from its log line (on
    the CPU the trace holds no device events and the helpers meet
    themselves)."""
    import re

    from ghicp_tpu_torch.core.config import GHICPConfig
    from ghicp_tpu_torch.io.synthetic import structured_scene
    pts = structured_scene(np.random.default_rng(2), 6000, extent=10.0)
    th = np.deg2rad(12.0)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                 [0, 0, 1]]
    T[:3, 3] = [0.6, -0.4, 0.1]
    src = ((pts - T[:3, 3]) @ T[:3, :3]).astype(np.float32)
    cfg = GHICPConfig(voxel_size=0.15, neighborhood_radius=0.5,
                      non_max_radius=1.0, min_neighbors=8,
                      estimated_overlap=0.9, max_iterations=20,
                      ransac_hypotheses=4096, pca_cell_cap=32)
    path = chip_smoke.surface_phase(torch, src, pts, T, cfg, "rehearsal",
                                    device="cpu")
    out = capsys.readouterr().out
    assert not any(path.values())           # plain versions launch nothing
    lines = {m.group(1): m.group(2) for m in re.finditer(
        r"^phase (14[ab] [^(\n]+?) \(rehearsal\): (.*)$", out, re.M)}
    stages = re.search(r"stage ranges (\[.*?\])",
                       lines["14a traced register_pair"]).group(1)
    assert stages == str(list(chip_smoke.SURFACE_STAGES))
    assert "0 device kernel events" in lines["14a traced register_pair"]
    verdict = lines["14a verdict pair traced"]
    assert verdict.startswith("success True, rot_err ")
    for label in ("untraced", "traced"):
        oh = float(re.match(r"([0-9.]+) ms; register stage",
                            lines[f"14a dispatch_overhead {label}"]).group(1))
        assert oh > 0.0
    assert re.search(r"iterations (\d+) / \1, transform max \|diff\| 0\.0$",
                     out, re.M)
    assert "mask equal True, xyz max |diff| 0 m" in lines[
        "14b voxel_downsample centroid"]
    pca_line = lines["14b pca_features cell_pair=False against True"]
    assert "counts differ at 0 " in pca_line
    assert "valid equal at equal counts True" in pca_line
    ham = lines["14b Hamming on the verdict BSC"]
    assert "paths equal True" in ham and "False" not in ham
    assert "bit-equal to extract_bsc's frames True" in lines["14b bsc_frames"]
    assert re.search(r"^phase 14 \(public surface, rehearsal\): [0-9.]+ s; "
                     r"launches ", out, re.M)


def test_eager_rounds_rehearsal(monkeypatch, capsys):
    """Phases 4b / 4c's check on the CPU, a capture that replays the round
    eagerly in place of the CUDA graph: the streaming engine run again
    with the guarded rounds run eagerly agrees bit for bit, one capture a
    solve that reached a compacted round, and the rerun's launches do not
    count."""
    import types

    from ghicp_tpu_torch.core.config import (CorrespondenceType,
                                             FeatureType, GHICPConfig)
    from ghicp_tpu_torch.features.bsc import pack_bits
    from ghicp_tpu_torch.io.synthetic import registration_problem
    from ghicp_tpu_torch.matching import stream_auction as sa
    from ghicp_tpu_torch.ops import LAUNCHES
    from ghicp_tpu_torch.ops.stream_kernel import make_stream_features
    from ghicp_tpu_torch.registration.ghicp import ghicp_register_chunked

    n = 512
    # uncorrelated bits: contested columns, so most solves bid on over
    # compacted blocks
    src, tgt, _, bits_s, bits_t, _ = registration_problem(
        n, n, seed=21, rot_deg=12.0, flip=0.5)
    feats = make_stream_features(pack_bits(torch.from_numpy(bits_s)),
                                 pack_bits(torch.from_numpy(bits_t)))
    cfg = GHICPConfig(feature=FeatureType.BSC,
                      correspondence=CorrespondenceType.KM, max_iterations=4,
                      auction_max_rounds=2, streaming_cost="on",
                      stream_open_cap=128, converge_translation=0.0,
                      converge_rotation=0.0)
    m = np.ones(n, bool)

    def register():
        res = ghicp_register_chunked(src, m, tgt, m, None, 40.0, cfg,
                                     device="cpu", stream=feats)
        return types.SimpleNamespace(transform=res.transform, result=res)
    monkeypatch.setattr(sa, "_graph_device", lambda dev: True)
    monkeypatch.setattr(sa, "_capture", lambda step, dev: (
        types.SimpleNamespace(replay=step), {}))
    r0 = {k: LAUNCHES[k] for k in chip_smoke.GRAPH_ROUNDS}
    out = register()
    counts = {k: LAUNCHES[k] - r0[k] for k in chip_smoke.GRAPH_ROUNDS}
    assert counts["stream_graph_capture"] == 4
    after = dict(LAUNCHES)
    said = chip_smoke.eager_rounds(torch, register, out, counts)
    assert LAUNCHES == after
    assert "bit-equal to the eager rounds" in said
    # a capture count that is not one a compacted solve fails the phase
    counts["stream_graph_capture"] += 1
    with pytest.raises(SystemExit, match="captures for"):
        chip_smoke.eager_rounds(torch, register, out, counts)
