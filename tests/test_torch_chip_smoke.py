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
                                         "top2_rows", "stream_sweep_mult"]
    for r in rows:
        assert r["max_abs_err"] == 0.0
        assert r["bound_ms"] > 0
        assert r["bound_by"] == ("operations" if r["name"] in (
            "nms_exact", "stream_sweep") else "bytes")
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
