"""chip_smoke.py rehearsed on the CPU: its kernel-comparison phase runs at a
small size with the plain versions on both sides (the card's CUDA events
replaced by host clocks), and without a card the script exits non-zero
before printing a result."""
import pathlib
import subprocess
import sys
import time

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
    rows = chip_smoke.compare_kernels(torch, seed=7, size=512, device="cpu")
    assert [r["name"] for r in rows] == ["fused_benefit", "auction_phase_gs",
                                         "auction_warm_fused"]
    for r in rows:
        assert r["max_abs_err"] == 0.0
        assert r["bound_ms"] > 0 and r["bound_by"] == "bytes"
        assert r["library_ms"] is None


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run for real")
    root = pathlib.Path(chip_smoke.__file__).resolve().parent
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
