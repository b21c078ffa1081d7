"""On the card, at each cell's own size: the control (the program's
nearest-neighbour matching in place of KM) comes out not correct on three
seeds, and the sound program correct.  Skips without a CUDA device;
on the card's machine: ``python -m pytest -o addopts="" bench_port/tests
-m card``."""
import json

import pytest

import run
from bench_small import ROOT

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes_at_cell_size(card, cell):
    spec = run.cell_spec(ROOT, cell)
    control = dict(spec, config=dict(spec["config"], engine={
        **spec["config"]["engine"], "correspondence": "nn"}))
    pool = run.gen.make_pool(spec["config"]["scene"],
                             spec["traffic"]["scene_seeds"])
    for seed in (1, 2**31 + 7, 90210):
        got = run.run_cell(control, seed, 2.0, False, log=lambda m: None,
                           pool=pool)
        assert not got["correct"]
        assert got["checks"]["match_broken"]["value"] > 0
    got = run.run_cell(spec, 4, 2.0, False, log=lambda m: None, pool=pool)
    assert got["correct"]
