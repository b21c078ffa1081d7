"""BENCHMARK.json keeps to the benchmark's contract, and every
configuration, traffic mix and metric it names loads by name."""
import json
import re

import pytest

import run
from bench_small import ROOT
from reference import check

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench_port/run.py"]
    assert BENCH["paths"] == ["bench_port"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_bounds():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_reports_enough():
    cells = [w["name"] for w in BENCH["workloads"]]
    assert len(set((w["config"], w["traffic"]) for w in BENCH["workloads"])
               ) == len(cells)
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        spec = run.cell_spec(ROOT, w["name"])
        names = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert spec["per_layer"]
        for m in spec["per_layer"]:
            assert m["moves"] in names
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= set(cells)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files_load(cfg):
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"]
    assert data["reduced"] == cfg["reduced"]
    assert data["source"] == cfg["source"]
    assert {"rot_deg", "t_m"} <= set(data["limits"])
    assert data["assumed"] and data["guarantees"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cells_load_by_name(cell):
    spec = run.cell_spec(ROOT, cell)
    cfg = run.engine_config(spec)
    assert cfg.non_max_radius == {
        **spec["config"]["engine"], **spec["traffic"]["engine"]
    }["non_max_radius"]
    assert spec["traffic"]["scene_seeds"]
    lim = check.limits(spec["config"]["limits"], spec["limits"])
    assert set(check.CELL_SET) <= set(spec["limits"])
    for n in ("rot_deg", "t_m"):
        assert lim[n] <= spec["config"]["limits"][n]
    assert 0 < lim["kp_close"] < 1 and 0 < lim["match_true"] < 1


@pytest.mark.parametrize(
    "name", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_readers_load_by_name(name):
    assert callable(run.reader(name))


def test_an_unknown_cell_is_refused():
    with pytest.raises(run.RunError):
        run.cell_spec(ROOT, "no_such.cell")
