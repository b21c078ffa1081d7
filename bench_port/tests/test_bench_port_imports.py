"""Nothing the benchmark runs loads JAX or the JAX package (compared by
whole top-level module name: ``ghicp_tpu_torch`` begins with
``ghicp_tpu``), and the harness refuses to give a result without a
card."""
import json
import os
import shutil
import subprocess
import sys

from bench_small import ROOT

PATHS = [str(ROOT / "bench_port" / "tests"), str(ROOT / "bench_port"),
         str(ROOT)]
DRIVE = f"""
import json, sys
sys.path[:0] = {PATHS!r}
from reference import check
ref_only = sorted(m for m in sys.modules
                  if m.split('.')[0] == 'ghicp_tpu_torch')
import bounds, devtrace, gen, run
from bench_small import small_run, small_spec
bench = json.load(open({str(ROOT / 'BENCHMARK.json')!r}))
for m in bench['end_to_end'] + bench['per_layer']:
    run.reader(m['name'])
res = small_run(small_spec(), trace=True)
print(json.dumps({{"ref_only": ref_only, "found": run.forbidden_loaded(),
                   "port": 'ghicp_tpu_torch' in sys.modules,
                   "correct": res["correct"]}}))
"""


def clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_a_run_loads_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", DRIVE], capture_output=True,
                         text=True, cwd=ROOT, env=clean_env(), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"ref_only": [], "found": [], "port": True,
                   "correct": True}


def test_the_name_check_compares_whole_top_level_names(monkeypatch):
    import run
    monkeypatch.setitem(sys.modules, "ghicp_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxlib_like", sys)
    assert run.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "ghicp_tpu.core", sys)
    assert run.forbidden_loaded() == ["ghicp_tpu"]


def test_no_result_without_a_card_or_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files
    (and here, without a card) the command exits non-zero and prints
    nothing on standard output."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload",
         "tls_dense.nms1", "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, env=clean_env(),
        timeout=300)
    assert out.returncode != 0 and out.stdout == ""
