"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points run on the card unless asked for the CPU."""
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "ghicp_tpu_torch"


def test_import_leaves_jax_out():
    code = (
        "import sys, importlib, pkgutil, ghicp_tpu_torch\n"
        "for m in pkgutil.walk_packages(ghicp_tpu_torch.__path__, "
        "'ghicp_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'ghicp_tpu' or m.startswith('ghicp_tpu.')]\n"
        "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_subpackages_build_nothing_and_leave_jax_out():
    """The six subpackages and every name they export (their modules
    imported at first use) pull in neither JAX nor the JAX package, build
    no CUDA library and no native runtime, and import no Triton."""
    code = (
        "import sys, importlib\n"
        "for sub in ('features', 'matching', 'preprocess', 'registration',"
        " 'io', 'shard'):\n"
        "    m = importlib.import_module('ghicp_tpu_torch.' + sub)\n"
        "    for name in m.__all__:\n"
        "        getattr(m, name)\n"
        "from ghicp_tpu_torch import native\n"
        "from ghicp_tpu_torch.ops import _build\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'ghicp_tpu' or m.startswith('ghicp_tpu.')"
        " or m == 'triton' or m.startswith('triton.')]\n"
        "print(','.join(bad), native._LIB is None, _build._LIBS == {})\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "True True"


def test_sources_import_no_jax():
    pat = re.compile(r"^\s*(from|import)\s+(jax|ghicp_tpu)(\.|\s|$)", re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        hits = pat.findall(f.read_text())
        assert not hits, (f, hits)


def test_entry_points_default_to_the_card(monkeypatch):
    from ghicp_tpu_torch.core.config import GHICPConfig
    from ghicp_tpu_torch.registration.ghicp import ghicp_register_chunked
    from ghicp_tpu_torch.registration.pipeline import register_pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.random.default_rng(0).uniform(0, 5, (500, 3)).astype(np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        register_pair(pts, pts, GHICPConfig())
    z = np.zeros((128, 3), np.float32)
    m = np.ones(128, bool)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ghicp_register_chunked(z, m, z, m, np.zeros((128, 128), np.float32),
                               1.0, GHICPConfig())


def test_feature_interop_defaults_to_the_card(monkeypatch):
    """``interop``'s feature functions run on the card unless the caller
    asks for the CPU, as every entry point does."""
    from ghicp_tpu_torch.interop import (desc_features_from_numpy,
                                         stream_features_from_numpy)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bits = np.zeros((1, 4, 448), np.float32)
    rows = np.zeros((4, 128), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream_features_from_numpy(bits, bits[0], np.zeros((1, 4)),
                                   np.zeros(4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        desc_features_from_numpy(rows, rows, 33)
    f = desc_features_from_numpy(rows, rows, 33, device="cpu")
    assert f.fs.device.type == "cpu" and f.fs.dtype == torch.bfloat16
    g = stream_features_from_numpy(bits, bits[0], np.zeros((1, 4)),
                                   np.zeros(4), device="cpu")
    assert g.words_s.device.type == "cpu"


@pytest.mark.parametrize("module", ["ghicp_tpu_torch.cli.main",
                                    "ghicp_tpu_torch.cli.warmup"])
def test_command_lines_leave_jax_out(module):
    """The command lines run as ``python -m``: their help needs neither
    JAX nor the JAX package (nor a card)."""
    code = (f"import runpy, sys\nsys.argv = ['{module}', '-h']\n"
            "try:\n"
            f"    runpy.run_module('{module}', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = [m for m in sys.modules if m == 'jax'"
            " or m.startswith('jax.') or m == 'ghicp_tpu'"
            " or m.startswith('ghicp_tpu.')]\n"
            "print('BAD', ','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "usage:" in out.stdout
    assert out.stdout.strip().splitlines()[-1] == "BAD"


def test_shard_package_leaves_jax_out():
    code = ("import sys, ghicp_tpu_torch.shard, ghicp_tpu_torch.shard.launch,"
            " ghicp_tpu_torch.shard.tasks\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'ghicp_tpu' or m.startswith('ghicp_tpu.')]\n"
            "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_spawned_ranks_leave_jax_out():
    """Each rank checks before it exits that neither JAX nor the JAX
    package is loaded (here, where the tests load both, the check
    raises)."""
    from ghicp_tpu_torch.shard.launch import launch, no_jax_loaded
    res = launch("comm_selftest", 2, "gloo",
                 dict(values=[np.ones(2, np.float32)] * 2, device="cpu"))
    assert [r["rank"] for r in res] == [0, 1]
    import jax  # noqa: F401  (the test process holds the JAX package)
    with pytest.raises(RuntimeError, match="imported"):
        no_jax_loaded()
