"""Both packages' command lines on the same small files: the same return
codes and files, poses within 0.5 deg / 0.1 m of each other (the port's
pipeline parity bound, tests/test_torch_pipeline.py), snapshots at the
same iterations; and the warm-up on the host."""
import json
import os

import numpy as np
import pytest
import torch

from ghicp_tpu.cli.main import main as jax_main
from ghicp_tpu.io import write_cloud as jax_write_cloud
from ghicp_tpu.io.synthetic import structured_scene
from ghicp_tpu_torch.cli import warmup
from ghicp_tpu_torch.cli.main import build_parser, config_from_args, main
from ghicp_tpu_torch.io import read_cloud
from ghicp_tpu_torch.registration.pipeline import transform_error

torch.set_num_threads(1)


def _pair(tmp_path, seed=0, n=6000, rot_deg=6.0, extent=8.0, ext=".ply",
          offset=None):
    rng = np.random.default_rng(seed)
    pts = structured_scene(rng, n, extent=extent)
    th = np.deg2rad(rot_deg)
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]], np.float32)
    t = np.float32([0.6, -0.4, 0.1])
    src = ((pts - t) @ R + rng.normal(0, 0.01, pts.shape)).astype(np.float32)
    tgt = (pts + rng.normal(0, 0.01, pts.shape)).astype(np.float32)
    if offset is not None:           # UTM coordinates need float64
        src, tgt = src + offset, tgt + offset
    sp, tp = str(tmp_path / f"s{ext}"), str(tmp_path / f"t{ext}")
    jax_write_cloud(sp, src)
    jax_write_cloud(tp, tgt)
    return sp, tp, tgt


def _json(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][-1])


def _both(tmp_path, capsys, make_args):
    """Run the JAX CLI then the port's (``--device cpu``) into two
    directories; returns ((rc, json, dir) for JAX, for the port)."""
    res = []
    for name, fn, extra in (("jax", jax_main, ["--jax-cache", ""]),
                            ("port", main, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        rc = fn(make_args(d) + ["--json"] + extra)
        res.append((rc, _json(capsys.readouterr().out), d))
    return res


def _same_pose(a: dict, b: dict):
    rot, tr = transform_error(np.asarray(a["transform"], np.float32),
                              np.asarray(b["transform"], np.float32))
    assert rot < 0.5 and tr < 0.1, (rot, tr)


def test_none_nnr_with_the_viewer_export(tmp_path, capsys):
    sp, tp, tgt = _pair(tmp_path)
    (rc_j, j, dj), (rc_t, t, dt) = _both(tmp_path, capsys, lambda d: [
        tp, sp, str(d / "out.ply"), "N", "R", "0.15", "0.5", "1.0", "1.1",
        "0.1", "6", "0.9", "1", "--max-iterations", "40"])
    assert rc_t == rc_j == 0 and t["success"] and j["success"]
    _same_pose(t, j)
    assert sorted(os.listdir(dt)) == sorted(os.listdir(dj)) == [
        "out.ply", "out_pair_source.ply", "out_pair_target.ply"]
    from scipy.spatial import cKDTree
    reg, _ = read_cloud(str(dt / "out.ply"))
    assert np.median(cKDTree(tgt).query(reg[::20])[0]) < 0.2


def test_export_every_k_same_iterations_as_jax(tmp_path, capsys):
    sp, tp, _ = _pair(tmp_path, seed=5, n=12000, extent=9.0)
    (rc_j, j, dj), (rc_t, t, dt) = _both(tmp_path, capsys, lambda d: [
        tp, sp, str(d / "out.txt"), "N", "N", "0.15", "0.5", "1.0", "1.1",
        "0.1", "6", "0.9", "0", "--max-iterations", "12", "--coarse-init",
        "none", "--export-every-k", "4"])
    assert rc_t == rc_j
    assert t["iterations"] == j["iterations"]
    _same_pose(t, j)
    names = sorted(os.listdir(dt))
    assert names == sorted(os.listdir(dj))
    n = t["iterations"]
    its = sorted({int(f[8:11]) for f in names if f.startswith("out_iter")})
    assert its == list(range(4, n + 1, 4)) + ([n] if n % 4 else [])
    first = np.loadtxt(dt / f"out_iter{its[0]:03d}_source.txt")
    np.testing.assert_allclose(
        first, np.loadtxt(dj / f"out_iter{its[0]:03d}_source.txt"),
        atol=2e-3)


def test_config_from_args_is_the_jax_config():
    from ghicp_tpu.core.config import GHICPConfig as JConfig
    argv = ["t.ply", "s.ply", "o.ply", "F", "N", "0.2", "0.6", "0.9", "1.2",
            "0.05", "4", "0.7", "0", "--max-iterations", "30",
            "--coarse-init", "none", "--ransac-hypotheses", "4096",
            "--export-every-k", "5"]
    cfg = config_from_args(build_parser().parse_args(argv))
    want = JConfig(feature=type(JConfig().feature)("fpfh"),
                   correspondence=type(JConfig().correspondence)("nn"),
                   reg_dof=4, estimated_overlap=0.7, voxel_size=0.2,
                   neighborhood_radius=0.6, non_max_radius=0.9,
                   weight_adjustment_ratio=1.2, weight_adjustment_step=0.05,
                   max_iterations=30, coarse_init="none",
                   ransac_hypotheses=4096, engine_chunk=5)
    from ghicp_tpu_torch.interop import config_to_dict
    import dataclasses
    assert config_to_dict(cfg) == {
        k: (v.value if hasattr(v, "value") else v)
        for k, v in dataclasses.asdict(want).items()}


def test_cli_defaults_to_the_card(tmp_path, monkeypatch):
    sp, tp, _ = _pair(tmp_path, n=2000)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([tp, sp, str(tmp_path / "o.ply"), "N", "R", "0.15", "0.5",
              "1.0", "1.1", "0.1", "6", "0.9", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        warmup.main(["--points", "2000"])
    pos = [tp, sp, "o.ply", "N", "R", "0.15", "0.5", "1.0", "1.1", "0.1",
           "6", "0.9", "0"]
    with pytest.raises(SystemExit):
        build_parser().parse_args(pos + ["--jax-cache"])
    # --distributed is ported (tests/test_torch_cli_distributed.py)
    assert build_parser().parse_args(pos + ["--distributed"]).distributed


def test_warmup_on_the_host(capsys, monkeypatch):
    built = []
    monkeypatch.setattr(warmup._build, "build_all",
                        lambda: built.append(1) or [])
    rc = warmup.main(["--points", "6000", "--extent", "8", "--voxel",
                      "0.15", "--nms", "1.0", "--feature", "N", "--corres",
                      "R", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and not built      # no CUDA build for the host
    assert "[warmup] built 0 CUDA libraries and the native runtime" in out
    assert "6000-pt N/R pipeline on cpu" in out
