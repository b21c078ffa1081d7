"""chip_smoke.py's phase 12 rehearsed on the CPU at a small size: the
cloud-file round trips (and a writer that loses precision failing them),
the command line on georeferenced LAS, the filters and the baselines."""
import numpy as np
import pytest
import torch

import chip_smoke
from ghicp_tpu_torch.io import files
from ghicp_tpu_torch.io.synthetic import bench_pair

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return bench_pair(n_points=25_000, extent=5.0)


def test_file_round_trips(tmp_path, pair, capsys):
    chip_smoke.file_round_trips(pair[0][:20_000], str(tmp_path))
    out = capsys.readouterr().out
    for label, _, _ in chip_smoke.FILE_CASES:
        assert f"file {label}: 20000 points" in out


def test_file_round_trips_catch_a_lossy_writer(tmp_path, pair,
                                               monkeypatch):
    monkeypatch.setattr(files, "write_txt", lambda p, pts: np.savetxt(
        p, np.asarray(pts, np.float32), fmt="%.4f"))
    with pytest.raises(SystemExit, match="file txt"):
        chip_smoke.file_round_trips(pair[0][:2000], str(tmp_path))


def test_cli_run(tmp_path, pair, capsys, monkeypatch):
    """Every check of the run's own logic (the shift, the CLI against
    ``register_pair`` on the arrays it read, one-to-one correspondences,
    the snapshot count); at this size, 4096 RANSAC hypotheses and 9
    iterations the verdict and the truth bounds are the data's, recorded
    and not held here."""
    src, tgt, T_gt = pair
    checks = []
    monkeypatch.setattr(chip_smoke, "require",
                        lambda cond, what: checks.append((bool(cond), what)))
    path = chip_smoke.cli_run(
        torch, src, tgt, T_gt, str(tmp_path), device="cpu",
        extra=("--ransac-hypotheses", "4096", "--max-iterations", "9"))
    out = capsys.readouterr().out
    failed = [what for ok, what in checks if not ok]
    data = ("cli: rc 2", "cli truth: ", "cli output LAS off the target")
    assert len(checks) == 7, checks
    assert all(what.startswith(data) for what in failed), failed
    assert "cli pose against the truth in the shifted frame" in out
    assert "cli against register_pair with config_from_args" in out
    assert "cli snapshots: " in out and "registered_iter009_source" in out
    assert not any(path.values())           # plain versions launch nothing


def test_baselines_run(pair, capsys):
    src, tgt, T_gt = pair
    chip_smoke.baselines_run(torch, src, tgt, T_gt, device="cpu",
                             icp_voxel=0.4)
    out = capsys.readouterr().out
    for name in ("icp_point2point reciprocal", "icp_point2plane", "gicp",
                 "ndt_reg", "sac_ia_fpfh"):
        assert f"baseline {name}" in out
    assert out.count("filter ") == 3
