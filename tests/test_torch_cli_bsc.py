"""Both packages' command lines on the BSC + KM lane with the keypoint
and correspondence exports, and the port's on georeferenced LAS files
(the helpers and bounds of tests/test_torch_cli.py)."""
import os

import numpy as np
import torch

from test_torch_cli import _both, _pair, _same_pose
from ghicp_tpu_torch.cli.main import main
from ghicp_tpu_torch.io import read_cloud

torch.set_num_threads(1)


def test_bsc_km_with_keypoints_and_correspondences(tmp_path, capsys):
    sp, tp, _ = _pair(tmp_path, seed=4, n=20000, extent=10.0)
    (rc_j, j, dj), (rc_t, t, dt) = _both(tmp_path, capsys, lambda d: [
        tp, sp, str(d / "out.pcd"), "B", "K", "0.15", "0.5", "1.0", "1.1",
        "0.1", "6", "0.9", "0", "--max-iterations", "40",
        "--ransac-hypotheses", "4096", "--save-keypoints", str(d / "kp"),
        "--save-correspondences", str(d / "corres.txt")])
    assert rc_t == rc_j
    _same_pose(t, j)
    assert sorted(os.listdir(dt)) == sorted(os.listdir(dj))
    ks = np.loadtxt(dt / "kp_keypoints_source.txt")
    kt = np.loadtxt(dt / "kp_keypoints_target.txt")
    corres = np.loadtxt(dt / "corres.txt")
    assert corres.ndim == 2 and corres.shape[1] == 8 and len(corres) > 10
    rows, cols = corres[:, 0].astype(int), corres[:, 1].astype(int)
    assert rows.max() < len(ks) and cols.max() < len(kt)
    assert len(np.unique(rows)) == len(rows) == len(np.unique(cols))
    assert np.median(np.linalg.norm(corres[:, 2:5] - corres[:, 5:8],
                                    axis=1)) < 1.0


def test_georeferenced_las_keeps_the_directory_shift(tmp_path, capsys):
    """LAS clouds at UTM coordinates: both read the directory's shift and
    write the registered source back at its UTM position."""
    off = np.array([500000.0, 4200000.0, 100.0])
    sp, tp, tgt = _pair(tmp_path, ext=".las", offset=off)
    out = str(tmp_path / "out.las")
    rc = main([tp, sp, out, "N", "R", "0.15", "0.5", "1.0", "1.1", "0.1",
               "6", "0.9", "0", "--max-iterations", "40", "--device", "cpu"])
    assert rc == 0
    from scipy.spatial import cKDTree
    reg, shift = read_cloud(out)
    _, tshift = read_cloud(tp)
    np.testing.assert_array_equal(shift, tshift)
    assert np.abs(shift + off).max() < 50.0
    t_local, _ = read_cloud(tp)
    assert np.median(cKDTree(t_local).query(reg[::20])[0]) < 0.2
