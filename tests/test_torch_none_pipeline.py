"""``register_pair`` on the classic-ICP lanes (feature "none" with NN, NNR
and KM) on the CPU, on the JAX package's own test pairs and bounds
(tests/test_registration.py, tests/test_stream_engine.py).  The PCA cell
cap is 32 instead of 64: the same keypoints on these pairs at a third of
the CPU time."""
import dataclasses

import numpy as np
import pytest
import torch

import ghicp_tpu_torch.registration.pipeline as tpl
from ghicp_tpu_torch.core.config import (CorrespondenceType, FeatureType,
                                         GHICPConfig)
from ghicp_tpu_torch.io.synthetic import make_pair, structured_scene
from ghicp_tpu_torch.registration.ghicp import (ghicp_register_batched,
                                                ghicp_register_chunked)
from ghicp_tpu_torch.registration.pipeline import (register_pair,
                                                   transform_error)

torch.set_num_threads(1)
BASE = dict(voxel_size=0.15, neighborhood_radius=0.5, non_max_radius=1.0,
            min_neighbors=8, pca_cell_cap=32)


def _full_overlap_pair(seed, n=8000, rot_deg=15.0, extent=10.0):
    """tests/test_registration.py's yaw-only full-overlap pair."""
    rng = np.random.default_rng(seed)
    pts = structured_scene(rng, n, extent=extent)
    th = np.deg2rad(rot_deg)
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]], np.float32)
    t = rng.uniform(-1.5, 1.5, 3).astype(np.float32)
    T_gt = np.eye(4, dtype=np.float32)
    T_gt[:3, :3] = R
    T_gt[:3, 3] = t
    src = ((pts - t) @ R + rng.normal(0, 0.01, pts.shape)).astype(np.float32)
    tgt = (pts + rng.normal(0, 0.01, pts.shape)).astype(np.float32)
    return src, tgt, T_gt


def test_nnr_icp_partial_overlap(monkeypatch):
    """tests/test_registration.py::test_nnr_icp_partial_overlap: success,
    < 1.5 deg / 0.3 m; no RANSAC (feature none has no coarse init)."""
    def refuse(*a, **k):
        raise AssertionError("RANSAC ran on feature none")
    monkeypatch.setattr(tpl, "ransac_coarse_align", refuse)
    src, tgt, T_gt = make_pair(seed=0, n_points=10000, rotation_deg=8.0,
                               translation=0.8, noise=0.01, overlap=0.85,
                               extent=12.0)
    cfg = GHICPConfig(feature=FeatureType.NONE,
                      correspondence=CorrespondenceType.NNR,
                      estimated_overlap=0.7, max_iterations=60, **BASE)
    out = register_pair(src, tgt, cfg, device="cpu")
    rot, tr = transform_error(out.transform, T_gt)
    assert out.success
    assert rot < 1.5 and tr < 0.3, (rot, tr)
    assert "coarse_init" not in out.timings and not out.streaming


def test_nn_icp_converges():
    """tests/test_registration.py::test_nn_icp_converges: < 2.0 deg /
    0.5 m."""
    src, tgt, T_gt = _full_overlap_pair(seed=1, rot_deg=5.0)
    cfg = GHICPConfig(feature=FeatureType.NONE,
                      correspondence=CorrespondenceType.NN,
                      estimated_overlap=0.9, max_iterations=60, **BASE)
    out = register_pair(src, tgt, cfg, device="cpu")
    rot, tr = transform_error(out.transform, T_gt)
    assert rot < 2.0 and tr < 0.5, (rot, tr)


def _reuse(monkeypatch, name: str, n_calls: int):
    """Later runs get the first run's results of ``pipeline.<name>`` (a run
    calls it ``n_calls`` times, on the same clouds in the same order)."""
    real, seen, calls = getattr(tpl, name), [], [0]

    def again(*a, **k):
        i = calls[0] % n_calls
        calls[0] += 1
        if len(seen) <= i:
            seen.append(real(*a, **k))
        return seen[i]
    monkeypatch.setattr(tpl, name, again)


def test_streaming_none_km_matches_dense(monkeypatch):
    """tests/test_stream_engine.py::test_register_pair_streaming_matches_
    dense for feature none (KM, identity start, 60 iterations), on the
    10,000-point pair of the NNR test rather than that test's 20,000-point
    one (whose keypoint stage alone takes 25 s on one CPU thread): the
    streaming lane within 2.0 deg / 0.3 m of the truth and within 0.5 deg
    / 0.1 m of the dense lane.  Both runs downsample the same clouds, so
    the second reuses the first's PCA and keypoints."""
    _reuse(monkeypatch, "pca_features_pair", 1)
    _reuse(monkeypatch, "detect_keypoints", 2)
    src, tgt, T_gt = make_pair(seed=0, n_points=10000, rotation_deg=8.0,
                               translation=0.8, noise=0.01, overlap=0.85,
                               extent=12.0)
    cfg = GHICPConfig(feature=FeatureType.NONE,
                      correspondence=CorrespondenceType.KM,
                      estimated_overlap=0.7, max_iterations=60,
                      coarse_init="none", **BASE)
    dense = register_pair(src, tgt, cfg, device="cpu")
    stream = register_pair(src, tgt, dataclasses.replace(
        cfg, streaming_cost="on"), device="cpu")
    assert stream.streaming and not dense.streaming
    rot, tr = transform_error(stream.transform, T_gt)
    assert rot < 2.0 and tr < 0.3, (rot, tr)
    rot, tr = transform_error(stream.transform, dense.transform)
    assert rot < 0.5 and tr < 0.1, (rot, tr)
    m = stream.result.matches.numpy()
    m = m[m >= 0]
    assert len(m) > 50 and len(np.unique(m)) == len(m)


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points would run on it")
    cfg = GHICPConfig(feature=FeatureType.NONE,
                      correspondence=CorrespondenceType.NNR)
    pts = np.zeros((16, 3), np.float32)
    m = np.ones(16, bool)
    with pytest.raises(RuntimeError):
        register_pair(pts, pts, cfg)
    with pytest.raises(RuntimeError):
        ghicp_register_chunked(pts, m, pts, m, np.zeros((16, 16)), 1.0, cfg)
    with pytest.raises(RuntimeError):
        ghicp_register_batched(pts[None], m[None], pts[None], m[None],
                               np.zeros((1, 16, 16)), [1.0], cfg)
