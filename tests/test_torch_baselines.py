"""The port's baseline registrars against the JAX package's
(tests/test_baselines.py's pairs and truth bounds): the capped
nearest-neighbor candidates index-equal, the ICP, GICP and NDT poses
within 0.1 deg / 0.01 m of the JAX poses (float64 comparison; the
estimators differ in the last float32 bits: SVD here, Horn's quaternion
there), the min-overlap gate, and SAC-IA within its truth bound (its
draws come from another generator)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ghicp_tpu.registration.baselines as jb
from chip_smoke import pose_error64
from ghicp_tpu.core.config import GHICPConfig
from ghicp_tpu.core.types import PointCloud as JCloud
from ghicp_tpu.io.synthetic import make_pair, structured_scene
from ghicp_tpu.preprocess.neighbors import (_OFFSET_HASHES, _point_hash,
                                            build_grid as j_build_grid)
from ghicp_tpu_torch.core.types import PointCloud
from ghicp_tpu_torch.preprocess.neighbors import build_grid
from ghicp_tpu_torch.registration import baselines as tb

torch.set_num_threads(1)
POSE_DEG, POSE_M = 0.1, 0.01


def _pair(seed, n=6000, rot_deg=6.0, trans=0.5, extent=10.0, noise=0.01):
    rng = np.random.default_rng(seed)
    pts = structured_scene(rng, n, extent=extent)
    theta = np.deg2rad(rot_deg)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    R = (np.eye(3) + np.sin(theta) * K
         + (1 - np.cos(theta)) * (K @ K)).astype(np.float32)
    t = rng.uniform(-trans, trans, 3).astype(np.float32)
    T_gt = np.eye(4, dtype=np.float32)
    T_gt[:3, :3] = R
    T_gt[:3, 3] = t
    src = ((pts - t) @ R + rng.normal(0, noise, pts.shape)).astype(np.float32)
    tgt = (pts + rng.normal(0, noise, pts.shape)).astype(np.float32)
    return src, tgt, T_gt


def _both(src, tgt):
    return ((JCloud.from_points(src), JCloud.from_points(tgt)),
            (PointCloud.from_points(src), PointCloud.from_points(tgt)))


def test_nn_candidates_index_equal_to_jax():
    """At corr_dist 1 m on a cloud of ~60 points a cell the cap of 8
    candidates a cell binds: the port takes the same candidates (the first
    8 of each cell in the stable hash order) and so the same, inexact,
    neighbor."""
    rng = np.random.default_rng(11)
    pts = rng.uniform(0, 4, (4000, 3)).astype(np.float32)
    q = rng.uniform(0.5, 3.5, (700, 3)).astype(np.float32)
    jc, tc = JCloud.from_points(pts), PointCloud.from_points(pts)
    jg, tg = j_build_grid(jc, cell=1.0), build_grid(tc, cell=1.0)
    assert tg.sorted_keys.dtype == torch.int32
    np.testing.assert_array_equal(tg.sorted_keys.numpy(),
                                  np.asarray(jg.sorted_keys))
    np.testing.assert_array_equal(tg.order.numpy(), np.asarray(jg.order))
    # the JAX package's candidate slots (baselines.py::_nn_1)
    qh = _point_hash(jnp.asarray(q), jg.min_xyz, jg.cell)
    hashes = qh[:, None] + jnp.asarray(_OFFSET_HASHES)[None, :]
    start = jnp.searchsorted(jg.sorted_keys, hashes, side="left")
    end = jnp.searchsorted(jg.sorted_keys, hashes, side="right")
    lane = jnp.tile(jnp.arange(8, dtype=jnp.int32), 27)[None, :]
    slots = jnp.clip(jnp.repeat(start, 8, axis=1) + lane, 0, len(pts) - 1)
    in_cell = np.asarray((jnp.repeat(start, 8, axis=1) + lane)
                         < jnp.repeat(end, 8, axis=1))
    cand = np.asarray(jg.order[slots])
    got, got_in = tb._nn_candidates(tg, torch.from_numpy(q))
    np.testing.assert_array_equal(got_in.numpy(), in_cell)
    np.testing.assert_array_equal(got.numpy()[in_cell], cand[in_cell])
    assert np.diff(np.asarray(end - start), axis=1).max() > 8
    j_idx, j_d, j_ok = jb._nn_1(jg, jnp.asarray(q), jnp.ones(700, bool), 1.0)
    t_idx, t_d, t_ok = tb._nn_1(tg, torch.from_numpy(q),
                                torch.ones(700, dtype=torch.bool), 1.0)
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(t_d.numpy(), np.asarray(j_d), atol=1e-6)
    exact = np.sqrt(((q[:, None] - pts[None]) ** 2).sum(-1)).min(axis=1)
    assert (t_d.numpy() > exact + 1e-4).mean() > 0.5


@pytest.mark.parametrize("name,seed,kw", [
    ("icp_point2point", 0, dict(corr_dist=1.5, max_iterations=50)),
    ("icp_point2point", 1, dict(corr_dist=1.5, max_iterations=50,
                                reciprocal=True)),
    ("icp_point2plane", 2, dict(corr_dist=1.5, max_iterations=30)),
    ("gicp", 3, dict(corr_dist=1.5, max_iterations=30)),
], ids=["point2point", "reciprocal", "point2plane", "gicp"])
def test_icp_poses_match_jax(name, seed, kw):
    src, tgt, T_gt = _pair(seed)
    (js, jt), (ts, tt) = _both(src, tgt)
    want = getattr(jb, name)(js, jt, **kw)
    got = getattr(tb, name)(ts, tt, **kw)
    rot, tr = pose_error64(got.transform.numpy(), T_gt)
    assert rot < 1.0 and tr < 0.15, (rot, tr)
    rot, tr = pose_error64(got.transform.numpy(), want.transform)
    assert rot < POSE_DEG and tr < POSE_M, (rot, tr)
    assert got.ok and 0 < got.iterations <= kw["max_iterations"]
    assert abs(got.n_inliers - int(want.n_inliers)) <= 0.01 * len(src)


def _partial_pair(seed, keep=0.55, n=8000, rot_deg=5.0, trans=0.4):
    """The source covers only a slab of the target (the trimmed
    rejector's regime, common_reg.cpp:63-75)."""
    rng = np.random.default_rng(seed)
    pts = structured_scene(rng, n, extent=10.0)
    th = np.deg2rad(rot_deg)
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]], np.float32)
    t = np.float32([trans, -trans, 0.1])
    T_gt = np.eye(4, dtype=np.float32)
    T_gt[:3, :3] = R
    T_gt[:3, 3] = t
    sel = pts[:, 0] <= np.quantile(pts[:, 0], keep)
    src = ((pts[sel] - t) @ R
           + rng.normal(0, 0.01, (sel.sum(), 3))).astype(np.float32)
    tgt = (pts + rng.normal(0, 0.01, pts.shape)).astype(np.float32)
    return src, tgt, T_gt


def test_trimmed_icp_matches_jax():
    src, tgt, T_gt = _partial_pair(6)
    (js, jt), (ts, tt) = _both(src, tgt)
    kw = dict(corr_dist=1.5, max_iterations=50, use_trimmed=True,
              min_overlap=0.2)
    want = jb.icp_point2point(js, jt, **kw)
    got = tb.icp_point2point(ts, tt, **kw)
    plain = tb.icp_point2point(ts, tt, corr_dist=1.5, max_iterations=50)
    assert got.ok
    rot, tr = pose_error64(got.transform.numpy(), T_gt)
    assert rot < 1.0 and tr < 0.15, (rot, tr)
    rot_p, tr_p = pose_error64(plain.transform.numpy(), T_gt)
    assert rot <= rot_p + 0.05 and tr <= tr_p + 0.02
    rot, tr = pose_error64(got.transform.numpy(), want.transform)
    assert rot < POSE_DEG and tr < POSE_M, (rot, tr)


def test_min_overlap_gate_refuses():
    rng = np.random.default_rng(7)
    pts = rng.uniform(0, 5, (2000, 3)).astype(np.float32)
    a = PointCloud.from_points(pts)
    b = PointCloud.from_points(pts + np.float32([100.0, 0, 0]))
    res = tb.icp_point2point(a, b, corr_dist=1.0, max_iterations=20,
                             use_trimmed=True, min_overlap=0.3)
    assert not res.ok and res.iterations == 0 and res.n_inliers == 0
    np.testing.assert_array_equal(res.transform.numpy(), np.eye(4))
    assert not torch.isfinite(res.rmse)


def test_overlap_ratio_equal_to_jax():
    rng = np.random.default_rng(4)
    pts = rng.uniform(0, 10, (2000, 3)).astype(np.float32)
    for shift, lo, hi in ((0.01, 0.99, 1.0), (0.07, 0.0, 1.0),
                          (50.0, 0.0, 0.01)):
        other = pts + np.float32([shift, 0, 0])
        want = float(jb.overlap_ratio(JCloud.from_points(pts),
                                      JCloud.from_points(other), thresh=0.1))
        got = float(tb.overlap_ratio(PointCloud.from_points(pts),
                                     PointCloud.from_points(other),
                                     thresh=0.1))
        assert got == want and lo <= got <= hi


def test_sac_ia_fpfh_within_its_truth_bound():
    src, tgt, T_gt = _pair(5, n=4000, rot_deg=40.0, trans=2.0)
    cfg = GHICPConfig(voxel_size=0.2)
    T, score = tb.sac_ia_fpfh(PointCloud.from_points(src),
                              PointCloud.from_points(tgt), cfg,
                              n_hypotheses=512, inlier_thresh=0.6)
    rot, tr = pose_error64(T.numpy(), T_gt)
    assert rot < 15.0 and tr < 2.5, (rot, tr)
    assert 0 < float(score) <= 512


def test_ndt_matches_jax():
    src, tgt, T_gt = make_pair(seed=5, n_points=30000, rotation_deg=4.0,
                               translation=0.4, noise=0.01, overlap=0.9)
    (js, jt), (ts, tt) = _both(np.asarray(src), np.asarray(tgt))
    want = jb.ndt_reg(js, jt, cell=0.8, max_iterations=40)
    got = tb.ndt_reg(ts, tt, cell=0.8, max_iterations=40)
    start = tb.ndt_reg(ts, tt, cell=0.8, max_iterations=0)
    assert got.iterations == 40 and start.iterations == 0
    rot, tr = pose_error64(got.transform.numpy(), T_gt)
    assert rot < 0.3 and tr < 0.05, (rot, tr)
    assert float(got.score) > 1.5 * float(start.score)
    rot, tr = pose_error64(got.transform.numpy(), want.transform)
    assert rot < POSE_DEG and tr < POSE_M, (rot, tr)
    np.testing.assert_allclose(float(start.score), float(jb.ndt_reg(
        js, jt, cell=0.8, max_iterations=0).score), rtol=1e-4)
