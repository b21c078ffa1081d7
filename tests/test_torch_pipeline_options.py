"""register_pair's options against the JAX package on the same inputs:
corner refinement, adaptive keypoint counts, localization-aware BSC
(``bsc_offsets``), identity hypotheses and 4-DoF estimation."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from ghicp_tpu.core.config import CorrespondenceType as JCor
from ghicp_tpu.core.config import FeatureType as JFeat
from ghicp_tpu.core.config import GHICPConfig as JConfig
from ghicp_tpu.core.types import PointCloud as JCloud
from ghicp_tpu.io.synthetic import make_pair, structured_scene
from ghicp_tpu_torch.core.types import PointCloud
from ghicp_tpu_torch.interop import config_from_dict

torch.set_num_threads(1)


def _port_cfg(cfg):
    return config_from_dict(dataclasses.asdict(cfg))


def _box_corner():
    """tests/test_preprocess.py's cloud: three orthogonal quarter-planes
    meeting at the origin, ~0.04 m spacing, 2 mm noise."""
    rng = np.random.default_rng(21)
    g = np.arange(0.0, 1.0, 0.04, dtype=np.float32)
    uu, vv = np.meshgrid(g, g)
    u = np.stack([uu.ravel(), vv.ravel()], 1)
    z = np.zeros(len(u), np.float32)
    pts = np.concatenate([np.stack([u[:, 0], u[:, 1], z], 1),
                          np.stack([u[:, 0], z, u[:, 1]], 1),
                          np.stack([z, u[:, 0], u[:, 1]], 1)])
    return (pts + rng.normal(0, 0.002, pts.shape)).astype(np.float32)


def test_corner_refinement_matches_jax():
    """The tangent-plane intersection on the box corner, each package on
    its own PCA: an off-vertex keypoint snaps to the vertex, a mid-face one
    stays, and the refined positions agree within 1e-4 m (normals enter
    squared, so eigenvector signs do not matter; float32 3x3 solves)."""
    from ghicp_tpu.preprocess import pca_features as j_pca
    from ghicp_tpu.preprocess.keypoints import refine_positions_corner as jr
    from ghicp_tpu_torch.preprocess.keypoints import refine_positions_corner
    from ghicp_tpu_torch.preprocess.pca import pca_features
    pts = _box_corner()
    kp = np.float32([[0.12, 0.09, 0.0], [0.6, 0.55, 0.0],
                     [0.05, 0.0, 0.4], [0.3, 0.3, 0.3]])
    mask = np.array([True, True, True, False])
    jc = JCloud.from_points(pts, capacity=4096)
    want = np.asarray(jr(jnp.asarray(kp), jnp.asarray(mask), jc,
                         j_pca(jc, radius=0.15, k=48, cell_cap=32),
                         radius=0.3, k=192, cell_cap=128))
    tc = PointCloud.from_points(pts, capacity=4096, device="cpu")
    got = refine_positions_corner(
        torch.from_numpy(kp), torch.from_numpy(mask), tc,
        pca_features(tc, radius=0.15, cell_cap=32), radius=0.3, k=192,
        cell_cap=128).numpy()
    assert np.linalg.norm(got[0]) < 0.03          # the vertex
    assert np.linalg.norm(got[1] - kp[1]) < 0.02  # flat: stays
    assert np.array_equal(got[3], kp[3])          # masked: untouched
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_adaptive_detect_matches_jax(monkeypatch):
    """keypoints_max under the first count: the ratio loop runs (prune and
    NMS over the whole cloud at a lower ratio).  On the JAX package's PCA
    features both packages select the same keypoints; on each package's
    own PCA (float sums in another order: curvatures a few 1e-8 apart)
    the selections differ by at most a near-tied pair."""
    import ghicp_tpu_torch.preprocess.keypoints as tk
    from ghicp_tpu.core.types import compact_device as j_compact
    from ghicp_tpu.preprocess import pca_features as j_pca
    from ghicp_tpu.preprocess import voxel_downsample as j_voxel
    from ghicp_tpu.preprocess.keypoints import adaptive_detect as j_adapt
    from ghicp_tpu.preprocess.keypoints import detect_keypoints as j_detect
    from ghicp_tpu_torch.preprocess.pca import PCAFeatures
    pts = structured_scene(np.random.default_rng(3), 8000, extent=10.0)
    base = dict(voxel_size=0.15, neighborhood_radius=0.5,
                non_max_radius=0.5, min_neighbors=8, pca_cell_cap=32)
    jd = j_compact(j_voxel(JCloud.from_points(pts), base["voxel_size"]))
    first = int(np.asarray(j_detect(jd, JConfig(**base)).mask).sum())
    cfg = JConfig(**base, adaptive_keypoints=True,
                  keypoints_min=first // 3, keypoints_max=first - 20)
    want = np.asarray(j_adapt(jd, cfg).mask)
    tc = PointCloud(xyz=torch.tensor(np.asarray(jd.xyz)),
                    mask=torch.tensor(np.asarray(jd.mask)))
    own = tk.adaptive_detect(tc, _port_cfg(cfg))
    assert want.sum() < first and own.mask.sum() < first   # the loop ran
    assert abs(int(own.mask.sum()) - int(want.sum())) <= 1
    assert (own.mask.numpy() != want).sum() <= 2
    jf = j_pca(jd, radius=cfg.neighborhood_radius, k=cfg.neighbor_k,
               cell_cap=cfg.pca_cell_cap, max_cells=cfg.pca_max_cells)
    same = PCAFeatures(*(torch.tensor(np.asarray(getattr(jf, f)))
                         for f in PCAFeatures._fields))
    monkeypatch.setattr(tk, "pca_features", lambda *a, **k: same)
    got = tk.adaptive_detect(tc, _port_cfg(cfg))
    assert np.array_equal(got.mask.numpy(), want)


def test_offset_encodings_fd_equals_jax():
    """bsc_offsets = 3 on the dense lane: the source re-encoded at two
    offsets of half the voxel, stacked on the variant axis (12 variants at
    6-DoF); the min-Hamming FD equals the JAX package's on the same
    keypoints (exact integers) wherever both packages encode the same
    bits, and every offset encoding is its own package's plain encoding
    at the shifted keypoints."""
    from ghicp_tpu.core.types import compact_device as j_compact
    from ghicp_tpu.features import extract_bsc as j_extract
    from ghicp_tpu.features import min_hamming_fd as j_fd
    from ghicp_tpu.preprocess import detect_keypoints as j_detect
    from ghicp_tpu.preprocess import voxel_downsample as j_voxel
    from ghicp_tpu_torch.features.bsc import extract_bsc
    from ghicp_tpu_torch.features.hamming import min_hamming_fd
    from ghicp_tpu_torch.registration.pipeline import offset_encodings
    base = dict(voxel_size=0.15, neighborhood_radius=0.5,
                non_max_radius=1.0, min_neighbors=8, bsc_offsets=3)
    pts = structured_scene(np.random.default_rng(0), 8000, extent=10.0)
    jd = j_compact(j_voxel(JCloud.from_points(pts), base["voxel_size"]))
    jcfg = JConfig(**base)
    idx = np.nonzero(np.asarray(j_detect(jd, jcfg).mask))[0][:128]
    kp = np.zeros((128, 3), np.float32)
    kp[:len(idx)] = np.asarray(jd.xyz)[idx]
    km = np.zeros(128, bool)
    km[:len(idx)] = True
    # the JAX package's stacking (ghicp_tpu/registration/pipeline.py)
    delta = 0.5 * base["voxel_size"]
    offs = np.array([[1, 0, 0], [-1, 0, 0]], np.float32) * delta
    packs = [j_extract(jd, jnp.asarray(kp + o), jnp.asarray(km), jcfg,
                       num_variants=4).packed
             for o in (np.zeros(3, np.float32), *offs)]
    j_src = jnp.concatenate(packs, axis=0)
    j_tgt = j_extract(jd, jnp.asarray(kp), jnp.asarray(km), jcfg,
                      num_variants=1).packed
    cloud = PointCloud(xyz=torch.tensor(np.asarray(jd.xyz)),
                       mask=torch.tensor(np.asarray(jd.mask)))
    tcfg = _port_cfg(jcfg)
    kpt, kmt = torch.from_numpy(kp), torch.from_numpy(km)
    fs = extract_bsc(cloud, kpt, kmt, tcfg, num_variants=4)
    fs3 = offset_encodings(cloud, kpt, kmt, fs, tcfg)
    assert fs3.packed.shape[0] == 12 and torch.equal(fs3.packed[:4],
                                                      fs.packed)
    for k, o in enumerate(offs):
        shifted = extract_bsc(cloud, kpt + torch.from_numpy(o), kmt, tcfg,
                              num_variants=4)
        assert torch.equal(fs3.packed[4 * (k + 1):4 * (k + 2)],
                           shifted.packed)
    # the FD of JAX's packed words through the port's min-Hamming: exact
    ft = extract_bsc(cloud, kpt, kmt, tcfg, num_variants=1)
    j_words = torch.from_numpy(np.asarray(j_src).astype(np.int64))
    j_tw = torch.from_numpy(np.asarray(j_tgt).astype(np.int64))
    np.testing.assert_array_equal(
        min_hamming_fd(j_words, j_tw, 441).numpy(),
        np.asarray(j_fd(j_src, j_tgt, 441)))
    # each package's own encodings: the FD agrees where the bits do
    same = (fs3.packed.numpy() == np.asarray(j_src)).all(axis=(0, 2)) & km
    assert same.sum() >= 0.9 * km.sum()
    fd_t = min_hamming_fd(fs3.packed, ft.packed, 441).numpy()
    fd_j = np.asarray(j_fd(j_src, j_tgt, 441))
    assert np.array_equal(fd_t[same], fd_j[same])


def _record_hypotheses(monkeypatch, module):
    """Record (it_shift, transform) of every engine run of ``module``'s
    register_pair."""
    runs, orig = [], module.ghicp_register_chunked

    def spy(*a, **k):
        out = orig(*a, **k)
        runs.append((float(k.get("it_shift", 0.0)),
                     np.asarray(out.transform)))
        return out
    monkeypatch.setattr(module, "ghicp_register_chunked", spy)
    return runs


def _winner(runs, T):
    """The shift of the hypothesis whose pose the pipeline returned."""
    return next(sh for sh, Tr in runs if np.array_equal(Tr, np.asarray(T)))


def test_identity_hypotheses_pick_the_jax_winner(monkeypatch):
    """identity_hypotheses = 3 from the identity (coarse_init none) on a
    15k-point make_pair, both packages on their Jacobi (XLA) lanes: three
    schedule-shifted engine runs each, the geometric-consensus selector
    picks the same shift, and the pose is within tests/test_
    registration.py:250's truth bound."""
    import ghicp_tpu.registration.pipeline as jp
    import ghicp_tpu_torch.registration.pipeline as tp
    src, tgt, T_gt = make_pair(seed=3, n_points=15_000, rotation_deg=10,
                               translation=0.8, noise=0.01, overlap=0.85)
    cfg = JConfig(feature=JFeat.BSC, correspondence=JCor.KM,
                  voxel_size=0.08, neighborhood_radius=0.3,
                  non_max_radius=0.3, min_neighbors=8,
                  estimated_overlap=0.8, max_iterations=25,
                  coarse_init="none", identity_hypotheses=3,
                  fused_cost_kernel=False, auction_round_kernel=False)
    j_runs = _record_hypotheses(monkeypatch, jp)
    t_runs = _record_hypotheses(monkeypatch, tp)
    want = jp.register_pair(np.asarray(src), np.asarray(tgt), cfg)
    got = tp.register_pair(np.asarray(src), np.asarray(tgt), _port_cfg(cfg),
                           device="cpu")
    rate = cfg.weight_changing_rate
    assert [sh for sh, _ in j_runs] == [0.0, rate, 3.0 * rate]
    assert [sh for sh, _ in t_runs] == [0.0, rate, 3.0 * rate]
    assert "coarse_init" not in got.timings       # no RANSAC fallback
    assert _winner(t_runs, got.transform) == _winner(j_runs, want.transform)
    rot, tr = tp.transform_error(got.transform, T_gt)
    assert rot < 2.0 and tr < 0.3, (rot, tr)


def test_yaw_only_registration_matches_jax():
    """reg_dof = 4 end to end (tests/test_registration.py's none + NNR
    yaw-only pair): the estimated rotation is exactly a yaw, the truth
    bound holds, and the pose is within 0.05 deg / 0.01 m of the JAX
    package's."""
    from ghicp_tpu.registration.pipeline import register_pair as j_register
    from ghicp_tpu_torch.registration.pipeline import (register_pair,
                                                       transform_error)
    rng = np.random.default_rng(4)
    pts = structured_scene(rng, 8000, extent=10.0)
    th = np.deg2rad(12.0)
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]], np.float32)
    t = rng.uniform(-1.5, 1.5, 3).astype(np.float32)
    T_gt = np.eye(4, dtype=np.float32)
    T_gt[:3, :3], T_gt[:3, 3] = R, t
    src = ((pts - t) @ R + rng.normal(0, 0.01, pts.shape)).astype(np.float32)
    tgt = (pts + rng.normal(0, 0.01, pts.shape)).astype(np.float32)
    cfg = JConfig(feature=JFeat.NONE, correspondence=JCor.NNR, reg_dof=4,
                  estimated_overlap=0.9, max_iterations=60, voxel_size=0.15,
                  neighborhood_radius=0.5, non_max_radius=1.0,
                  min_neighbors=8)
    want = j_register(src, tgt, cfg)
    got = register_pair(src, tgt, _port_cfg(cfg), device="cpu")
    rot, tr = transform_error(got.transform, T_gt)
    assert rot < 1.5 and tr < 0.3, (rot, tr)
    Rg = got.transform[:3, :3]
    assert abs(Rg[2, 2] - 1.0) < 1e-4
    assert abs(Rg[0, 2]) < 1e-4 and abs(Rg[1, 2]) < 1e-4
    d_rot, d_t = transform_error(got.transform, np.asarray(want.transform))
    assert d_rot < 0.05 and d_t < 0.01, (d_rot, d_t)
