"""The port's checkpoints against the JAX package's: BSC feature files
either package writes load in the other with equal packed words, the
registration JSON round trip (its config through ``interop``), and a warm
start from a loaded transform."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ghicp_tpu.core.config import GHICPConfig as JConfig
from ghicp_tpu.core.types import PointCloud as JCloud
from ghicp_tpu.features import extract_bsc as j_extract
from ghicp_tpu.io import checkpoint as jckpt
from ghicp_tpu_torch.core.config import (CorrespondenceType, FeatureType,
                                         GHICPConfig)
from ghicp_tpu_torch.core.types import PointCloud
from ghicp_tpu_torch.features.bsc import extract_bsc
from ghicp_tpu_torch.interop import config_to_dict
from ghicp_tpu_torch.io.checkpoint import (load_features, load_registration,
                                           save_features, save_registration)
from ghicp_tpu_torch.io.synthetic import structured_scene
from ghicp_tpu_torch.registration.pipeline import (register_pair,
                                                   transform_error)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(1)
    pts = rng.uniform(0, 5, (1500, 3)).astype(np.float32)
    kp = pts[np.arange(8) * 100]
    return pts, kp


def _words(packed):
    return np.asarray(packed).astype(np.int64)


def test_jax_feature_file_loads_in_the_port(tmp_path, scene):
    pts, kp = scene
    cfg = JConfig(non_max_radius=0.8)
    feats = j_extract(JCloud.from_points(pts), jnp.asarray(kp),
                      jnp.ones(8, bool), cfg, num_variants=2)
    p = str(tmp_path / "jax.npz")
    jckpt.save_features(p, feats, cfg.bsc_seed, cfg.bsc_grid_side)
    got, seed, side = load_features(p, device="cpu")
    assert got.packed.dtype == torch.int64
    np.testing.assert_array_equal(got.packed.numpy(), _words(feats.packed))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(feats.mask))
    assert (got.n_bits, seed, side) == (feats.n_bits, cfg.bsc_seed,
                                        cfg.bsc_grid_side)
    # and back: the port's file of the same words loads in the JAX package
    q = str(tmp_path / "port.npz")
    save_features(q, got, seed, side)
    back, seed2, side2 = jckpt.load_features(q)
    assert np.asarray(back.packed).dtype == np.uint32
    np.testing.assert_array_equal(np.asarray(back.packed),
                                  np.asarray(feats.packed))
    assert (back.n_bits, seed2, side2) == (feats.n_bits, seed, side)


def test_port_feature_file_loads_in_jax(tmp_path, scene):
    pts, kp = scene
    cfg = GHICPConfig(non_max_radius=0.8)
    feats = extract_bsc(PointCloud.from_points(pts), torch.from_numpy(kp),
                        torch.ones(8, dtype=torch.bool), cfg,
                        num_variants=2)
    p = str(tmp_path / "port.npz")
    save_features(p, feats, cfg.bsc_seed, cfg.bsc_grid_side)
    back, seed, side = jckpt.load_features(p)
    np.testing.assert_array_equal(_words(back.packed), feats.packed.numpy())
    assert back.n_bits == feats.n_bits and seed == cfg.bsc_seed
    mine, _, _ = load_features(p, device="cpu")
    assert torch.equal(mine.packed, feats.packed)


def test_load_features_defaults_to_the_card(tmp_path, scene, monkeypatch):
    pts, kp = scene
    cfg = GHICPConfig(non_max_radius=0.8)
    feats = extract_bsc(PointCloud.from_points(pts), torch.from_numpy(kp),
                        torch.ones(8, dtype=torch.bool), cfg,
                        num_variants=1)
    p = str(tmp_path / "f.npz")
    save_features(p, feats, cfg.bsc_seed, cfg.bsc_grid_side)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_features(p)


def test_registration_file_cross_packages(tmp_path):
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [1.5, -2.0, 0.25]
    cfg = GHICPConfig(feature=FeatureType.FPFH,
                      correspondence=CorrespondenceType.NNR, reg_dof=4,
                      voxel_size=0.2, max_iterations=17)
    p = str(tmp_path / "port.json")
    save_registration(p, T, cfg, {"rmse": 0.125})
    T2, cfg2, blob = load_registration(p)
    np.testing.assert_array_equal(T2, T)
    assert cfg2 == cfg and blob["metrics"] == {"rmse": 0.125}
    # the JAX package reads the port's file and writes the same blob
    Tj, jblob = jckpt.load_registration(p)
    np.testing.assert_array_equal(Tj, T)
    assert jblob["config"] == config_to_dict(cfg)
    jcfg = JConfig(**{f.name: getattr(cfg2, f.name)
                      for f in dataclasses.fields(JConfig)
                      if f.name not in ("feature", "correspondence")},
                   feature=type(JConfig().feature)("fpfh"),
                   correspondence=type(JConfig().correspondence)("nnr"))
    q = str(tmp_path / "jax.json")
    jckpt.save_registration(q, T, jcfg, {"rmse": 0.125})
    with open(p) as a, open(q) as b:
        assert a.read() == b.read()
    assert load_registration(q)[1] == cfg


def _pair(seed=2, n=6000):
    rng = np.random.default_rng(seed)
    pts = structured_scene(rng, n, extent=8.0)
    th = np.deg2rad(10.0)
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]], np.float32)
    t = np.float32([1.0, -0.5, 0.2])
    T_gt = np.eye(4, dtype=np.float32)
    T_gt[:3, :3] = R
    T_gt[:3, 3] = t
    src = ((pts - t) @ R + rng.normal(0, 0.01, pts.shape)).astype(np.float32)
    tgt = (pts + rng.normal(0, 0.01, pts.shape)).astype(np.float32)
    return src, tgt, T_gt


def test_warm_start_from_a_loaded_transform(tmp_path):
    """The JAX suite's warm start (tests/test_filters_ckpt.py): the loaded
    transform converges at once and at least as accurately."""
    src, tgt, T_gt = _pair()
    cfg = GHICPConfig(feature=FeatureType.NONE,
                      correspondence=CorrespondenceType.NNR,
                      voxel_size=0.15, neighborhood_radius=0.5,
                      non_max_radius=1.0, min_neighbors=8,
                      estimated_overlap=0.9, max_iterations=40)
    T_guess = T_gt.copy()
    T_guess[:3, 3] += [0.3, -0.2, 0.05]
    out = register_pair(src, tgt, cfg, initial_transform=T_guess,
                        device="cpu")
    p = str(tmp_path / "reg.json")
    save_registration(p, out.transform, cfg, {"rmse": out.final_rmse})
    T, cfg2, blob = load_registration(p)
    np.testing.assert_allclose(T, out.transform, atol=1e-6)
    assert cfg2.reg_dof == 6 and blob["config"]["reg_dof"] == 6
    out2 = register_pair(src, tgt, cfg2, initial_transform=T, device="cpu")
    assert int(out2.result.iterations) <= max(int(out.result.iterations), 3)
    rot, tr = transform_error(out2.transform, T_gt)
    assert rot < 1.0 and tr < 0.2, (rot, tr)
