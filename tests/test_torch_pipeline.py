"""``register_pair`` of both packages on the JAX suite's BSC + KM pair, the
JAX package running its fused and GS kernels in interpret mode so that
both run the same auction.  The RANSAC draws differ (``jax.random`` vs a
``torch.Generator``), hence the looser pose agreement."""
import numpy as np
import torch

import ghicp_tpu.matching.auction as jau
import ghicp_tpu.registration.ghicp as jgh
from ghicp_tpu.core.config import (CorrespondenceType, FeatureType,
                                   GHICPConfig)
from ghicp_tpu.io.synthetic import structured_scene
from ghicp_tpu.registration import register_pair as jax_register_pair
from ghicp_tpu_torch.interop import config_from_dict, config_to_dict
from ghicp_tpu_torch.registration.pipeline import (register_pair,
                                                   transform_error)

torch.set_num_threads(1)


def _full_overlap_pair(seed, n=8000, rot_deg=20.0, extent=10.0):
    rng = np.random.default_rng(seed)
    pts = structured_scene(rng, n, extent=extent)
    th = np.deg2rad(rot_deg)
    R = np.array([[np.cos(th), -np.sin(th), 0],
                  [np.sin(th), np.cos(th), 0], [0, 0, 1]], np.float32)
    t = rng.uniform(-1.5, 1.5, 3).astype(np.float32)
    T_gt = np.eye(4, dtype=np.float32)
    T_gt[:3, :3] = R
    T_gt[:3, 3] = t
    src = ((pts - t) @ R + rng.normal(0, 0.01, pts.shape)).astype(np.float32)
    tgt = (pts + rng.normal(0, 0.01, pts.shape)).astype(np.float32)
    return src, tgt, T_gt


def test_register_pair_matches_jax():
    src, tgt, T_gt = _full_overlap_pair(seed=2)
    cfg = GHICPConfig(feature=FeatureType.BSC,
                      correspondence=CorrespondenceType.KM,
                      estimated_overlap=0.9, max_iterations=30,
                      voxel_size=0.15, neighborhood_radius=0.5,
                      non_max_radius=1.0, min_neighbors=8)
    old = (jgh._FUSED_INTERPRET, jau._KERNEL_INTERPRET)
    jgh._FUSED_INTERPRET = jau._KERNEL_INTERPRET = True
    try:
        want = jax_register_pair(src, tgt, cfg)
    finally:
        jgh._FUSED_INTERPRET, jau._KERNEL_INTERPRET = old
    cfg_t = config_from_dict(config_to_dict(cfg))
    got = register_pair(src, tgt, cfg_t, device="cpu")
    assert want.success and got.success
    rot, tr = transform_error(got.transform, T_gt)
    assert rot < 3.0 and tr < 0.5, (rot, tr)
    rot, tr = transform_error(got.transform, np.asarray(want.transform))
    assert rot < 0.5 and tr < 0.1, (rot, tr)
    assert got.n_source_down == want.n_source_down
    assert abs(got.n_source_keypoints - want.n_source_keypoints) <= 2
    m = np.asarray(got.result.matches)
    m = m[m >= 0]
    assert len(np.unique(m)) == len(m)
