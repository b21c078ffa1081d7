"""``register_pair`` of both packages with the FPFH and RoPS features (the
multiplicative-blend lanes): dense for both, streaming for FPFH, on the
JAX suite's 8000-point RoPS pair.  The JAX package runs its XLA lane on
the CPU; the port its kernel lane (plain versions of K1-K3, K5)."""
import dataclasses

import numpy as np
import pytest
import torch

from ghicp_tpu.core.config import (CorrespondenceType, FeatureType,
                                   GHICPConfig)
from ghicp_tpu.io.synthetic import structured_scene
from ghicp_tpu.registration import register_pair as jax_register_pair
from ghicp_tpu_torch.interop import config_from_dict, config_to_dict
from ghicp_tpu_torch.registration.pipeline import (register_pair,
                                                   transform_error)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    """tests/test_features.py's RoPS end-to-end pair."""
    rng = np.random.default_rng(12)
    pts = structured_scene(rng, 8000, extent=8.0)
    theta = np.deg2rad(10.0)
    R = np.array([[np.cos(theta), -np.sin(theta), 0],
                  [np.sin(theta), np.cos(theta), 0], [0, 0, 1]], np.float32)
    t = np.float32([0.6, -0.4, 0.1])
    T_gt = np.eye(4, dtype=np.float32)
    T_gt[:3, :3] = R
    T_gt[:3, 3] = t
    src = ((pts - t) @ R + rng.normal(0, 0.01, pts.shape)).astype(np.float32)
    tgt = (pts + rng.normal(0, 0.01, pts.shape)).astype(np.float32)
    return src, tgt, T_gt


@pytest.mark.parametrize("feature, streaming", [
    (FeatureType.FPFH, "off"), (FeatureType.ROPS, "off"),
    (FeatureType.FPFH, "on")])
def test_register_pair_mult_blend_matches_jax(pair, feature, streaming):
    src, tgt, T_gt = pair
    cfg = GHICPConfig(feature=feature, correspondence=CorrespondenceType.KM,
                      voxel_size=0.15, neighborhood_radius=0.5,
                      non_max_radius=1.0, min_neighbors=8,
                      estimated_overlap=0.9, max_iterations=30,
                      ransac_hypotheses=4096, streaming_cost=streaming)
    want = jax_register_pair(src, tgt, cfg)
    got = register_pair(src, tgt, config_from_dict(config_to_dict(cfg)),
                        device="cpu")
    assert got.streaming == (streaming == "on")
    assert got.n_source_down == want.n_source_down
    assert abs(got.n_source_keypoints - want.n_source_keypoints) <= 2
    rot, tr = transform_error(got.transform, T_gt)
    assert rot < 1.5 and tr < 0.3, (rot, tr)
    rot, tr = transform_error(got.transform, np.asarray(want.transform))
    assert rot < 0.5 and tr < 0.1, (rot, tr)
    m = got.result.matches.numpy()
    m = m[m >= 0]
    assert len(m) > 20 and len(np.unique(m)) == len(m)


def test_register_pair_mult_blend_needs_a_card_or_cpu(pair):
    """Without ``device="cpu"`` the entry point runs on the card, and
    raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry point would run on it")
    src, tgt, _ = pair
    for feature in (FeatureType.FPFH, FeatureType.ROPS):
        cfg = config_from_dict(config_to_dict(dataclasses.replace(
            GHICPConfig(), feature=feature)))
        with pytest.raises(RuntimeError):
            register_pair(src, tgt, cfg)
