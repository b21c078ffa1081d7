"""Station-graph registration (BSC + KM): the port's sequential (kernel
lane) and batched (XLA lane) modes against each other, against the JAX
package's batched ``register_graph`` and against the ground truth, on the
config-5 scene cut to three stations of 9,000 points."""
import dataclasses

import numpy as np
import pytest
import torch

import ghicp_tpu.registration.graph as jg
from ghicp_tpu.core.config import GHICPConfig as JaxConfig
from ghicp_tpu_torch.core.config import FeatureType, GHICPConfig
from ghicp_tpu_torch.io.synthetic import station_graph
from ghicp_tpu_torch.registration import graph as tg
from ghicp_tpu_torch.registration.pipeline import transform_error

torch.set_num_threads(1)
# tests/test_graph.py's settings for a 9,000-point scene, with BSC + KM,
# RANSAC on 4096 hypotheses and 32-point PCA cells (the same keypoints, a
# third of the CPU time)
SETTINGS = dict(voxel_size=0.15, neighborhood_radius=0.5,
                non_max_radius=1.0, min_neighbors=8, estimated_overlap=0.9,
                max_iterations=40, ransac_hypotheses=4096, pca_cell_cap=32)
CAP = 512


@pytest.fixture(scope="module")
def scene():
    """(clouds, ground-truth poses, pairs): 3 stations, chain + loop."""
    return station_graph(n_stations=3, n_points=9000, extent=8.0,
                         seed=0)[:3]


@pytest.fixture(scope="module")
def port_runs(scene):
    clouds, _, pairs = scene
    cfg = GHICPConfig(**SETTINGS)
    return {mode: tg.register_graph(clouds, pairs, cfg,
                                    keypoint_capacity=CAP,
                                    batched=(mode == "batched"),
                                    device="cpu")
            for mode in ("sequential", "batched")}


@pytest.fixture(scope="module")
def jax_batched(scene):
    clouds, _, pairs = scene
    return jg.register_graph(clouds, pairs, JaxConfig(**SETTINGS),
                             keypoint_capacity=CAP, batched=True)


def test_batched_agrees_with_sequential(port_runs):
    (rs, ps), (rb, pb) = port_runs["sequential"], port_runs["batched"]
    for a, b in zip(rs, rb):
        assert (a.source, a.target) == (b.source, b.target)
        rot, tr = transform_error(a.transform, b.transform)
        assert rot < 0.5 and tr < 0.1, (rot, tr)
    for pa, pb_ in zip(ps, pb):
        rot, tr = transform_error(pa, pb_)
        assert rot < 0.5 and tr < 0.1, (rot, tr)


@pytest.mark.parametrize("mode", ["sequential", "batched"])
def test_agrees_with_jax_batched(port_runs, jax_batched, mode):
    results, poses = port_runs[mode]
    jr, jp = jax_batched
    for a, b in zip(results, jr):
        rot, tr = transform_error(a.transform, np.asarray(b.transform))
        assert rot < 0.5 and tr < 0.1, (rot, tr)
    for pa, pb in zip(poses, jp):
        rot, tr = transform_error(pa, pb)
        assert rot < 0.5 and tr < 0.1, (rot, tr)


@pytest.mark.parametrize("mode", ["sequential", "batched"])
def test_poses_recover_ground_truth(scene, port_runs, mode):
    results, poses = port_runs[mode]
    for r in results:
        assert r.quality > 0.0 and r.result.iterations > 0
    for i in (1, 2):
        rot, tr = transform_error(poses[i], scene[1][i])
        assert rot < 0.5 and tr < 0.1, (i, rot, tr)


def test_poses_from_mst_equal_jax():
    """Four stations, five edges of fixed transforms and qualities: the
    spanning tree and the chained poses of both packages."""
    rng = np.random.default_rng(9)
    edges = [(1, 0, 0.9), (2, 1, 0.5), (2, 0, 0.7), (3, 2, 0.8),
             (3, 1, 0.4)]

    class Res:
        def __init__(self, q):
            self.metrics = type("M", (), {"iou": np.float32([q])})()
            self.iterations = 1

    def make(cls):
        out = []
        for k, (s, t, q) in enumerate(edges):
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
            T[:3, 3] = rng.uniform(-2, 2, 3)
            out.append(cls(source=s, target=t, transform=T, result=Res(q)))
        return out

    state = rng.bit_generator.state
    mine = tg._poses_from_mst(4, make(tg.PairResult))
    rng.bit_generator.state = state
    ref = jg._poses_from_mst(4, make(jg.PairResult))
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a, b)


def test_other_features_raise():
    cfg = dataclasses.replace(GHICPConfig(**SETTINGS),
                              feature=FeatureType.FPFH)
    with pytest.raises(NotImplementedError):
        tg.register_graph([np.zeros((10, 3), np.float32)] * 2, [(1, 0)],
                          cfg, device="cpu")
