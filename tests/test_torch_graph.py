"""Station-graph registration: BSC + KM on the config-5 scene cut to three
stations of 9,000 points (the port's sequential (kernel lane) and batched
(XLA lane) modes against each other, against the JAX package's batched
``register_graph`` and against the ground truth), and the cases of
tests/test_graph.py with feature none + NNR and FPFH + KM, and RoPS with KM
and NN, each held to the JAX test's bound and (but RoPS + NN) to the JAX
package's poses on the same clouds."""
import numpy as np
import pytest
import torch

import ghicp_tpu.registration.graph as jg
from ghicp_tpu.core.config import CorrespondenceType as JaxCorr
from ghicp_tpu.core.config import FeatureType as JaxFeature
from ghicp_tpu.core.config import GHICPConfig as JaxConfig
from ghicp_tpu.io.synthetic import structured_scene
from ghicp_tpu_torch.core.config import (CorrespondenceType, FeatureType,
                                         GHICPConfig)
from ghicp_tpu_torch.io.synthetic import station_graph
from ghicp_tpu_torch.registration import graph as tg
from ghicp_tpu_torch.registration.pipeline import transform_error
from ghicp_tpu_torch.shard import multihost as tmh

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


@pytest.mark.parametrize("func", ["graph", "multihost"])
@pytest.mark.parametrize("order", ["a first", "b first"])
@pytest.mark.parametrize("second", ["parallel", "opposite"])
def test_spanning_tree_takes_the_first_of_tied_edges(func, order, second):
    """Two edges between stations 0 and 1 of equal quality 0.5, the second
    (1, 0) again or (0, 1): the first listed sets station 1's pose, and the
    tie does not reach the transforms (the JAX package's heap compares
    them there and raises)."""
    rng = np.random.default_rng(3)
    T = [np.eye(4, dtype=np.float32) for _ in range(2)]
    for M in T:
        M[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        M[:3, 3] = rng.uniform(-2, 2, 3)
    edges = [((1, 0), T[0]),
             ((1, 0) if second == "parallel" else (0, 1), T[1])]
    if order == "b first":
        edges = edges[::-1]
    (s0, _), T0 = edges[0]
    want = T0 if s0 == 1 else np.linalg.inv(T0).astype(np.float32)
    pairs, tfs = [e[0] for e in edges], [e[1] for e in edges]
    if func == "graph":
        res = [tg.PairResult(source=s, target=t, transform=M,
                             result=type("R", (), {
                                 "metrics": type("M", (), {
                                     "iou": np.float32([0.5])})(),
                                 "iterations": 1})())
               for (s, t), M in zip(pairs, tfs)]
        poses = tg._poses_from_mst(2, res)
    else:
        poses = tmh._poses_from_mst_static(2, pairs, np.stack(tfs),
                                           np.float32([0.5, 0.5]))
    np.testing.assert_array_equal(poses[0], np.eye(4, dtype=np.float32))
    np.testing.assert_array_equal(poses[1], want)


def _rigid(theta_deg, t):
    th = np.deg2rad(theta_deg)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[np.cos(th), -np.sin(th), 0],
                 [np.sin(th), np.cos(th), 0], [0, 0, 1]]
    T[:3, 3] = t
    return T


def _chain(seed):
    """tests/test_graph.py's three-station chain (6 and 12 deg)."""
    rng = np.random.default_rng(seed)
    pts = structured_scene(rng, 9000, extent=8.0)
    poses_gt = [_rigid(0, [0, 0, 0]), _rigid(6, [1.0, -0.5, 0.1]),
                _rigid(12, [0.2, 0.7, -0.1])]
    clouds = []
    for T in poses_gt:
        local = (pts - T[:3, 3]) @ T[:3, :3]
        clouds.append((local + rng.normal(0, 0.01, pts.shape))
                      .astype(np.float32))
    return clouds, poses_gt, [(1, 0), (2, 1)]


def _two_stations(seed, theta=8.0):
    """tests/test_graph.py's FPFH pair: a scene and a moved copy."""
    rng = np.random.default_rng(seed)
    pts = structured_scene(rng, 9000, extent=8.0)
    T1 = _rigid(theta, [0.8, -0.4, 0.1])
    clouds = [(pts + rng.normal(0, 0.01, pts.shape)).astype(np.float32),
              (((pts - T1[:3, 3]) @ T1[:3, :3])
               + rng.normal(0, 0.01, pts.shape)).astype(np.float32)]
    return clouds, [np.eye(4, dtype=np.float32), T1], [(1, 0)]


GRAPH = dict(voxel_size=0.15, neighborhood_radius=0.5, non_max_radius=1.0,
             min_neighbors=8, estimated_overlap=0.9, max_iterations=40,
             pca_cell_cap=32)


def _run_both(clouds, pairs, feature, corr, batched, **extra):
    """The port's and the JAX package's ``register_graph`` on the same
    clouds and settings (512 keypoint slots)."""
    kw = dict(GRAPH, feature=feature, correspondence=corr, **extra)
    mine = tg.register_graph(clouds, pairs, GHICPConfig(**kw),
                             keypoint_capacity=512, batched=batched,
                             device="cpu")
    jkw = dict(kw, feature=JaxFeature(feature.value),
               correspondence=JaxCorr(corr.value))
    theirs = jg.register_graph(clouds, pairs, JaxConfig(**jkw),
                               keypoint_capacity=512, batched=batched)
    return mine, theirs


def _check(mine, theirs, poses_gt, rot_max, tr_max):
    """Every station pose within the JAX test's bound of the truth, and
    within 0.5 deg / 0.1 m of the JAX package's pose."""
    (rs, ps), (jr, jp) = mine, theirs
    assert len(rs) == len(jr)
    for i in range(1, len(poses_gt)):
        rot, tr = transform_error(ps[i], poses_gt[i])
        assert rot < rot_max and tr < tr_max, (i, rot, tr)
        rot, tr = transform_error(ps[i], np.asarray(jp[i]))
        assert rot < 0.5 and tr < 0.1, (i, rot, tr)


@pytest.mark.parametrize("batched", [False, True])
def test_none_nnr_chain(batched):
    """tests/test_graph.py:10 (feature none + NNR, no RANSAC), both
    modes."""
    clouds, poses_gt, pairs = _chain(0)
    mine, theirs = _run_both(clouds, pairs, FeatureType.NONE,
                             CorrespondenceType.NNR, batched)
    _check(mine, theirs, poses_gt, 2.0, 0.3)


@pytest.mark.parametrize("batched", [False, True])
def test_fpfh_km(batched):
    """tests/test_graph.py:54 (FPFH + KM, RANSAC on 1 - FD at 4096
    hypotheses): sequential on the kernel lane (K1-mult, K2), batched on
    the XLA lane (the multiplicative blend over a pair axis)."""
    clouds, poses_gt, pairs = _two_stations(2)
    mine, theirs = _run_both(clouds, pairs, FeatureType.FPFH,
                             CorrespondenceType.KM, batched,
                             ransac_hypotheses=4096)
    _check(mine, theirs, poses_gt, 2.0, 0.3)


def test_none_nnr_batched_matches_sequential():
    """tests/test_graph.py:86: the batched engine lands the sequential
    path's poses (0.5 deg / 0.1 m), on the port alone."""
    clouds, _, pairs = _chain(5)
    cfg = GHICPConfig(**dict(GRAPH, feature=FeatureType.NONE,
                             correspondence=CorrespondenceType.NNR))
    rs, ps = tg.register_graph(clouds, pairs, cfg, keypoint_capacity=512,
                               device="cpu")
    rb, pb = tg.register_graph(clouds, pairs, cfg, keypoint_capacity=512,
                               batched=True, device="cpu")
    for a, b in zip(rs, rb):
        assert (a.source, a.target) == (b.source, b.target)
        rot, tr = transform_error(a.transform, b.transform)
        assert rot < 0.5 and tr < 0.1, (rot, tr)
    for pa, pb_ in zip(ps, pb):
        rot, tr = transform_error(pa, pb_)
        assert rot < 0.5 and tr < 0.1, (rot, tr)


def test_rops_km_batched():
    """RoPS stations (moments at the keypoints, the similarity matrix) with
    KM on the batched engine, against the JAX package and the truth (the
    JAX FPFH graph bound)."""
    clouds, poses_gt, pairs = _two_stations(3, theta=5.0)
    mine, theirs = _run_both(clouds, pairs, FeatureType.ROPS,
                             CorrespondenceType.KM, True,
                             ransac_hypotheses=4096)
    _check(mine, theirs, poses_gt, 2.0, 0.3)


def test_rops_nn_sequential():
    """RoPS stations with NN matching, sequential, held to the truth (the
    JAX FPFH graph bound) only.  On this pair one NMS keypoint of station
    1 differs between the packages (two candidates whose curvatures agree
    to 3.4e-7 swap), and NN from the same RANSAC pose then ends 0.74 deg
    from the JAX package's pose (1.00 deg from the truth against its
    0.39): a keypoint-stage sensitivity both packages share, recorded as
    an open item, not a bound of this test."""
    clouds, poses_gt, pairs = _two_stations(3, theta=5.0)
    cfg = GHICPConfig(**dict(GRAPH, feature=FeatureType.ROPS,
                             correspondence=CorrespondenceType.NN,
                             ransac_hypotheses=4096))
    results, poses = tg.register_graph(clouds, pairs, cfg,
                                       keypoint_capacity=512, device="cpu")
    assert results[0].result.iterations > 1
    rot, tr = transform_error(poses[1], poses_gt[1])
    assert rot < 2.0 and tr < 0.3, (rot, tr)


def test_station_features_per_type():
    """A station carries the features of its type only, and the pair
    matrix is Hamming, similarity or zeros accordingly."""
    clouds, _, _ = _two_stations(2)
    for feat in FeatureType:
        cfg = GHICPConfig(**dict(GRAPH, feature=feat))
        st = [tg.build_station(c, i, cfg, 512, device="cpu")
              for i, c in enumerate(clouds)]
        fd = tg.station_pair_fd(st[0], st[1], cfg)
        assert fd.shape == (512, 512)
        assert (st[0].bsc_packed is not None) == (feat == FeatureType.BSC)
        assert (st[0].frames is not None) == (feat == FeatureType.BSC)
        has_desc = feat in (FeatureType.FPFH, FeatureType.ROPS)
        assert (st[0].desc is not None) == has_desc
        if feat == FeatureType.NONE:
            assert not bool(fd.any())
        elif has_desc:
            assert float(fd.max()) <= 1.0 + 1e-6
