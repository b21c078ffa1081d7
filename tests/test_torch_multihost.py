"""Pair-parallel distribution of both packages: ``partition_pairs`` and the
gathered spanning-tree chaining against the JAX package's,
``register_graph_distributed`` in one process against the JAX package's
(tests/test_multihost.py's scene), at 2 gloo ranks on
tools/multihost_smoke.py's three stations against the single-process run,
and ``ghicp_register_batched_sharded`` at 2 ranks on four pairs against
the port's single-pair engine and the JAX package's on ``make_mesh(2)``."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import ghicp_tpu.matching.auction as jau
import ghicp_tpu.registration.ghicp as jgh
import ghicp_tpu.shard.multihost as jmh
from ghicp_tpu.core.config import CorrespondenceType as JCorr
from ghicp_tpu.core.config import FeatureType as JFeature
from ghicp_tpu.core.config import GHICPConfig as JConfig
from ghicp_tpu.shard import make_mesh
from ghicp_tpu_torch.core.comm import LOCAL
from ghicp_tpu_torch.core.config import (CorrespondenceType, FeatureType,
                                         GHICPConfig)
from ghicp_tpu_torch.io.synthetic import structured_scene
from ghicp_tpu_torch.registration.ghicp import ghicp_register
from ghicp_tpu_torch.registration.pipeline import transform_error
from ghicp_tpu_torch.shard import multihost as tmh
from ghicp_tpu_torch.shard.launch import launch

torch.set_num_threads(1)
GRAPH = dict(feature=FeatureType.NONE, correspondence=CorrespondenceType.NNR,
             voxel_size=0.15, neighborhood_radius=0.5, non_max_radius=1.0,
             min_neighbors=8, estimated_overlap=0.9, pca_cell_cap=32)
ENGINE = dict(feature=FeatureType.BSC, correspondence=CorrespondenceType.KM,
              max_iterations=4, auction_max_rounds=4)
N_PAIRS, CAP = 4, 256


def _jcfg(cfg: GHICPConfig) -> JConfig:
    d = dataclasses.asdict(cfg)
    d["feature"] = JFeature(cfg.feature.value)
    d["correspondence"] = JCorr(cfg.correspondence.value)
    return JConfig(**d)


def _rigid(theta_deg, t):
    th = np.deg2rad(theta_deg)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[np.cos(th), -np.sin(th), 0],
                 [np.sin(th), np.cos(th), 0], [0, 0, 1]]
    T[:3, 3] = t
    return T


def _smoke_stations():
    """tools/multihost_smoke.py's three stations of 9,000 points."""
    rng = np.random.default_rng(0)
    pts = structured_scene(rng, 9000, extent=8.0)
    poses = [_rigid(0, [0, 0, 0]), _rigid(6, [1.0, -0.5, 0.1]),
             _rigid(12, [0.2, 0.7, -0.1])]
    clouds = [((pts - T[:3, 3]) @ T[:3, :3] + rng.normal(0, 0.01, pts.shape))
              .astype(np.float32) for T in poses]
    return clouds, poses, [(1, 0), (2, 1)]


def _pairs():
    """Four small pairs (BSC bits that follow the geometry), stacked."""
    probs = [ge._registration_problem(CAP, CAP, seed=10 + k)
             for k in range(N_PAIRS)]
    st = lambda i: np.stack([p[i] for p in probs])
    ones = np.ones((N_PAIRS, CAP), bool)
    return dict(kp_s=st(0), mask_s=ones, kp_t=st(1), mask_t=ones, fd=st(2),
                bbx=np.full(N_PAIRS, 40.0, np.float32))


@pytest.fixture(scope="module")
def port():
    clouds, _, pairs = _smoke_stations()
    jobs = [("graph", dict(clouds=clouds, pairs=pairs,
                           config=GHICPConfig(**GRAPH, max_iterations=40),
                           keypoint_capacity=512, device="cpu")),
            ("batched_sharded", dict(inputs=_pairs(),
                                     config=GHICPConfig(**ENGINE),
                                     device="cpu"))]
    ranks = launch("many", 2, "gloo", dict(jobs=jobs), timeout=900)
    for a, b in zip(*ranks):
        for k in ("transform", "transforms", "poses"):
            if k in a:
                np.testing.assert_array_equal(a[k], b[k])
    return ranks[0]


def test_partition_pairs_equals_jax():
    pairs = [(0, 1), (1, 2), (2, 3), (0, 2), (1, 3)]
    for pc in (1, 2, 3):
        for pid in range(pc):
            assert tmh.partition_pairs(pairs, pid, pc) == \
                jmh.partition_pairs(pairs, pid, pc)


def test_poses_from_mst_static_equals_jax():
    rng = np.random.default_rng(4)
    pairs = [(1, 0), (2, 1), (2, 0), (3, 2), (3, 1)]
    tfs = np.stack([np.eye(4, dtype=np.float32)] * len(pairs))
    for T in tfs:
        T[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        T[:3, 3] = rng.uniform(-2, 2, 3)
    quals = rng.uniform(0, 1, len(pairs)).astype(np.float32)
    mine = tmh._poses_from_mst_static(5, pairs, tfs, quals)
    ref = jmh._poses_from_mst_static(5, pairs, tfs, quals)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a, b)


def test_one_process_equals_jax():
    """tests/test_multihost.py's two stations (none + NNR, 1024 slots) in
    one process: the port calls ``register_graph`` as the JAX package
    does; station 1 within 2.0 deg / 0.3 m of the truth and 0.5 deg / 0.1
    m of the JAX pose (tests/test_torch_graph.py's none + NNR bounds)."""
    rng = np.random.default_rng(11)
    base = structured_scene(rng, 12000, extent=10.0)
    R = _rigid(8.0, [0.8, -0.5, 0.2])
    clouds = [base + rng.normal(0, 0.01, base.shape).astype(np.float32),
              ((base - R[:3, 3]) @ R[:3, :3]
               + rng.normal(0, 0.01, base.shape)).astype(np.float32)]
    cfg = GHICPConfig(**GRAPH, max_iterations=50)
    tfs, quals, poses = tmh.register_graph_distributed(
        clouds, [(1, 0)], cfg, keypoint_capacity=1024, comm=LOCAL,
        device="cpu")
    jt, jq, jp = jmh.register_graph_distributed(clouds, [(1, 0)], _jcfg(cfg),
                                                keypoint_capacity=1024)
    assert tfs.shape == (1, 4, 4) and quals.shape == (1,)
    rot, tr = transform_error(poses[1], R)
    assert rot < 2.0 and tr < 0.3, (rot, tr)
    rot, tr = transform_error(poses[1], np.asarray(jp[1]))
    assert rot < 0.5 and tr < 0.1, (rot, tr)


def test_two_ranks_equal_one_process(port):
    """The smoke's three stations over 2 ranks (a pair each): every pair's
    transform within 1e-5 of the one-process run, the stations within the
    smoke's 2.0 deg / 0.3 m of the truth."""
    clouds, poses_gt, pairs = _smoke_stations()
    cfg = GHICPConfig(**GRAPH, max_iterations=40)
    tfs, quals, poses = tmh.register_graph_distributed(
        clouds, pairs, cfg, keypoint_capacity=512, comm=LOCAL, device="cpu")
    got = port[0]
    np.testing.assert_allclose(got["transforms"], tfs, atol=1e-5)
    np.testing.assert_allclose(got["qualities"], quals, atol=1e-6)
    for i in (1, 2):
        rot, tr = transform_error(got["poses"][i], poses_gt[i])
        assert rot < 2.0 and tr < 0.3, (i, rot, tr)


@pytest.mark.parametrize("k", range(N_PAIRS))
def test_batched_sharded_equals_the_single_pair_engine(port, k):
    d = _pairs()
    got = port[1]
    res = ghicp_register(d["kp_s"][k], d["mask_s"][k], d["kp_t"][k],
                         d["mask_t"][k], d["fd"][k], 40.0,
                         GHICPConfig(**ENGINE), device="cpu")
    np.testing.assert_array_equal(got["transform"][k], res.transform.numpy())
    assert got["iterations"][k] == res.iterations
    np.testing.assert_array_equal(got["matches"][k], res.matches.numpy())


def test_batched_sharded_matches_jax():
    """The JAX package's batched-sharded engine on ``make_mesh(2)`` (its
    kernels in interpret mode): each pair within tests/test_torch_engine
    .py's 0.1 deg / 0.02 m of the port's."""
    d = _pairs()
    old = (jgh._FUSED_INTERPRET, jau._KERNEL_INTERPRET)
    jgh._FUSED_INTERPRET = jau._KERNEL_INTERPRET = True
    try:
        want = jgh.ghicp_register_batched_sharded(
            *(jnp.asarray(d[k]) for k in ("kp_s", "mask_s", "kp_t",
                                          "mask_t", "fd", "bbx")),
            _jcfg(GHICPConfig(**ENGINE)), make_mesh(2))
    finally:
        jgh._FUSED_INTERPRET, jau._KERNEL_INTERPRET = old
    for k in range(N_PAIRS):
        mine = ghicp_register(d["kp_s"][k], d["mask_s"][k], d["kp_t"][k],
                              d["mask_t"][k], d["fd"][k], 40.0,
                              GHICPConfig(**ENGINE), device="cpu")
        rot, tr = transform_error(mine.transform.numpy(),
                                  np.asarray(want.transform)[k])
        assert rot < 0.1 and tr < 0.02, (k, rot, tr)
