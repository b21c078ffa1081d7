"""The exact-radius NMS fixed point (kernel K4's plain version) against the
JAX package's ``nms_pallas`` in interpret mode, its brute-force reference
and the serial greedy algorithm, on the JAX suite's fixtures; and the
keypoint stage's dispatch of a 16,384-slot bucket to it."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial import cKDTree

from ghicp_tpu.ops.nms_kernel import nms_bruteforce_ref, nms_pallas
from ghicp_tpu_torch.core.types import PointCloud
from ghicp_tpu_torch.ops.nms_kernel import (TS, nms_exact_plain, nms_prep,
                                            within_pairs)
from ghicp_tpu_torch.preprocess.keypoints import (nms_path,
                                                  non_max_suppression)

torch.set_num_threads(1)


def _greedy(pts, curv, cand, radius):
    """Serial greedy-by-curvature NMS (keypoint_detect.hpp:149-191)."""
    order = np.argsort(-curv, kind="stable")
    alive = cand.copy()
    want = np.zeros(len(curv), bool)
    tree = cKDTree(pts.astype(np.float64))
    for i in order:
        if alive[i]:
            want[i] = True
            alive[tree.query_ball_point(pts[i], radius)] = False
    return want


def _fixture(name):
    """The inputs of tests/test_nms_kernel.py's five kernel tests."""
    if name == "ref_and_greedy":
        rng = np.random.default_rng(11)
        pts = rng.uniform(0, 6, (512, 3)).astype(np.float32)
        curv = rng.uniform(0.05, 1.0, 512).astype(np.float32)
        cand = rng.random(512) < 0.8
        cand[500:] = False
        return pts, curv, cand, 0.8
    if name == "curvature_ties":
        rng = np.random.default_rng(12)
        pts = rng.uniform(0, 3, (256, 3)).astype(np.float32)
        curv = rng.choice(np.float32([0.25, 0.5, 0.75]), 256)
        return pts, curv, np.ones(256, bool), 0.9
    if name == "multi_tile":
        rng = np.random.default_rng(13)
        pts = rng.uniform(0, 8, (1024, 3)).astype(np.float32)
        curv = rng.uniform(0.0, 1.0, 1024).astype(np.float32)
        return pts, curv, rng.random(1024) < 0.9, 1.1
    if name == "no_candidates":
        return (np.zeros((256, 3), np.float32), np.zeros(256, np.float32),
                np.zeros(256, bool), 1.0)
    rng = np.random.default_rng(14)
    pts = (rng.uniform(0, 6, (512, 3)) + np.float32([500., -300., 80.])
           ).astype(np.float32)
    curv = rng.uniform(0.05, 1.0, 512).astype(np.float32)
    return pts, curv, np.ones(512, bool), 0.8


@pytest.mark.parametrize("name", ["ref_and_greedy", "curvature_ties",
                                  "multi_tile", "no_candidates",
                                  "far_from_origin"])
def test_plain_matches_jax_kernel_ref_and_greedy(name):
    pts, curv, cand, r = _fixture(name)
    args = (jnp.asarray(pts), jnp.asarray(curv), jnp.asarray(cand), r)
    ksel, krounds = nms_pallas(*args, ts=256, interpret=True)
    bsel, brounds = nms_bruteforce_ref(*args)
    got, rounds = nms_exact_plain(torch.from_numpy(pts),
                                  torch.from_numpy(curv),
                                  torch.from_numpy(cand), r)
    got = got.numpy()
    assert np.array_equal(got, np.asarray(ksel))
    assert np.array_equal(got, np.asarray(bsel))
    assert rounds == int(krounds) == int(brounds)
    assert np.array_equal(got, _greedy(pts, curv, cand, r))


def test_prep_near_tiles_cover_every_pair_in_radius():
    """Every pair within the radius lies in a listed (row, column) tile
    pair, so the kernel's tile skipping never drops one."""
    rng = np.random.default_rng(3)
    n = 2048
    pts = torch.from_numpy(rng.uniform(0, 10, (n, 3)).astype(np.float32))
    curv = torch.from_numpy(rng.random(n).astype(np.float32))
    cand = torch.from_numpy(rng.random(n) < 0.8)
    prep = nms_prep(pts, curv, cand, 0.9)
    T = n // TS
    assert prep.nbr_idx.shape[0] == T
    assert torch.equal(torch.sort(prep.oid.long()).values, torch.arange(n))
    assert int(prep.cand.sum()) == int(cand.sum())
    # sorted rows: candidates first, in Morton order
    assert bool((prep.cand[:int(cand.sum())] == 1).all())
    near = torch.zeros((T, T), dtype=torch.bool)
    for t in range(T):
        near[t, prep.nbr_idx[t, :prep.nbr_cnt[t]].long()] = True
    pi, pj = within_pairs(prep.xc[:, :3], prep.cand > 0,
                          torch.tensor(prep.r2))
    assert pi.numel() > 0
    assert bool(near[pi // TS, pj // TS].all())
    assert int(prep.nbr_cnt.max()) < T


def test_dispatch_16384_bucket_is_exact():
    """A 16,384-slot bucket takes the K4 path (its plain version on the
    CPU) and reproduces the serial greedy selection exactly."""
    rng = np.random.default_rng(15)
    n = 16384
    pts = rng.uniform(0, 14, (n, 3)).astype(np.float32)
    curv = rng.random(n).astype(np.float32)
    cand = rng.random(n) < 0.62
    assert nms_path(n) == "kernel"
    cloud = PointCloud(xyz=torch.from_numpy(pts),
                       mask=torch.ones(n, dtype=torch.bool))
    sel, rounds = non_max_suppression(cloud, torch.from_numpy(curv),
                                      torch.from_numpy(cand), radius=0.7)
    want = _greedy(pts, curv, cand, 0.7)
    assert 9000 < cand.sum() < 11000
    assert np.array_equal(sel.numpy(), want)
    assert rounds >= 1
    # nothing selected lies within the radius of another selection
    tree = cKDTree(pts[want].astype(np.float64))
    assert len(tree.query_pairs(0.7 * (1 - 1e-6))) == 0


def test_nms_paths():
    assert nms_path(8192) == "brute"
    assert nms_path(8448) == "kernel" and nms_path(131072) == "kernel"
    assert nms_path(8200) == "gather" and nms_path(262144) == "gather"
