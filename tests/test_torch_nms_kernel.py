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


# ---------------------------------------------------------------------------
# K4's work split: a model of csrc/nms.cu
# ---------------------------------------------------------------------------

_WARPS, _CHUNK = TS // 32, 16


def _k4_model(prep, rng, max_rounds=128):
    """nms.cu's fixed point, item by item: one state int a slot (-1 dead,
    else a round stamp), each phase's items in a shuffled order, each item
    staging its rows and columns from the live state or from the state at
    the start of the phase (a concurrent item may or may not see another's
    writes), the compacted sides split over warps (spare warps splitting the
    columns), each warp's walk stopping once its lanes are settled, first
    writes counted by the exchange's old value, and alive_{r+1} = L_r -
    S_r.  Returns (selected [N] bool in the original order, rounds,
    distance tests walked)."""
    from ghicp_tpu_torch.ops.nms_kernel import _d2
    N = prep.oid.shape[0]
    T = N // TS
    xc, oid = prep.xc, prep.oid.numpy()
    st = np.where(prep.cand.numpy() != 0, 0, -1)
    codes = prep.items.numpy()[:int(prep.n_items[0])]
    nbr = prep.nbr_idx.numpy()
    cnt = np.zeros(2 * max_rounds + 1, np.int64)
    cnt[0] = int((st == 0).sum())
    n_alive, r, walked = cnt[0], 0, 0
    while n_alive > 0 and r < max_rounds:
        for win in (False, True):
            slot = 2 * r + (2 if win else 1)
            start = st.copy()
            for code in rng.permutation(codes):
                k, t = divmod(int(code), T)
                u = nbr[t, k]
                seen = st if rng.random() < 0.5 else start
                rs = t * TS + np.arange(TS)
                cs = u * TS + np.arange(TS)
                rows = rs[seen[rs] == (r + 1 if win else r)]
                cols = cs[(seen[cs] == r) if win else (seen[cs] >= r)]
                if not rows.size or not cols.size:
                    continue
                nrw = -(-rows.size // 32)
                ncs = _WARPS // nrw
                chunk = -(-cols.size // ncs)
                for w in rng.permutation(nrw * ncs):
                    lanes = rows[(w % nrw) * 32:(w % nrw) * 32 + 32]
                    part = cols[(w // nrw) * chunk:(w // nrw + 1) * chunk]
                    if not part.size:
                        continue
                    near = (_d2(xc[lanes, :3], xc[part, :3])
                            <= prep.r2).numpy()
                    if win:
                        hit = near
                    else:
                        ci, cj = xc[lanes, 3].numpy(), xc[part, 3].numpy()
                        beat = ((cj[None, :] > ci[:, None])
                                | ((cj[None, :] == ci[:, None])
                                   & (oid[part][None, :]
                                      < oid[lanes][:, None])))
                        hit = near & beat
                    # the walk stops at the first vote after every lane is
                    # settled; it decides nothing
                    first = np.where(hit.any(axis=1), hit.argmax(axis=1),
                                     part.size)
                    stop = min(part.size, -(-(int(first.max()) + 1)
                                            // _CHUNK) * _CHUNK)
                    walked += stop * lanes.size
                    for i in lanes[hit.any(axis=1)]:
                        old = st[i]
                        st[i] = -1 if win else r + 1
                        cnt[slot] += old == (r + 1 if win else r)
        n_alive = cnt[2 * r + 1] - cnt[2 * r + 2]
        r += 1
    sel = np.zeros(N, bool)
    sel[oid] = (st >= 0) & (st < r)
    return sel, r, walked


def _clustered(seed, n, n_cand):
    rng = np.random.default_rng(seed)
    centres = rng.uniform(0, 12, (12, 3))
    pts = centres[rng.integers(0, 12, n)] + rng.normal(0, 0.6, (n, 3))
    curv = rng.uniform(0.05, 1.0, n).astype(np.float32)
    cand = np.zeros(n, bool)
    cand[rng.permutation(n)[:n_cand]] = True
    return pts.astype(np.float32), curv, cand, 0.9


def _k4_case(name):
    if name == "clustered":
        return _clustered(31, 2048, 1700)
    if name == "uniform":
        rng = np.random.default_rng(32)
        pts = rng.uniform(0, 10, (2048, 3)).astype(np.float32)
        curv = rng.random(2048).astype(np.float32)
        return pts, curv, rng.random(2048) < 0.85, 1.0
    if name == "ties":
        # three curvature levels: most neighbours tie, the lower index wins
        pts, _, cand, r = _clustered(33, 1536, 1400)
        rng = np.random.default_rng(34)
        return pts, rng.choice(np.float32([0.2, 0.5, 0.8]), 1536), cand, r
    return _fixture(name)


@pytest.mark.parametrize("name", ["clustered", "uniform", "ties",
                                  "multi_tile", "curvature_ties"])
def test_k4_work_split_model_matches_plain_and_jax(name):
    """The kernel's design (work items of near tile pairs in any order,
    compacted alive and winner walks, warps splitting rows and columns,
    early stops, stamp states and first-write counts) selects what
    ``nms_exact_plain`` and the JAX kernel (interpret mode) select, in as
    many rounds, on clustered and uniform candidates and on exact curvature
    ties; and walks fewer distance tests than the listed tile pairs hold."""
    pts, curv, cand, r = _k4_case(name)
    t = torch.from_numpy
    prep = nms_prep(t(pts), t(curv), t(cand), r)
    want, rounds = nms_exact_plain(t(pts), t(curv), t(cand), r)
    jsel, jrounds = nms_pallas(jnp.asarray(pts), jnp.asarray(curv),
                               jnp.asarray(cand), r, ts=256, interpret=True)
    assert np.array_equal(want.numpy(), np.asarray(jsel))
    assert rounds == int(jrounds)
    assert rounds >= 2
    for seed in (0, 1):
        sel, r_m, walked = _k4_model(prep, np.random.default_rng(seed))
        assert np.array_equal(sel, want.numpy()), seed
        assert r_m == rounds
    listed = 2 * rounds * int(prep.nbr_cnt.sum()) * TS * TS
    assert 0 < walked < listed


def test_prep_items_list_each_near_tile_pair_once():
    """The flat work items are exactly the listed (row tile, k-th near
    tile) pairs, k-major, each once, the rest after them."""
    pts, curv, cand, r = _k4_case("clustered")
    prep = nms_prep(torch.from_numpy(pts), torch.from_numpy(curv),
                    torch.from_numpy(cand), r)
    T, maxn = prep.nbr_idx.shape
    n = int(prep.n_items[0])
    assert n == int(prep.nbr_cnt.sum())
    assert prep.items.shape == (T * maxn,)
    assert prep.items.dtype == torch.int32 and prep.n_items.dtype == torch.int32
    codes = prep.items.numpy()
    assert sorted(codes.tolist()) == list(range(T * maxn))
    k, t = np.divmod(codes[:n], T)
    assert (k < prep.nbr_cnt.numpy()[t]).all()
    assert (np.diff(k) >= 0).all()
    k_rest, t_rest = np.divmod(codes[n:], T)
    assert (k_rest >= prep.nbr_cnt.numpy()[t_rest]).all()
