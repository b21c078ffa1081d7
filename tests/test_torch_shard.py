"""The row-sharded dense engine of both packages: the port over 2 and 4
gloo ranks (``shard/launch.py``, one launch a rank count running every
lane) against the JAX package's ``ghicp_register_sharded`` on
``make_mesh(P)`` over the 8 virtual CPU devices, on the same inputs.

* tests/test_shard.py's ``_problem`` (S 128, T 96, feature none) with NN,
  NNR and KM, and its fused-lane BSC problem (S 256, T 128; the port's
  kernel lane at 128 rows a rank, the XLA lane at 64, as the JAX gate):
  transform within 2e-4, equal iterations and correspondences an
  iteration, RMSE within 1e-3 relative;
* the sharded Gauss-Seidel auction (K2 a sweep a rank with foreign owners,
  S = T = 512, 256 rows a rank): within 1.0 deg of the JAX sharded pose,
  both within 1.5 deg / 0.25 m of the truth (tests/test_shard.py:188-227);
* the sharded ``auction_match`` by energy against the Hungarian optimum
  (tests/test_shard.py:138-170);
* K2's plain version with foreign owners (owner R) bit-equal to the JAX
  kernel in interpret mode, and the sharded branch's K2 calls."""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import ghicp_tpu.matching.auction as jau
import ghicp_tpu.registration.ghicp as jgh
from ghicp_tpu.core.config import CorrespondenceType as JCorr
from ghicp_tpu.core.config import FeatureType as JFeature
from ghicp_tpu.core.config import GHICPConfig as JConfig
from ghicp_tpu.ops.auction_rounds import auction_phase_gs_pallas
from ghicp_tpu.shard import ghicp_register_sharded, make_mesh
from ghicp_tpu_torch.core.comm import Comm
from ghicp_tpu_torch.core.config import (CorrespondenceType, FeatureType,
                                         GHICPConfig)
from ghicp_tpu_torch.matching import auction as tau
from ghicp_tpu_torch.ops.auction_rounds import (auction_phase_gs,
                                                gs_tile_rows)
from ghicp_tpu_torch.registration.pipeline import transform_error
from ghicp_tpu_torch.shard.launch import launch

torch.set_num_threads(1)
RANKS = (2, 4)
CORRS = ("nn", "nnr", "km")


def _problem(seed=0, S=128, T=96, n_live_s=100, n_live_t=90):
    """tests/test_shard.py's problem: a 8 deg / 0.6 m pose, noisy copy."""
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(0, 10, (T, 3)).astype(np.float32)
    theta = np.deg2rad(8.0)
    R = np.array([[np.cos(theta), -np.sin(theta), 0],
                  [np.sin(theta), np.cos(theta), 0], [0, 0, 1]], np.float32)
    t = np.float32([0.5, -0.3, 0.2])
    src = ((tgt[:S] if S <= T else np.concatenate(
        [tgt, rng.uniform(0, 10, (S - T, 3)).astype(np.float32)])) - t) @ R
    src = (src.astype(np.float32)
           + rng.normal(0, 0.005, (S, 3)).astype(np.float32))
    return dict(kp_s=src, mask_s=np.arange(S) < n_live_s, kp_t=tgt,
                mask_t=np.arange(T) < n_live_t,
                fd=np.zeros((S, T), np.float32), bbx=30.0)


def _fused_problem():
    d = _problem(seed=3, S=256, T=128, n_live_s=230, n_live_t=120)
    d["fd"] = np.random.default_rng(4).integers(
        0, 200, d["fd"].shape).astype(np.float32)
    return d


def _gs_problem():
    src, tgt, fd, _, _, T_gt = ge._registration_problem(512, 512, seed=2)
    return dict(kp_s=src, mask_s=np.ones(512, bool), kp_t=tgt,
                mask_t=np.ones(512, bool), fd=fd, bbx=40.0), T_gt


NONE = dict(feature=FeatureType.NONE, estimated_overlap=0.8,
            max_iterations=8, auction_max_rounds=600)
FUSED = dict(feature=FeatureType.BSC, correspondence=CorrespondenceType.KM,
             estimated_overlap=0.8, max_iterations=6,
             auction_max_rounds=600, auction_round_kernel=False)
GS = dict(feature=FeatureType.BSC, correspondence=CorrespondenceType.KM,
          estimated_overlap=0.95, max_iterations=4, auction_max_rounds=8,
          auction_round_kernel=True)


def _cfg(kw, corr=None):
    kw = dict(kw, **({} if corr is None else
                     {"correspondence": CorrespondenceType(corr)}))
    return GHICPConfig(**kw)


def _jcfg(cfg: GHICPConfig) -> JConfig:
    d = dataclasses.asdict(cfg)
    d["feature"] = JFeature(cfg.feature.value)
    d["correspondence"] = JCorr(cfg.correspondence.value)
    return JConfig(**d)


def _cd():
    return np.random.default_rng(1).uniform(0, 10, (64, 64)).astype(
        np.float32)


@pytest.fixture(scope="module")
def port():
    """{P: [job results of rank 0]} with every rank's transform checked
    equal."""
    out = {}
    for P in RANKS:
        jobs = [("sharded", dict(inputs=_problem(), config=_cfg(NONE, c),
                                 device="cpu")) for c in CORRS]
        jobs.append(("sharded", dict(inputs=_fused_problem(),
                                     config=_cfg(FUSED), device="cpu")))
        jobs.append(("auction", dict(cd=_cd(), penalty=6.0,
                                     eps_final=0.001)))
        if P == 2:
            jobs.append(("sharded", dict(inputs=_gs_problem()[0],
                                         config=_cfg(GS), device="cpu")))
        ranks = launch("many", P, "gloo", dict(jobs=jobs), timeout=900)
        for other in ranks[1:]:
            for a, b in zip(ranks[0], other):
                if "transform" in a:
                    np.testing.assert_array_equal(a["transform"],
                                                  b["transform"])
                    np.testing.assert_array_equal(a["matches"],
                                                  b["matches"])
        out[P] = ranks[0]
    return out


@functools.lru_cache(maxsize=None)
def _jax(lane: str, P: int):
    d = (_problem() if lane in CORRS else
         _fused_problem() if lane == "fused" else _gs_problem()[0])
    cfg = _jcfg(_cfg(NONE, lane) if lane in CORRS else
                _cfg(FUSED) if lane == "fused" else _cfg(GS))
    old = (jgh._FUSED_INTERPRET, jau._KERNEL_INTERPRET)
    jgh._FUSED_INTERPRET = lane in ("fused", "gs")
    jau._KERNEL_INTERPRET = lane == "gs"
    try:
        r = ghicp_register_sharded(
            jnp.asarray(d["kp_s"]), jnp.asarray(d["mask_s"]),
            jnp.asarray(d["kp_t"]), jnp.asarray(d["mask_t"]),
            jnp.asarray(d["fd"]), d["bbx"], cfg, make_mesh(P))
    finally:
        jgh._FUSED_INTERPRET, jau._KERNEL_INTERPRET = old
    n = int(r.iterations)
    return dict(transform=np.asarray(r.transform), iterations=n,
                cor=np.asarray(r.metrics.cor)[:n],
                rmse=np.asarray(r.metrics.rmse)[:n])


def _same_run(mine, theirs):
    assert mine["iterations"] == theirs["iterations"]
    np.testing.assert_array_equal(mine["cor"], theirs["cor"])
    np.testing.assert_allclose(mine["rmse"], theirs["rmse"], rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(mine["transform"], theirs["transform"],
                               atol=2e-4)


@pytest.mark.parametrize("P", RANKS)
@pytest.mark.parametrize("corr", CORRS)
def test_none_lanes_match_jax_sharded(port, P, corr):
    _same_run(port[P][CORRS.index(corr)], _jax(corr, P))


@pytest.mark.parametrize("P", RANKS)
def test_fused_lane_matches_jax_sharded(port, P):
    mine = port[P][3]
    _same_run(mine, _jax("fused", P))
    assert len(mine["matches"]) == 256


def test_sharded_gs_lands_the_jax_sharded_pose(port):
    mine, theirs = port[2][5], _jax("gs", 2)
    T_gt = _gs_problem()[1]
    for T in (mine["transform"], theirs["transform"]):
        rot, tr = transform_error(T, T_gt)
        assert rot < 1.5 and tr < 0.25, (rot, tr)
    rot, _ = transform_error(mine["transform"], theirs["transform"])
    assert rot < 1.0, rot


@pytest.mark.parametrize("P", RANKS)
def test_sharded_auction_reaches_the_optimum(port, P):
    from scipy.optimize import linear_sum_assignment
    res, cd, penalty = port[P][4], _cd(), 6.0
    S = T = 64
    w, tj = res["w"], res["tgt_idx"]
    assert res["n_matches"] == w.sum()
    got = sum(-cd[i, tj[i]] for i in range(S) if w[i] > 0) \
        - penalty * (S - int(w.sum()))
    b = np.full((S, T), -penalty)
    b[:S, :T] = np.where(cd < penalty, -cd, -penalty)
    ri, ci = linear_sum_assignment(-b)
    assert got >= b[ri, ci].sum() - S * 0.001 - 1e-3
    # the single-device solve on the same matrix meets the same bound
    one = tau.auction_match(torch.from_numpy(cd), penalty,
                            torch.ones(S, dtype=torch.bool),
                            torch.ones(T, dtype=torch.bool), eps_final=0.001)
    w1, t1 = one.match.w.numpy(), one.match.tgt_idx.numpy()
    single = sum(-cd[i, t1[i]] for i in range(S) if w1[i] > 0) \
        - penalty * (S - int(w1.sum()))
    assert abs(got - single) <= S * 0.001 + 1e-3, (got, single)


def _foreign_state(S, C, seed):
    """A start state with a third of the columns held by another rank's
    rows (owner S), some local rows owning columns, the rest open."""
    rng = np.random.default_rng(seed)
    b = rng.uniform(-20, 0, (S, C)).astype(np.float32)
    owner = np.full(C, -1, np.int32)
    cols = rng.permutation(C)
    owner[cols[:C // 3]] = S
    mine = rng.choice(S, S // 3, replace=False)
    owner[cols[C // 3:C // 3 + len(mine)]] = mine
    p = np.where(owner >= 0, rng.uniform(0, 4, C), 0).astype(np.float32)
    open_ = np.ones(S, np.int32)
    open_[mine] = 0
    return b, p, owner, np.zeros(S, np.int32), open_


@pytest.mark.parametrize("budget", [1, 6])
def test_k2_with_foreign_owners_matches_the_jax_kernel(budget):
    """A rank's shard shape (256 rows of 512 columns, one tile): the port's
    K2 (plain on the CPU) against the JAX GS kernel in interpret mode with
    the same foreign owners: prices, owners, sink flags, sweeps and
    completion bit-equal; a foreign owner never reopens a local row."""
    S, C = 256, 512
    ts = gs_tile_rows(C)
    b, p, owner, sunk, open_ = _foreign_state(S, C, budget)
    bb = torch.from_numpy(b).to(torch.bfloat16)
    got = auction_phase_gs(bb, torch.from_numpy(p), torch.from_numpy(owner),
                           torch.from_numpy(sunk), torch.from_numpy(open_),
                           0.25, -12.0, budget, ts=ts, esc_after=0,
                           esc_period=1, complete_open=budget > 1)
    want = auction_phase_gs_pallas(
        jnp.asarray(bb.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(p), jnp.asarray(owner), jnp.asarray(sunk),
        jnp.asarray(open_), 0.25, -12.0, budget, ts=ts, inner_cap=1,
        esc_after=0, esc_period=1, complete_open=int(budget > 1),
        interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    own = got[1].numpy()
    assert (own == S).sum() > 0 and (own > S).sum() == 0


class _TwoRanks(Comm):
    """Rank 1 of 2 whose peer contributes nothing (the collectives return
    this rank's values): drives the sharded branch in one process."""

    def __init__(self):
        super().__init__()
        self.backend, self.rank, self.size = "test", 1, 2

    def _reduce(self, x, op):
        return torch.as_tensor(x)


def test_sharded_gs_makes_one_sweep_a_k2_call(monkeypatch):
    """The sharded branch (distributed, one phase, the GS shapes): each
    call is one sweep with the kernel's escalation off and no completion,
    rank 0's columns passed with the owner R."""
    S, C = 256, 512
    b, p, owner, _, _ = _foreign_state(S, C, 3)
    acol0 = torch.full((S,), -1, dtype=torch.int64)
    calls = []
    real = tau.auction_phase_gs

    def spy(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)

    monkeypatch.setattr(tau, "auction_phase_gs", spy)
    acol, _, rounds, _, _ = tau.auction_assign(
        torch.from_numpy(b), -12.0, 0.25, 5, use_round_kernel=True,
        n_phases=1, p0=torch.zeros(C), price_uncertainty=0.0, acol0=acol0,
        comm=_TwoRanks())
    assert len(calls) == int(rounds) >= 1
    for a, kw in calls:
        assert a[7] == 1 and kw["esc_after"] == 0
        assert kw["complete_open"] is False and kw["ts"] == gs_tile_rows(C)
    assert (acol >= 0).sum() > 0
