"""The row-sharded streaming lane and the ring lane of both packages: the
port over gloo ranks (``shard/launch.py``, one launch a rank count)
against the JAX package's ``ghicp_register_sharded(stream=...)`` and
``ghicp_register_ring`` on ``make_mesh(P)`` (its plain sweep, as its CPU
suite runs it) and against the port's single-device streaming engine, on
the same bits and keypoints.

* the sharded streaming lane on tests/test_shard.py's streaming problem
  (S = C = 256, 2 ranks): equal iterations and correspondences, transform
  within 5e-4 (tests/test_shard.py:103-116's contract);
* the ring on tests/test_stream_engine.py's ring problem (S = C = 512, 441
  random bits, two source variants, 4 ranks) against the port's
  single-device engine: equal matches and correspondences, transform
  within 5e-4, RMSE within 2e-3 (tests/test_stream_engine.py:156-166),
  the fast path with compacted ring sweeps too.  Against the JAX ring the
  same contract holds on a problem whose bits follow the geometry
  (``__graft_entry__._registration_problem``); on the random-bit problem
  only the first iteration agrees: its registration is ill-posed, and the
  CD statistics' float32 sums of the JAX package (the penalty's mean - 2
  std cancels most of them; the port sums in float64) move the penalty
  by ~2e-4 relative, enough to send the two packages' trajectories apart
  from the second iteration on, as the port's one-iteration parity from
  identical states (tests/test_torch_stream_engine.py) does not;
* both lanes with compacted sweeps (64-row blocks of open rows, 8
  bidding sweeps a solve, the fast path) against the port's
  single-device engine: the same matching and transform within 5e-4;
* ``ring_sweep`` alone, whole and on a subset of rows (the compact form),
  against one plain sweep over the whole target: top-2 and vsel
  bit-equal, the counts equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ghicp_tpu.core.config import CorrespondenceType as JCorr
from ghicp_tpu.core.config import FeatureType as JFeature
from ghicp_tpu.core.config import GHICPConfig as JConfig
from ghicp_tpu.features.bsc import pack_bits as jax_pack_bits
from ghicp_tpu.ops.stream_kernel import make_stream_features as jax_feats
from ghicp_tpu.shard import ghicp_register_sharded, make_mesh
from ghicp_tpu.shard.spmd import ghicp_register_ring
from ghicp_tpu_torch.core.config import (CorrespondenceType, FeatureType,
                                         GHICPConfig)
from ghicp_tpu_torch.features.bsc import pack_bits
from ghicp_tpu_torch.ops.stream_kernel import make_stream_features
from ghicp_tpu_torch.registration.ghicp import ghicp_register
from ghicp_tpu_torch.shard.launch import launch

torch.set_num_threads(1)
KW = dict(correspondence="km", feature="bsc", streaming_cost="on")


def _problem(seed, S):
    """Keypoints (a noisy shuffled copy) and random 441-bit descriptors
    (two source variants), as the JAX tests make them."""
    rng = np.random.default_rng(seed)
    kp = rng.uniform(0, 20, (S, 3)).astype(np.float32)
    kp_s = kp + rng.normal(0, 0.3, kp.shape).astype(np.float32)
    kp_t = kp[rng.permutation(S)]
    bits_s = (rng.random((2, S, 441)) < 0.3).astype(np.float32)
    bits_t = (rng.random((1, S, 441)) < 0.3).astype(np.float32)
    inputs = dict(kp_s=kp_s, mask_s=np.ones(S, bool), kp_t=kp_t,
                  mask_t=np.ones(S, bool), bbx=30.0)
    feats = make_stream_features(pack_bits(torch.from_numpy(bits_s) > 0),
                                 pack_bits(torch.from_numpy(bits_t) > 0))
    return inputs, feats, bits_s, bits_t


def _posed_problem(seed, S):
    """A problem whose bits follow the geometry (the JAX suite's)."""
    import __graft_entry__ as ge
    src, tgt, _, bits_s, bits_t, _ = ge._registration_problem(S, S,
                                                              seed=seed)
    inputs = dict(kp_s=src, mask_s=np.ones(S, bool), kp_t=tgt,
                  mask_t=np.ones(S, bool), bbx=40.0)
    feats = make_stream_features(pack_bits(torch.from_numpy(bits_s) > 0),
                                 pack_bits(torch.from_numpy(bits_t) > 0))
    return inputs, feats, bits_s, bits_t


CASES = {  # name: (seed, S, ranks, config)
    "sharded": (5, 256, 2, dict(max_iterations=4, auction_max_rounds=64)),
    "ring": (7, 512, 4, dict(max_iterations=6, auction_max_rounds=64,
                             stream_fast_path=False)),
    "ring_fast": (17, 512, 4, dict(max_iterations=6, auction_max_rounds=64,
                                   stream_fast_path=True,
                                   stream_open_cap=256)),
    "ring_posed": (2, 512, 4, dict(max_iterations=6, auction_max_rounds=64,
                                   stream_fast_path=False)),
    "sharded_compact": (5, 256, 2, dict(max_iterations=6,
                                        auction_max_rounds=8,
                                        stream_open_cap=64)),
    "ring_compact": (7, 512, 4, dict(max_iterations=6, auction_max_rounds=8,
                                     stream_open_cap=64)),
}


def _inputs(name):
    seed, S = CASES[name][:2]
    return (_posed_problem if name == "ring_posed" else _problem)(seed, S)


def _cfg(name):
    kw = dict(KW, **CASES[name][3])
    return GHICPConfig(**dict(kw, feature=FeatureType(kw["feature"]),
                              correspondence=CorrespondenceType(
                                  kw["correspondence"])))


@pytest.fixture(scope="module")
def port():
    """{case: rank 0's result}, every rank's equal; plus the ring_sweep
    checks of every rank at 4 ranks."""
    out = {}
    jobs = []
    for name in ("sharded", "sharded_compact"):
        inputs, feats, _, _ = _inputs(name)
        jobs.append(("sharded", dict(inputs=inputs, stream=feats,
                                     config=_cfg(name), device="cpu")))
    r2 = launch("many", 2, "gloo", dict(jobs=jobs), timeout=600)
    out["sharded"] = [r[0] for r in r2]
    out["sharded_compact"] = [r[1] for r in r2]
    rng = np.random.default_rng(9)
    S = C = 512
    sweep = dict(kp_s=rng.uniform(0, 20, (S, 3)).astype(np.float32),
                 kp_t=rng.uniform(0, 20, (C, 3)).astype(np.float32),
                 mask_s=rng.random(S) < 0.95, mask_t=rng.random(C) < 0.95,
                 feats=_problem(9, S)[1],
                 prices=rng.uniform(0, 3, C).astype(np.float32),
                 acol=rng.integers(-1, C, S), wed=0.6, wfd=0.4, scale=0.15,
                 subset=np.arange(0, 128, 3), device="cpu")
    jobs = []
    rings = ("ring", "ring_fast", "ring_posed", "ring_compact")
    for name in rings:
        inputs, feats, _, _ = _inputs(name)
        jobs.append(("ring", dict(inputs=inputs, stream=feats,
                                  config=_cfg(name), device="cpu")))
    jobs.append(("ring_sweep_check", sweep))
    r4 = launch("many", 4, "gloo", dict(jobs=jobs), timeout=900)
    for k, name in enumerate(rings):
        out[name] = [r[k] for r in r4]
    out["ring_sweep"] = [r[len(rings)] for r in r4]
    for name in ("sharded", "sharded_compact") + rings:
        for res in out[name][1:]:
            np.testing.assert_array_equal(res["transform"],
                                          out[name][0]["transform"])
        out[name] = out[name][0]
    return out


def _single(name):
    inputs, feats, _, _ = _inputs(name)
    d = inputs
    r = ghicp_register(d["kp_s"], d["mask_s"], d["kp_t"], d["mask_t"], None,
                       d["bbx"], _cfg(name), stream=feats, device="cpu")
    n = r.iterations
    return dict(transform=r.transform.numpy(), iterations=n,
                cor=r.metrics.cor[:n].numpy(), rmse=r.metrics.rmse[:n].numpy(),
                matches=r.matches.numpy(),
                compact=int(r.metrics.compact_sweeps[:n].sum()))


def _jax(name):
    seed, S, P, kw = CASES[name]
    inputs, _, bits_s, bits_t = _inputs(name)
    ps, pt = jax_pack_bits(jnp.asarray(bits_s)), jax_pack_bits(
        jnp.asarray(bits_t))
    jf = jax_feats(packed_s=ps, packed_t=pt, n_bits=bits_s.shape[-1])
    cfg = JConfig(**dict(kw, feature=JFeature.BSC, correspondence=JCorr.KM,
                         streaming_cost="on"))
    d = {k: jnp.asarray(v) for k, v in inputs.items()}
    if name == "sharded":
        r = ghicp_register_sharded(d["kp_s"], d["mask_s"], d["kp_t"],
                                   d["mask_t"], None, d["bbx"], cfg,
                                   make_mesh(P), stream=jf)
    else:
        r = ghicp_register_ring(d["kp_s"], d["mask_s"], d["kp_t"],
                                d["mask_t"], jf, ps, pt, d["bbx"], cfg,
                                make_mesh(P))
    n = int(r.iterations)
    return dict(transform=np.asarray(r.transform), iterations=n,
                cor=np.asarray(r.metrics.cor)[:n],
                rmse=np.asarray(r.metrics.rmse)[:n],
                matches=np.asarray(r.matches))


@pytest.mark.parametrize("ref", ["jax", "single"])
def test_sharded_stream_matches(port, ref):
    mine = port["sharded"]
    theirs = _jax("sharded") if ref == "jax" else _single("sharded")
    assert mine["iterations"] == theirs["iterations"]
    np.testing.assert_array_equal(mine["cor"], theirs["cor"])
    np.testing.assert_allclose(mine["transform"], theirs["transform"],
                               atol=5e-4)
    assert len(mine["matches"]) == 256


@pytest.mark.parametrize("ref", ["jax posed", "single", "single posed"])
def test_ring_matches(port, ref):
    name = "ring_posed" if "posed" in ref else "ring"
    mine = port[name]
    theirs = _jax(name) if ref.startswith("jax") else _single(name)
    assert mine["iterations"] == theirs["iterations"]
    np.testing.assert_array_equal(mine["matches"], theirs["matches"])
    np.testing.assert_array_equal(mine["cor"], theirs["cor"])
    np.testing.assert_allclose(mine["transform"], theirs["transform"],
                               atol=5e-4)
    np.testing.assert_allclose(mine["rmse"], theirs["rmse"], atol=2e-3)


def test_ring_first_iteration_matches_jax(port):
    """The random-bit problem: the first iteration (identical start state
    in both packages) has the JAX ring's correspondences."""
    mine, theirs = port["ring"], _jax("ring")
    assert mine["cor"][0] == theirs["cor"][0]
    np.testing.assert_allclose(mine["rmse"][0], theirs["rmse"][0],
                               rtol=1e-4)


def test_ring_fast_path_matches_single(port):
    """The warm fast path and compacted ring sweeps (stream_open_cap 256
    of 128 rows a rank: every rank compacts or none)."""
    mine, theirs = port["ring_fast"], _single("ring_fast")
    np.testing.assert_array_equal(mine["cor"], theirs["cor"])
    np.testing.assert_allclose(mine["transform"], theirs["transform"],
                               atol=5e-4)


@pytest.mark.parametrize("name", ["sharded_compact", "ring_compact"])
def test_compacted_sweeps_with_row_offsets(port, name):
    """Open rows compacted into 64-row blocks on every rank (the ring: all
    ranks or none, by their largest open count), global row ids from the
    rank's offset: the single-device engine's matching."""
    mine, theirs = port[name], _single(name)
    assert theirs["compact"] > 0
    np.testing.assert_array_equal(mine["matches"], theirs["matches"])
    np.testing.assert_array_equal(mine["cor"], theirs["cor"])
    np.testing.assert_allclose(mine["transform"], theirs["transform"],
                               atol=5e-4)


@pytest.mark.parametrize("form", ["full", "compact"])
def test_ring_sweep_alone_equals_one_sweep(port, form):
    for r, res in enumerate(port["ring_sweep"]):
        c = res[form]
        assert c["equal"] and c["maxes_equal"], (r, c)
        assert c["sums_rel"] <= 1e-6, (r, c)
        # the whole sweep: n - 1 transfers of the block (the last step
        # keeps it)
        assert res["collectives"]["ppermute"][0] == 3
