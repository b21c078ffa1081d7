"""The streaming (matrix-free) lane of both packages: one engine iteration
from an identical state (carried across with ``ghicp_tpu_torch.interop``,
the stream carry included), and ``register_pair`` with
``streaming_cost="on"`` against the JAX package; and the port's streaming
and dense engine lanes on one problem."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ghicp_tpu.registration.ghicp as jgh
from ghicp_tpu.core.comm import LOCAL
from ghicp_tpu.core.config import (CorrespondenceType, FeatureType,
                                   GHICPConfig)
from ghicp_tpu.features.bsc import pack_bits as jax_pack_bits
from ghicp_tpu.ops.stream_kernel import make_stream_features as jax_feats
from ghicp_tpu.registration.pipeline import register_pair as jax_register
from ghicp_tpu.registration.pipeline import transform_error
from ghicp_tpu_torch.features.bsc import pack_bits
from ghicp_tpu_torch.interop import (config_from_dict, state_from_numpy,
                                     stream_features_from_numpy)
from ghicp_tpu_torch.io.synthetic import registration_problem, structured_scene
from ghicp_tpu_torch.ops.stream_kernel import make_stream_features
from ghicp_tpu_torch.registration.ghicp import (ghicp_register_chunked,
                                                make_body)
from ghicp_tpu_torch.registration.pipeline import register_pair

torch.set_num_threads(1)
S = T = 512
BASE = GHICPConfig(feature=FeatureType.BSC,
                   correspondence=CorrespondenceType.KM, max_iterations=6,
                   auction_max_rounds=4, streaming_cost="on",
                   stream_open_cap=128)


def _to_numpy(st):
    d = {f: np.asarray(getattr(st, f)) for f in st._fields
         if f not in ("metrics", "scarry")}
    d["metrics"] = {f: np.asarray(getattr(st.metrics, f))
                    for f in st.metrics._fields}
    d["scarry"] = {f: np.asarray(getattr(st.scarry, f))
                   for f in st.scarry._fields}
    return d


@pytest.fixture(scope="module")
def jax_states():
    """The JAX engine's states at iterations 0-3 (one compiled body)."""
    src, tgt, _, bits_s, bits_t, _ = registration_problem(S, T, seed=21)
    jf = jax_feats(packed_s=jax_pack_bits(jnp.asarray(bits_s)),
                   packed_t=jax_pack_bits(jnp.asarray(bits_t)), n_bits=441)
    ms, mt = np.ones(S, bool), np.ones(T, bool)
    ms[-16:] = False
    body_j = jax.jit(jgh._make_body(jnp.asarray(tgt), jnp.asarray(ms),
                                    jnp.asarray(mt), None, jnp.float32(40.0),
                                    BASE, LOCAL, S, stream=jf))
    states = [jgh._initial_state(jnp.asarray(src), T, BASE)]
    for _ in range(3):
        states.append(body_j(states[-1]))
    return tgt, ms, mt, jf, states


@pytest.mark.parametrize("start_it", [0, 2])
def test_one_iteration_from_identical_state(jax_states, start_it):
    """it 0 runs sweep 0 (the statistics penalty); it 2 the fast path from
    the carried hints."""
    tgt, ms, mt, jf, states = jax_states
    st, want = states[start_it], states[start_it + 1]
    assert bool(st.scarry.ok) == (start_it > 0)
    cfg = config_from_dict(dataclasses.asdict(BASE))
    feats = stream_features_from_numpy(np.asarray(jf.fs), np.asarray(jf.ft),
                                       np.asarray(jf.na), np.asarray(jf.nb),
                                       device="cpu")
    body_t = make_body(torch.from_numpy(tgt), torch.from_numpy(ms),
                       torch.from_numpy(mt), None, 40.0, cfg, feats)
    got = body_t(state_from_numpy(_to_numpy(st), "cpu",
                                  BASE.max_iterations))
    i = start_it
    assert int(got.metrics.cor[i]) == int(np.asarray(want.metrics.cor)[i])
    assert int(got.metrics.rounds[i]) == int(
        np.asarray(want.metrics.rounds)[i])
    np.testing.assert_allclose(got.rt.numpy(), np.asarray(want.rt),
                               atol=1e-4)
    # rtol: the CD statistics are summed in another order (float64 here)
    np.testing.assert_allclose(float(got.pen_prev), float(want.pen_prev),
                               rtol=1e-3)
    assert got.scarry.ok
    np.testing.assert_allclose(got.scarry.v1_ub.numpy(),
                               np.asarray(want.scarry.v1_ub), rtol=1e-4,
                               atol=1e-3)


def _pair(seed=0, n=20000, extent=10.0, rot_deg=6.0):
    """tests/test_stream_engine.py's pair."""
    rng = np.random.default_rng(seed)
    pts = structured_scene(rng, n, extent=extent)
    th = np.deg2rad(rot_deg)
    R = np.array([[np.cos(th), -np.sin(th), 0],
                  [np.sin(th), np.cos(th), 0], [0, 0, 1]], np.float32)
    t = np.float32([0.6, -0.4, 0.1])
    T_gt = np.eye(4, dtype=np.float32)
    T_gt[:3, :3] = R
    T_gt[:3, 3] = t
    src = ((pts - t) @ R + rng.normal(0, 0.01, pts.shape)).astype(np.float32)
    tgt = (pts + rng.normal(0, 0.01, pts.shape)).astype(np.float32)
    return src, tgt, T_gt


_CFG = GHICPConfig(feature=FeatureType.BSC,
                   correspondence=CorrespondenceType.KM, voxel_size=0.15,
                   neighborhood_radius=0.5, non_max_radius=1.0,
                   min_neighbors=8, estimated_overlap=0.9, max_iterations=40,
                   ransac_hypotheses=4096, streaming_cost="on")


def test_register_pair_streaming_matches_jax():
    # a fixed pair (the JAX test's seed is a salted string hash)
    src, tgt, T_gt = _pair(seed=0)
    got = register_pair(src, tgt, config_from_dict(dataclasses.asdict(_CFG)),
                        device="cpu")
    assert got.streaming
    want = jax_register(src, tgt, _CFG)
    rot, tr = transform_error(got.transform, np.asarray(want.transform))
    assert rot < 0.5 and tr < 0.1, (rot, tr)
    for T_est in (got.transform, np.asarray(want.transform)):
        rot, tr = transform_error(T_est, T_gt)
        assert rot < 2.0 and tr < 0.3, (rot, tr)
    m = got.result.matches.numpy()
    m = m[m >= 0]
    assert len(m) > 100 and len(np.unique(m)) == len(m)


def test_streaming_and_dense_lanes_agree():
    """The port's two engine lanes on the same keypoints and features (the
    dense lane's FD is the streaming lane's factors multiplied out)."""
    src, tgt, fd, bits_s, bits_t, T_gt = registration_problem(S, T, seed=23)
    ms, mt = np.ones(S, bool), np.ones(T, bool)
    cfg = config_from_dict(dataclasses.asdict(
        dataclasses.replace(BASE, max_iterations=30)))
    feats = make_stream_features(pack_bits(torch.from_numpy(bits_s)),
                                 pack_bits(torch.from_numpy(bits_t)))
    dense = ghicp_register_chunked(src, ms, tgt, mt, fd, 40.0, cfg,
                                   device="cpu")
    stream = ghicp_register_chunked(src, ms, tgt, mt, None, 40.0, cfg,
                                    device="cpu", stream=feats)
    rot, tr = transform_error(stream.transform.numpy(),
                              dense.transform.numpy())
    assert rot < 0.5 and tr < 0.1, (rot, tr)
    rot, tr = transform_error(stream.transform.numpy(), T_gt)
    assert rot < 1.0 and tr < 0.2, (rot, tr)
    m = stream.matches.numpy()
    m = m[m >= 0]
    assert len(m) > S // 2 and len(np.unique(m)) == len(m)


def test_identity_start_trajectory_matches_jax():
    """Twenty iterations from identity, convergence off: the fast path
    (carried hints) from iteration 2 on, the same trajectory as the JAX
    package iteration by iteration."""
    n = 1024
    src, tgt, _, bits_s, bits_t, _ = registration_problem(n, n, seed=5,
                                                          rot_deg=12.0)
    cfg = dataclasses.replace(BASE, max_iterations=20,
                              converge_translation=0.0,
                              converge_rotation=0.0, stream_open_cap=256)
    jf = jax_feats(packed_s=jax_pack_bits(jnp.asarray(bits_s)),
                   packed_t=jax_pack_bits(jnp.asarray(bits_t)), n_bits=441)
    m = np.ones(n, bool)
    want = jgh.ghicp_register(jnp.asarray(src), jnp.asarray(m),
                              jnp.asarray(tgt), jnp.asarray(m), None,
                              jnp.float32(40.0), cfg, stream=jf)
    feats = stream_features_from_numpy(np.asarray(jf.fs), np.asarray(jf.ft),
                                       np.asarray(jf.na), np.asarray(jf.nb),
                                       device="cpu")
    got = ghicp_register_chunked(src, m, tgt, m, None, 40.0,
                                 config_from_dict(dataclasses.asdict(cfg)),
                                 device="cpu", stream=feats)
    assert int(got.metrics.fast.sum()) == 18
    np.testing.assert_array_equal(got.metrics.cor.numpy(),
                                  np.asarray(want.metrics.cor))
    np.testing.assert_array_equal(got.metrics.rounds.numpy(),
                                  np.asarray(want.metrics.rounds))
    np.testing.assert_allclose(got.transform.numpy(),
                               np.asarray(want.transform), atol=1e-5)


@pytest.mark.parametrize("standardize", ["rows", "dims"])
def test_mult_blend_streaming_engine_matches_jax(standardize):
    """The FPFH ("rows") / RoPS ("dims") streaming lane: factors built by
    the JAX package and carried across, both engines eight iterations from
    identity with convergence off; no fast path (the multiplicative blend
    has no drift bound), the same pose; and the port's dense similarity
    lane on the same descriptors lands it too."""
    from ghicp_tpu.features.fpfh import fpfh_similarity_matrix
    from ghicp_tpu.features.rops import rops_similarity_matrix
    from ghicp_tpu_torch.interop import desc_features_from_numpy
    src, tgt, _, _, _, T_gt = registration_problem(S, T, seed=31,
                                                   rot_deg=8.0)
    D = 33 if standardize == "rows" else 135
    rng = np.random.default_rng(9)
    moved = src @ T_gt[:3, :3].T + T_gt[:3, 3]
    partner = ((moved[:, None] - tgt[None]) ** 2).sum(-1).argmin(axis=1)
    desc_t = rng.gamma(2.0, 5.0, (T, D)).astype(np.float32)
    desc_s = (desc_t[partner] + rng.normal(0, 4.0, (S, D))).astype(np.float32)
    feature = (FeatureType.FPFH if standardize == "rows"
               else FeatureType.ROPS)
    cfg = dataclasses.replace(BASE, feature=feature, max_iterations=8,
                              converge_translation=0.0,
                              converge_rotation=0.0)
    jf = jax_feats(desc_s=jnp.asarray(desc_s), desc_t=jnp.asarray(desc_t),
                   standardize=standardize)
    m = np.ones(S, bool)
    m[-8:] = False
    mt = np.ones(T, bool)
    want = jgh.ghicp_register(jnp.asarray(src), jnp.asarray(m),
                              jnp.asarray(tgt), jnp.asarray(mt), None,
                              jnp.float32(40.0), cfg, stream=jf)
    cfg_t = config_from_dict(dataclasses.asdict(cfg))
    feats = desc_features_from_numpy(np.asarray(jf.fs), np.asarray(jf.ft), D,
                                     device="cpu")
    got = ghicp_register_chunked(src, m, tgt, mt, None, 40.0, cfg_t,
                                 device="cpu", stream=feats)
    assert int(got.metrics.fast.sum()) == 0
    rot, tr = transform_error(got.transform.numpy(),
                              np.asarray(want.transform))
    assert rot < 0.5 and tr < 0.1, (rot, tr)
    cor_j = np.asarray(want.metrics.cor)
    assert np.all(np.abs(got.metrics.cor.numpy() - cor_j)
                  <= np.maximum(3, 0.05 * cor_j))
    sim = (fpfh_similarity_matrix if standardize == "rows"
           else rops_similarity_matrix)(jnp.asarray(desc_s),
                                        jnp.asarray(desc_t))
    dense = ghicp_register_chunked(src, m, tgt, mt, np.array(sim), 40.0,
                                   cfg_t, device="cpu")
    for T_est in (got.transform.numpy(), dense.transform.numpy()):
        rot, tr = transform_error(T_est, T_gt)
        assert rot < 1.0 and tr < 0.2, (rot, tr)
    rot, tr = transform_error(got.transform.numpy(),
                              dense.transform.numpy())
    assert rot < 0.5 and tr < 0.1, (rot, tr)
    mm = got.matches.numpy()
    mm = mm[mm >= 0]
    assert len(np.unique(mm)) == len(mm)


# ---------------------------------------------------------------------------
# NN / NNR and feature "none" on the streaming lane
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("feature,corr", [
    (FeatureType.BSC, CorrespondenceType.NN),
    (FeatureType.BSC, CorrespondenceType.NNR),
    (FeatureType.NONE, CorrespondenceType.NN),
    (FeatureType.NONE, CorrespondenceType.NNR),
    (FeatureType.NONE, CorrespondenceType.KM)])
def test_streaming_nn_nnr_none_match_jax(feature, corr, monkeypatch):
    """Eight iterations from identity, convergence off, against the JAX
    package's streaming lane (its ``stream_sweep_ref``): cor and rounds
    equal every iteration, the pose within 1e-4.  NN / NNR: one sweep an
    iteration (K5, NNR with its column side), rounds 0, no final resolve.
    None + KM: the matrix-free auction on the none lane, never the BSC
    carry fast path."""
    import ghicp_tpu_torch.registration.ghicp as tgh
    from ghicp_tpu.ops.stream_kernel import StreamFeatures
    from ghicp_tpu_torch.ops.stream_kernel import NoFeatures
    src, tgt, _, bits_s, bits_t, T_gt = registration_problem(S, T, seed=13,
                                                             rot_deg=6.0)
    ms, mt = np.ones(S, bool), np.ones(T, bool)
    ms[-16:] = False
    if feature == FeatureType.BSC:
        jf = jax_feats(packed_s=jax_pack_bits(jnp.asarray(bits_s)),
                       packed_t=jax_pack_bits(jnp.asarray(bits_t)),
                       n_bits=441)
        feats = stream_features_from_numpy(
            np.asarray(jf.fs), np.asarray(jf.ft), np.asarray(jf.na),
            np.asarray(jf.nb), device="cpu")
    else:
        # the JAX pipeline's none factors: zero bits, FD identically 0
        jf = StreamFeatures(fs=jnp.zeros((1, S, 128), jnp.bfloat16),
                            ft=jnp.zeros((T, 128), jnp.bfloat16),
                            na=jnp.zeros((1, S)), nb=jnp.zeros((T,)))
        feats = NoFeatures(S)
    cfg = dataclasses.replace(BASE, feature=feature, correspondence=corr,
                              max_iterations=8, converge_translation=0.0,
                              converge_rotation=0.0)
    want = jgh.ghicp_register_chunked(
        jnp.asarray(src), jnp.asarray(ms), jnp.asarray(tgt), jnp.asarray(mt),
        None, jnp.float32(40.0), cfg, stream=jf)
    resolves = []
    fr = tgh.final_resolve
    monkeypatch.setattr(tgh, "final_resolve", lambda *a, **k: (
        resolves.append(1), fr(*a, **k))[1])
    got = ghicp_register_chunked(src, ms, tgt, mt, None, 40.0,
                                 config_from_dict(dataclasses.asdict(cfg)),
                                 device="cpu", stream=feats)
    np.testing.assert_array_equal(got.metrics.cor.numpy(),
                                  np.asarray(want.metrics.cor))
    np.testing.assert_array_equal(got.metrics.rounds.numpy(),
                                  np.asarray(want.metrics.rounds))
    np.testing.assert_allclose(got.transform.numpy(),
                               np.asarray(want.transform), atol=1e-4)
    assert int(got.metrics.fast.sum()) == 0
    km = corr == CorrespondenceType.KM
    assert len(resolves) == int(km)
    assert bool(got.metrics.rounds.any()) == km
    rot, tr = transform_error(got.transform.numpy(), T_gt)
    assert rot < 0.5 and tr < 0.05, (rot, tr)
