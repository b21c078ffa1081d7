"""The GH-ICP engine of both packages: one iteration from an identical state
(carried across with ``ghicp_tpu_torch.interop``) and a whole run, with the
JAX package's fused and GS kernels in interpret mode."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import ghicp_tpu.matching.auction as jau
import ghicp_tpu.registration.ghicp as jgh
from ghicp_tpu.core.comm import LOCAL
from ghicp_tpu.core.config import (CorrespondenceType, FeatureType,
                                   GHICPConfig)
from ghicp_tpu.registration.pipeline import transform_error
from ghicp_tpu_torch.interop import config_from_dict, state_from_numpy
from ghicp_tpu_torch.registration.ghicp import (ghicp_register_chunked,
                                                make_body)

torch.set_num_threads(1)
S = T = 1024
BASE = GHICPConfig(feature=FeatureType.BSC,
                   correspondence=CorrespondenceType.KM, max_iterations=6,
                   auction_max_rounds=4)


@pytest.fixture(scope="module")
def problem():
    return ge._registration_problem(S, T, seed=13)


@pytest.fixture
def interpret():
    old = (jgh._FUSED_INTERPRET, jau._KERNEL_INTERPRET)
    jgh._FUSED_INTERPRET = jau._KERNEL_INTERPRET = True
    try:
        yield
    finally:
        jgh._FUSED_INTERPRET, jau._KERNEL_INTERPRET = old


def _to_numpy(st):
    d = {f: np.asarray(getattr(st, f)) for f in st._fields
         if f not in ("metrics", "scarry")}
    d["metrics"] = {f: np.asarray(getattr(st.metrics, f))
                    for f in st.metrics._fields}
    return d


@pytest.mark.parametrize("start_it", [0, 2])
def test_one_iteration_from_identical_state(problem, interpret, start_it):
    """it 0 takes the full solve (K1 + K2), it 2 the warm kernel (K3)."""
    src, tgt, fd, _, _, _ = problem
    ms, mt = np.ones(S, bool), np.ones(T, bool)
    body_j = jax.jit(jgh._make_body(jnp.asarray(tgt), jnp.asarray(ms),
                                    jnp.asarray(mt), jnp.asarray(fd),
                                    jnp.float32(40.0), BASE, LOCAL, S))
    st = jgh._initial_state(jnp.asarray(src), T, BASE)
    for _ in range(start_it):
        st = body_j(st)
    want = body_j(st)
    cfg = config_from_dict(dataclasses.asdict(BASE))
    body_t = make_body(torch.from_numpy(tgt), torch.from_numpy(ms),
                       torch.from_numpy(mt), torch.from_numpy(fd), 40.0, cfg)
    got = body_t(state_from_numpy(_to_numpy(st), "cpu",
                                  BASE.max_iterations))
    i = start_it
    assert int(got.metrics.cor[i]) == int(np.asarray(want.metrics.cor)[i])
    np.testing.assert_allclose(got.rt.numpy(), np.asarray(want.rt),
                               atol=1e-4)
    # rtol: the CD statistics are float32 sums over S*T pairs in another
    # order, and mean - 2 std cancels part of their magnitude
    np.testing.assert_allclose(float(got.pen_prev), float(want.pen_prev),
                               rtol=1e-3)


def test_whole_engine(problem, interpret):
    src, tgt, fd, _, _, T_gt = problem
    ms, mt = np.ones(S, bool), np.ones(T, bool)
    want = jgh.ghicp_register(jnp.asarray(src), jnp.asarray(ms),
                              jnp.asarray(tgt), jnp.asarray(mt),
                              jnp.asarray(fd), jnp.float32(40.0), BASE)
    cfg = config_from_dict(dataclasses.asdict(BASE))
    got = ghicp_register_chunked(src, ms, tgt, mt, fd, 40.0, cfg,
                                 device="cpu")
    Tj, Tt = np.asarray(want.transform), got.transform.numpy()
    rot, tr = transform_error(Tt, Tj)
    assert rot < 0.1 and tr < 0.02, (rot, tr)
    for T_est in (Tj, Tt):
        rot, tr = transform_error(T_est, T_gt)
        assert rot < 1.0 and tr < 0.2, (rot, tr)
    m = got.matches.numpy()
    m = m[m >= 0]
    assert len(m) > S // 2 and len(np.unique(m)) == len(m)


def _descriptors(src, tgt, T_gt, D, seed):
    """Descriptors [S, D] / [T, D] whose true pairs correlate: each source
    row copies its true partner's (found through the known pose) with
    noise."""
    rng = np.random.default_rng(seed)
    moved = src @ T_gt[:3, :3].T + T_gt[:3, 3]
    d2 = ((moved[:, None, :] - tgt[None, :, :]) ** 2).sum(-1)
    partner = d2.argmin(axis=1)
    desc_t = rng.gamma(2.0, 5.0, (len(tgt), D)).astype(np.float32)
    desc_s = (desc_t[partner]
              + rng.normal(0, 4.0, (len(src), D))).astype(np.float32)
    return desc_s, desc_t


@pytest.mark.parametrize("feature", [FeatureType.FPFH, FeatureType.ROPS])
def test_whole_engine_mult_blend(problem, interpret, feature, monkeypatch):
    """The FPFH / RoPS lane (multiplicative blend, K1 and K3 in their
    mult form, K2) from the same similarity matrix and config as the JAX
    engine with its fused and warm kernels in interpret mode."""
    import ghicp_tpu_torch.registration.ghicp as tgh
    from ghicp_tpu.features.fpfh import fpfh_similarity_matrix
    from ghicp_tpu.features.rops import rops_similarity_matrix
    calls = []
    warm = tgh.auction_warm_fused
    monkeypatch.setattr(tgh, "auction_warm_fused", lambda *a, **k: (
        calls.append(k["mult_blend"]), warm(*a, **k))[1])
    src, tgt, _, _, _, T_gt = problem
    ms, mt = np.ones(S, bool), np.ones(T, bool)
    ms[-32:] = False
    if feature == FeatureType.FPFH:
        ds, dt = _descriptors(src, tgt, T_gt, 33, seed=3)
        sim = fpfh_similarity_matrix(jnp.asarray(ds), jnp.asarray(dt))
    else:
        ds, dt = _descriptors(src, tgt, T_gt, 135, seed=4)
        sim = rops_similarity_matrix(jnp.asarray(ds), jnp.asarray(dt))
    sim = np.asarray(sim)
    # convergence off: the iterations past the second take the warm kernel
    cfg_j = dataclasses.replace(BASE, feature=feature, max_iterations=6,
                                converge_translation=0.0,
                                converge_rotation=0.0)
    want = jgh.ghicp_register_chunked(
        jnp.asarray(src), jnp.asarray(ms), jnp.asarray(tgt), jnp.asarray(mt),
        jnp.asarray(sim), jnp.float32(40.0), cfg_j)
    cfg = config_from_dict(dataclasses.asdict(cfg_j))
    got = ghicp_register_chunked(src, ms, tgt, mt, sim, 40.0, cfg,
                                 device="cpu")
    Tj, Tt = np.asarray(want.transform), got.transform.numpy()
    rot, tr = transform_error(Tt, Tj)
    assert rot < 0.5 and tr < 0.1, (rot, tr)
    for T_est in (Tj, Tt):
        rot, tr = transform_error(T_est, T_gt)
        assert rot < 1.0 and tr < 0.2, (rot, tr)
    # iterations from the third on took the mult form of K3
    assert calls and all(calls) and len(calls) == int(got.iterations) - 2
    m = got.matches.numpy()
    m = m[m >= 0]
    # the late penalty (RMSE * scale) shrinks with the RMSE, so few pairs
    # stay matched once the pose is exact: in both packages alike
    n_j = int((np.asarray(want.matches) >= 0).sum())
    assert abs(len(m) - n_j) <= max(3, 0.2 * n_j), (len(m), n_j)
    assert len(np.unique(m)) == len(m)


def test_xla_lane_mult_blend_matches_jax(problem):
    """The XLA lane with the FPFH blend (``blend_fpfh`` and the Jacobi
    rounds, ``fused_cost_kernel=False``) against the JAX package's XLA
    lane, iteration by iteration, from the same similarity matrix."""
    from ghicp_tpu.features.fpfh import fpfh_similarity_matrix
    src, tgt, _, _, _, T_gt = problem
    n = 512
    src = src[:n]
    ms, mt = np.ones(n, bool), np.ones(T, bool)
    ds, dt = _descriptors(src, tgt, T_gt, 33, seed=5)
    sim = np.asarray(fpfh_similarity_matrix(jnp.asarray(ds),
                                            jnp.asarray(dt)))
    cfg_j = dataclasses.replace(BASE, feature=FeatureType.FPFH,
                                fused_cost_kernel=False,
                                auction_round_kernel=False,
                                max_iterations=5, converge_translation=0.0,
                                converge_rotation=0.0)
    want = jgh.ghicp_register(jnp.asarray(src), jnp.asarray(ms),
                              jnp.asarray(tgt), jnp.asarray(mt),
                              jnp.asarray(sim), jnp.float32(40.0), cfg_j)
    got = ghicp_register_chunked(src, ms, tgt, mt, sim, 40.0,
                                 config_from_dict(dataclasses.asdict(cfg_j)),
                                 device="cpu")
    cor_j = np.asarray(want.metrics.cor)
    assert np.all(np.abs(got.metrics.cor.numpy() - cor_j)
                  <= np.maximum(2, 0.02 * cor_j))
    # late penalties are the matched RMSE * scale: a pair matched in one
    # package and not the other moves it by a fraction of a percent
    np.testing.assert_allclose(got.metrics.penalty.numpy(),
                               np.asarray(want.metrics.penalty), rtol=5e-3)
    rot, tr = transform_error(got.transform.numpy(),
                              np.asarray(want.transform))
    assert rot < 0.1 and tr < 0.02, (rot, tr)
