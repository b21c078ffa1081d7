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


# ---------------------------------------------------------------------------
# NN / NNR and feature "none" on the dense lanes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    """S = T = 512 from the port's problem generator; the last 16 source
    slots masked."""
    from ghicp_tpu_torch.io.synthetic import registration_problem
    src, tgt, fd, _, _, T_gt = registration_problem(512, 512, seed=13,
                                                    rot_deg=6.0)
    ms, mt = np.ones(512, bool), np.ones(512, bool)
    ms[-16:] = False
    return src, tgt, fd, ms, mt, T_gt


def _no_final_resolve(monkeypatch):
    import ghicp_tpu_torch.registration.ghicp as tgh

    def refuse(*a, **k):
        raise AssertionError("final_resolve ran")
    monkeypatch.setattr(tgh, "final_resolve", refuse)


@pytest.mark.parametrize("feature", [FeatureType.BSC, FeatureType.NONE])
@pytest.mark.parametrize("corr", [CorrespondenceType.NN,
                                  CorrespondenceType.NNR])
def test_dense_nn_nnr_matches_jax(small, feature, corr, monkeypatch):
    """NN / NNR (the XLA lane with the dense matchers; no kernel lane, no
    auction) against the JAX package, twelve iterations with convergence
    off: cor equal every iteration, the pose within 1e-4, energy and
    rounds 0, no final resolve (the verdict reads the last iteration)."""
    src, tgt, fd, ms, mt, T_gt = small
    if feature == FeatureType.NONE:
        fd = np.zeros_like(fd)
    cfg = dataclasses.replace(BASE, feature=feature, correspondence=corr,
                              max_iterations=12, converge_translation=0.0,
                              converge_rotation=0.0)
    want = jgh.ghicp_register_chunked(
        jnp.asarray(src), jnp.asarray(ms), jnp.asarray(tgt), jnp.asarray(mt),
        jnp.asarray(fd), jnp.float32(40.0), cfg)
    _no_final_resolve(monkeypatch)
    got = ghicp_register_chunked(src, ms, tgt, mt, fd, 40.0,
                                 config_from_dict(dataclasses.asdict(cfg)),
                                 device="cpu")
    np.testing.assert_array_equal(got.metrics.cor.numpy(),
                                  np.asarray(want.metrics.cor))
    np.testing.assert_allclose(got.transform.numpy(),
                               np.asarray(want.transform), atol=1e-4)
    assert not got.metrics.energy.any() and not got.metrics.rounds.any()
    assert got.final_rmse == float(got.metrics.rmse_after[11])
    rot, tr = transform_error(got.transform.numpy(), T_gt)
    assert rot < 0.5 and tr < 0.05, (rot, tr)


def test_dense_none_km_kernel_lane_matches_jax(small, monkeypatch):
    """Feature none with KM on the kernel lane (K1 with W_FD = 0 and its
    statistics on every iteration, then K2; here their plain versions)
    against the JAX package with its fused and GS kernels in interpret
    mode: cor every iteration, the penalty max(mean ED, 1), the pose, the
    final resolve's matching on an ED cost."""
    import ghicp_tpu_torch.registration.ghicp as tgh
    src, tgt, fd, ms, mt, _ = small
    fd = np.zeros_like(fd)
    cfg = dataclasses.replace(BASE, feature=FeatureType.NONE,
                              max_iterations=6, converge_translation=0.0,
                              converge_rotation=0.0)
    old = (jgh._FUSED_INTERPRET, jau._KERNEL_INTERPRET)
    jgh._FUSED_INTERPRET = jau._KERNEL_INTERPRET = True
    try:
        want = jgh.ghicp_register_chunked(
            jnp.asarray(src), jnp.asarray(ms), jnp.asarray(tgt),
            jnp.asarray(mt), jnp.asarray(fd), jnp.float32(40.0), cfg)
    finally:
        jgh._FUSED_INTERPRET, jau._KERNEL_INTERPRET = old
    stats = []
    fb = tgh.fused_benefit
    monkeypatch.setattr(tgh, "fused_benefit", lambda *a, **k: (
        stats.append(k["with_stats"]), fb(*a, **k))[1])
    got = ghicp_register_chunked(src, ms, tgt, mt, fd, 40.0,
                                 config_from_dict(dataclasses.asdict(cfg)),
                                 device="cpu")
    # K1 on every iteration, each with its statistics (the none penalty
    # reads the mean ED on every iteration)
    assert stats == [True] * 6
    np.testing.assert_array_equal(got.metrics.cor.numpy(),
                                  np.asarray(want.metrics.cor))
    np.testing.assert_allclose(got.metrics.penalty.numpy(),
                               np.asarray(want.metrics.penalty), rtol=1e-5)
    assert float(got.metrics.penalty[0]) >= 1.0
    np.testing.assert_allclose(got.transform.numpy(),
                               np.asarray(want.transform), atol=1e-4)
    np.testing.assert_array_equal(got.matches.numpy(),
                                  np.asarray(want.matches))
    np.testing.assert_allclose(got.final_rmse, float(want.final_rmse),
                               rtol=1e-5)


def test_none_km_never_takes_the_warm_kernel(problem, monkeypatch):
    """At S = T = 1024 the BSC lane takes K3 from the third iteration on
    (test_whole_engine_mult_blend, test_one_iteration_from_identical_
    state); feature none never does: K1 + K2 on every iteration, as the
    JAX package's gate has it."""
    import ghicp_tpu_torch.registration.ghicp as tgh
    src, tgt, fd, _, _, _ = problem
    calls = []
    monkeypatch.setattr(tgh, "auction_warm_fused",
                        lambda *a, **k: calls.append(1))
    ones = np.ones(S, bool)
    cfg = dataclasses.replace(BASE, feature=FeatureType.NONE,
                              max_iterations=4, converge_translation=0.0,
                              converge_rotation=0.0)
    got = ghicp_register_chunked(src, ones, tgt, ones, np.zeros_like(fd),
                                 40.0, _port_cfg(cfg), device="cpu")
    assert int(got.iterations) == 4 and calls == []


GATE_SHAPES = (1024, 8192, 16384, 23552, 24576, 32768, 36864, 65536)


def _jax_gate(S, T):
    """The shape terms of the JAX package's warm-kernel gate
    (ghicp_tpu/registration/ghicp.py, ``use_warm_kernel``)."""
    ts = jau._gs_ts(T)
    return (S % ts == 0 and S >= 1024 and T >= 1024
            and ts * T <= 256 * 8192)


def test_warm_gate_is_the_jax_gate(problem, monkeypatch):
    """The port takes K3 exactly where the JAX package takes its warm
    kernel: the gate has no shared-memory term (K3 keeps its replica of
    the prices, owners and open flags in shared memory, or in global
    slices a block past ~23,500 slots), so it agrees with the JAX
    expression at every shape, 24,576 to 65,536 slots included, and K2 and
    K3 have a replica form there (no tile cap: 1152 tiles at 36,864).  At
    S = T = 1024 a run with K3's launch spied on completes and launches it
    from the third iteration on."""
    import ghicp_tpu_torch.ops.auction_rounds as ar
    import ghicp_tpu_torch.registration.ghicp as tgh
    cfg = _port_cfg(BASE)
    shapes = [(n, n) for n in GATE_SHAPES] + [(1000, 1024), (512, 8192),
                                              (8192, 262144)]
    for rows, cols in shapes:
        assert tgh.warm_gate(rows, cols, cfg) == _jax_gate(rows, cols)
        ts = ar.gs_tile_rows(cols)
        if _jax_gate(rows, cols):
            assert ar.gs_replica_form(rows, cols, ts) >= 0
            assert ar.warm_replica_form(rows, cols, ts) >= 0
    assert tgh.warm_gate(24576, 24576, cfg)
    assert ar.gs_tile_rows(36864) == 32 and 36864 // 32 == 1152
    assert ar.gs_replica_form(36864, 36864, 32) == 1
    assert ar.warm_replica_form(36864, 36864, 32) == 1
    assert ar.warm_replica_form(24576, 24576, 64) == 1
    assert ar.warm_replica_form(65536, 65536, 32) == 2
    for off in (dict(warm_fused_kernel=False), dict(auction_phases=2),
                dict(auction_round_kernel=False)):
        assert not tgh.warm_gate(8192, 8192, dataclasses.replace(cfg, **off))
    src, tgt, fd, _, _, _ = problem
    ones = np.ones(S, bool)
    run = _port_cfg(dataclasses.replace(BASE, max_iterations=4,
                                        converge_translation=0.0,
                                        converge_rotation=0.0))
    warm, calls = tgh.auction_warm_fused, []

    def spy(*a, **k):
        calls.append(k["prep"].form)
        return warm(*a, **k)
    monkeypatch.setattr(tgh, "auction_warm_fused", spy)
    got = ghicp_register_chunked(src, ones, tgt, ones, fd, 40.0, run,
                                 device="cpu")
    assert int(got.iterations) == 4 and calls == [0, 0]


def _port_cfg(cfg):
    return config_from_dict(dataclasses.asdict(cfg))


def test_blend_weights_of_each_feature():
    from ghicp_tpu_torch.core.config import FeatureType as TF
    from ghicp_tpu_torch.registration.ghicp import blend_weights
    cfg = _port_cfg(BASE)
    assert blend_weights(4.0, dataclasses.replace(cfg, feature=TF.NONE)) \
        == (1.0, 0.0)
    assert blend_weights(3.0, dataclasses.replace(cfg, feature=TF.FPFH)) \
        == (1.0, 0.25)
    wed, wfd = blend_weights(0.0, cfg)
    assert (wed, wfd) == (0.0, 1.0)


@pytest.mark.parametrize("start_it", [0, 2])
def test_nn_one_iteration_from_identical_state(small, start_it):
    """One NN iteration from the JAX engine's state: the plain Kabsch on
    the matched rows (no margin weights, no IRLS: those serve the KM gate
    only), the state's prices and assignment untouched, and the none
    lane's price drift d_ED."""
    src, tgt, _, ms, mt, _ = small
    fd = np.zeros((512, 512), np.float32)
    cfg = dataclasses.replace(BASE, feature=FeatureType.NONE,
                              correspondence=CorrespondenceType.NN,
                              max_iterations=6)
    assert cfg.confidence_weighting and cfg.robust_irls_rounds > 0
    body_j = jax.jit(jgh._make_body(jnp.asarray(tgt), jnp.asarray(ms),
                                    jnp.asarray(mt), jnp.asarray(fd),
                                    jnp.float32(40.0), cfg, LOCAL, 512))
    st = jgh._initial_state(jnp.asarray(src), 512, cfg)
    for _ in range(start_it):
        st = body_j(st)
    want = body_j(st)
    body_t = make_body(torch.from_numpy(tgt), torch.from_numpy(ms),
                       torch.from_numpy(mt), torch.from_numpy(fd), 40.0,
                       _port_cfg(cfg))
    got = body_t(state_from_numpy(_to_numpy(st), "cpu", cfg.max_iterations))
    i = start_it
    assert int(got.metrics.cor[i]) == int(np.asarray(want.metrics.cor)[i])
    np.testing.assert_allclose(got.rt.numpy(), np.asarray(want.rt),
                               atol=1e-5)
    # d_ED = scale * the largest keypoint step: steps of millimetres,
    # each package's Kabsch a few ulps from the other's
    np.testing.assert_allclose(got.price_unc.numpy(),
                               np.asarray(want.price_unc), rtol=1e-4)
    assert torch.equal(got.acol, torch.from_numpy(
        np.asarray(st.acol).astype(np.int64)))


def test_none_km_one_iteration_from_identical_state(small, interpret):
    """A warm none + KM iteration on the kernel lane from the JAX engine's
    state after two (its fused and GS kernels in interpret mode): cor, the
    pose, the penalty max(mean ED, 1) and the next warm start's price
    uncertainty, whose drift term is d_ED alone for this blend."""
    src, tgt, _, ms, mt, _ = small
    fd = np.zeros((512, 512), np.float32)
    cfg = dataclasses.replace(BASE, feature=FeatureType.NONE)
    body_j = jax.jit(jgh._make_body(jnp.asarray(tgt), jnp.asarray(ms),
                                    jnp.asarray(mt), jnp.asarray(fd),
                                    jnp.float32(40.0), cfg, LOCAL, 512))
    st = jgh._initial_state(jnp.asarray(src), 512, cfg)
    st = body_j(body_j(st))
    want = body_j(st)
    body_t = make_body(torch.from_numpy(tgt), torch.from_numpy(ms),
                       torch.from_numpy(mt), torch.from_numpy(fd), 40.0,
                       _port_cfg(cfg))
    got = body_t(state_from_numpy(_to_numpy(st), "cpu", cfg.max_iterations))
    assert int(got.metrics.cor[2]) == int(np.asarray(want.metrics.cor)[2])
    np.testing.assert_allclose(got.rt.numpy(), np.asarray(want.rt),
                               atol=1e-5)
    np.testing.assert_allclose(float(got.pen_prev), float(want.pen_prev),
                               rtol=1e-5)
    np.testing.assert_allclose(got.price_unc.numpy(),
                               np.asarray(want.price_unc), rtol=1e-4,
                               atol=1e-6)


def _bits(d):
    """A state dict of :func:`_to_numpy` with float arrays as their bits."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out[k] = _bits(v)
        else:
            v = np.asarray(v)
            out[k] = v.view(np.uint32) if v.dtype == np.float32 else v
    return out


@pytest.mark.parametrize("feature", [FeatureType.BSC, FeatureType.FPFH])
def test_prepared_warm_inputs_match_per_call(problem, feature, monkeypatch):
    """The warm solves of two engine runs on different targets of the same
    shape, their iterations interleaved: each run's solves take the
    WarmInputs (target factors, masks, FD) made once by its own body, and
    sink and the penalty step as tensors (no host read); the states equal,
    bit for bit, those of per-call preparation (no WarmInputs, sink and
    the step as host floats)."""
    from ghicp_tpu_torch.ops.auction_rounds import WarmInputs
    from ghicp_tpu_torch.registration import ghicp as tgh
    src, tgt, fd, _, _, _ = problem
    tgt2 = (tgt[::-1] + np.float32(0.05)).astype(np.float32)
    fd2 = np.ascontiguousarray(fd[:, ::-1])
    if feature == FeatureType.FPFH:
        fd, fd2 = (np.clip(1.0 - x / 200.0, 0.0, 1.0).astype(np.float32)
                   for x in (fd, fd2))
    cfg = _port_cfg(dataclasses.replace(BASE, feature=feature,
                                        converge_translation=0.0,
                                        converge_rotation=0.0))
    m = torch.ones(S, dtype=torch.bool)
    warm = tgh.auction_warm_fused

    def run(prepared: bool):
        seen = []

        def spy(*a, prep=None, **k):
            seen.append((prep, a[13], a[16]))
            if prepared:
                return warm(*a, prep=prep, **k)
            a = a[:13] + (float(a[13]),) + a[14:16] + (float(a[16]),) + a[17:]
            return warm(*a, **k)
        monkeypatch.setattr(tgh, "auction_warm_fused", spy)
        bodies = [tgh.make_body(torch.from_numpy(t), m, m,
                                torch.from_numpy(f), 40.0, cfg)
                  for t, f in ((tgt, fd), (tgt2, fd2))]
        states = [tgh.initial_state(torch.from_numpy(src), T, cfg)] * 2
        out = []
        for _ in range(5):
            states = [b(st) for b, st in zip(bodies, states)]
            out.append([_bits(_to_numpy(st)) for st in states])
        return out, seen

    got, seen = run(True)
    want, seen_per_call = run(False)
    # iterations 2-4 of both runs took K3, alternating between the runs
    assert len(seen) == len(seen_per_call) == 6
    preps = [p for p, _, _ in seen]
    assert all(isinstance(p, WarmInputs) for p in preps)
    assert preps[0::2] == [preps[0]] * 3 and preps[1::2] == [preps[1]] * 3
    assert preps[0] is not preps[1]
    assert all(torch.is_tensor(s) and torch.is_tensor(d)
               for _, s, d in seen)
    for g_it, w_it in zip(got, want):
        for g, w in zip(g_it, w_it):
            np.testing.assert_equal(g, w)
