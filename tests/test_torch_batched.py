"""The engine's XLA lane (ED and BSC blend as tensor passes, the Jacobi
auction through the top-2 of kernel K6's contract) against the JAX
package's non-fused engine, one pair and a batch of pairs, and the lane
gate of ``make_body``."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ghicp_tpu.registration.ghicp as jgh
import ghicp_tpu_torch.matching.auction as tau
import ghicp_tpu_torch.registration.ghicp as tgh
from ghicp_tpu.core.config import (CorrespondenceType, FeatureType,
                                   GHICPConfig)
from ghicp_tpu_torch.interop import config_from_dict
from ghicp_tpu_torch.io.synthetic import registration_problem

torch.set_num_threads(1)
BASE = GHICPConfig(feature=FeatureType.BSC,
                   correspondence=CorrespondenceType.KM)


def _port(cfg):
    return config_from_dict(dataclasses.asdict(cfg))


@pytest.mark.parametrize("S,fused", [(256, False), (320, True)])
def test_xla_lane_matches_jax(S, fused):
    """320 keypoints: not a multiple of 128, so both packages' gates send
    the engine to the XLA lane even with the fused kernel on."""
    cfg = dataclasses.replace(BASE, max_iterations=12,
                              converge_translation=0.0,
                              converge_rotation=0.0, fused_cost_kernel=fused,
                              auction_round_kernel=False)
    src, tgt, fd, _, _, _ = registration_problem(S, S, seed=13,
                                                 rot_deg=12.0)
    ms, mt = np.ones(S, bool), np.ones(S, bool)
    ms[-7:] = False
    J = jgh.ghicp_register(jnp.asarray(src), jnp.asarray(ms),
                           jnp.asarray(tgt), jnp.asarray(mt),
                           jnp.asarray(fd), jnp.float32(40.0), cfg)
    M = tgh.ghicp_register(src, ms, tgt, mt, fd, 40.0, _port(cfg),
                           device="cpu")
    assert M.iterations == int(J.iterations) == 12
    np.testing.assert_array_equal(M.metrics.cor.numpy(),
                                  np.asarray(J.metrics.cor))
    np.testing.assert_array_equal(M.metrics.rounds.numpy(),
                                  np.asarray(J.metrics.rounds))
    np.testing.assert_allclose(M.transform.numpy(), np.asarray(J.transform),
                               atol=1e-4)
    # no final matching: the verdict reads the last iteration's RMSE
    assert M.final_rmse == float(M.metrics.rmse_after[11])
    assert M.success == bool(J.success)


def _pairs(P=3, S=256):
    """Pairs of growing difficulty (feature noise), so that their
    iteration counts differ."""
    probs = [registration_problem(S, S, seed=20 + k,
                                  rot_deg=(4.0, 8.0, 12.0)[k],
                                  flip=(0.06, 0.3, 0.42)[k])
             for k in range(P)]
    stack = lambda i: np.stack([p[i] for p in probs])
    ms = np.ones((P, S), bool)
    ms[1, -11:] = False
    return (stack(0), ms, stack(1), np.ones((P, S), bool), stack(2),
            np.float32([40.0, 35.0, 45.0]))


def test_batched_matches_jax_and_single_pairs():
    cfg = dataclasses.replace(BASE, max_iterations=30,
                              converge_translation=2e-4,
                              converge_rotation=2e-4)
    kp_s, ms, kp_t, mt, fd, bbx = _pairs()
    J = jgh.ghicp_register_batched(*(jnp.asarray(x) for x in (
        kp_s, ms, kp_t, mt, fd, bbx)), cfg)
    M = tgh.ghicp_register_batched(kp_s, ms, kp_t, mt, fd, bbx, _port(cfg),
                                   device="cpu")
    its = M.iterations.numpy()
    np.testing.assert_array_equal(its, np.asarray(J.iterations))
    assert len(set(its.tolist())) > 1       # pairs finish apart
    np.testing.assert_allclose(M.transform.numpy(), np.asarray(J.transform),
                               atol=5e-3)
    # a pair of the batch is the same run as the pair alone on the lane
    one = dataclasses.replace(_port(cfg), fused_cost_kernel=False,
                              auction_round_kernel=False)
    for k in range(3):
        single = tgh.ghicp_register(kp_s[k], ms[k], kp_t[k], mt[k], fd[k],
                                    float(bbx[k]), one, device="cpu")
        assert single.iterations == int(its[k])
        np.testing.assert_allclose(single.transform.numpy(),
                                   M.transform[k].numpy(), atol=1e-5)
        np.testing.assert_array_equal(single.metrics.cor.numpy(),
                                      M.metrics.cor[k].numpy())
        assert bool(M.success[k]) == single.success
        assert float(M.final_rmse[k]) == pytest.approx(single.final_rmse,
                                                       rel=1e-5)


@pytest.mark.parametrize("fused,round_kernel,want", [
    (False, True, "xla"), (True, True, "kernels"),
    (True, False, "fused+jacobi")])
def test_lane_gate(monkeypatch, fused, round_kernel, want):
    calls = {"fused_benefit": 0, "top2_rows": 0, "auction_phase_gs": 0}

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapper)

    counted(tgh, "fused_benefit")
    counted(tau, "top2_rows")
    counted(tau, "auction_phase_gs")
    S = 256
    src, tgt, fd, _, _, _ = registration_problem(S, S, seed=3)
    cfg = dataclasses.replace(BASE, max_iterations=3, converge_rotation=0.0,
                              converge_translation=0.0,
                              fused_cost_kernel=fused,
                              auction_round_kernel=round_kernel,
                              final_resolve_rounds=0)
    ones = np.ones(S, bool)
    tgh.ghicp_register_chunked(src, ones, tgt, ones, fd, 40.0, _port(cfg),
                               device="cpu")
    if want == "xla":
        # the XLA lane, its auction on the GS kernel where the shapes allow
        assert calls["fused_benefit"] == 0 and calls["auction_phase_gs"] > 0
    elif want == "kernels":
        assert calls["fused_benefit"] == 3 and calls["top2_rows"] == 0
    else:
        assert calls["fused_benefit"] == 3 and calls["auction_phase_gs"] == 0
        assert calls["top2_rows"] > 0


def _none_pair(seed, n=128):
    """tests/test_batched.py's pair: a rotated, shifted, noisy copy."""
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(0, 10, (n, 3)).astype(np.float32)
    theta = np.deg2rad(rng.uniform(3, 9))
    R = np.array([[np.cos(theta), -np.sin(theta), 0],
                  [np.sin(theta), np.cos(theta), 0], [0, 0, 1]], np.float32)
    t = rng.uniform(-0.5, 0.5, 3).astype(np.float32)
    src = ((tgt - t) @ R + rng.normal(0, 0.005, (n, 3))).astype(np.float32)
    return src, tgt


@pytest.mark.parametrize("corr", [CorrespondenceType.NNR,
                                  CorrespondenceType.KM])
def test_batched_none_matches_jax_and_single_pairs(corr):
    """tests/test_batched.py's check on the port, [3, 128, 128], feature
    none: the batch against the JAX package's vmapped engine and against
    each pair alone (on the kernel lane for KM, the XLA lane for NNR),
    each recovering its pair."""
    cfg = GHICPConfig(feature=FeatureType.NONE, correspondence=corr,
                      estimated_overlap=0.9, max_iterations=10,
                      auction_max_rounds=500)
    pairs = [_none_pair(s) for s in range(3)]
    kp_s = np.stack([p[0] for p in pairs])
    kp_t = np.stack([p[1] for p in pairs])
    masks = np.ones((3, 128), bool)
    fd = np.zeros((3, 128, 128), np.float32)
    bbx = np.full((3,), 30.0, np.float32)
    J = jgh.ghicp_register_batched(*(jnp.asarray(x) for x in (
        kp_s, masks, kp_t, masks, fd, bbx)), cfg)
    M = tgh.ghicp_register_batched(kp_s, masks, kp_t, masks, fd, bbx,
                                   _port(cfg), device="cpu")
    np.testing.assert_array_equal(M.iterations.numpy(),
                                  np.asarray(J.iterations))
    np.testing.assert_array_equal(M.metrics.cor.numpy(),
                                  np.asarray(J.metrics.cor))
    np.testing.assert_allclose(M.transform.numpy(), np.asarray(J.transform),
                               atol=1e-4)
    for i in range(3):
        single = tgh.ghicp_register(kp_s[i], masks[i], kp_t[i], masks[i],
                                    fd[i], 30.0, _port(cfg), device="cpu")
        np.testing.assert_allclose(M.transform[i].numpy(),
                                   single.transform.numpy(), atol=5e-3)
        assert float(M.final_rmse[i]) < 0.1
