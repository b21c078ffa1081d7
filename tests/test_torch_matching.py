"""Auction matching of both packages on the same benefits or costs, with the
JAX package routed through its Gauss-Seidel kernel (interpret mode)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ghicp_tpu.matching.auction as jau
from ghicp_tpu_torch.matching import auction as tau

torch.set_num_threads(1)
T = torch.from_numpy


def _problem(seed=3, S=256, C=384):
    rng = np.random.default_rng(seed)
    cd = rng.uniform(0.0, 30.0, (S, C)).astype(np.float32)
    # a planted near-diagonal structure so the gate keeps real pairs
    cd[np.arange(S), np.arange(S)] = rng.uniform(0.0, 2.0, S)
    ms = np.ones(S, bool)
    ms[-9:] = False
    mt = np.ones(C, bool)
    mt[-5:] = False
    cd = np.where(ms[:, None] & mt[None, :], cd, np.inf).astype(np.float32)
    return cd, ms, mt


def _jax_interpret(fn, *args, **kw):
    old = jau._KERNEL_INTERPRET
    jau._KERNEL_INTERPRET = True
    try:
        return fn(*args, **kw)
    finally:
        jau._KERNEL_INTERPRET = old


@pytest.mark.parametrize("n_phases", [1, 2])
def test_auction_match_benefits_energy(n_phases):
    cd, ms, mt = _problem()
    S, C = cd.shape
    b = np.where(np.isfinite(cd), -cd, -3e38).astype(np.float32)
    bb = jnp.asarray(b).astype(jnp.bfloat16)
    penalty, eps = 12.0, 0.05
    J = _jax_interpret(jau.auction_match_benefits, bb, jnp.float32(penalty),
                       jnp.asarray(ms), jnp.asarray(mt), eps_final=eps,
                       max_rounds=200, use_round_kernel=True,
                       n_phases=n_phases)
    M = tau.auction_match_benefits(
        torch.tensor(np.asarray(bb.astype(jnp.float32))).to(torch.bfloat16),
        penalty,
        T(ms), T(mt), eps_final=eps, max_rounds=200, use_round_kernel=True,
        n_phases=n_phases)
    tol = max(S, C) * max(float(J.eps_used), float(M.eps_used))
    assert abs(float(J.energy) - float(M.energy)) <= tol
    m = M.match.tgt_idx.numpy()[M.match.w.numpy() > 0]
    assert len(np.unique(m)) == len(m)


@pytest.mark.parametrize("warm", [False, True])
def test_auction_match_energy(warm):
    cd, ms, mt = _problem(seed=4)
    S, C = cd.shape
    penalty, eps = 12.0, 0.05
    kw_j, kw_m = {}, {}
    if warm:
        # warm start from a cold solve's prices and assignment
        cold = tau.auction_match(T(cd), penalty, T(ms), T(mt), eps_final=eps,
                                 max_rounds=200, quantize_bf16=True,
                                 use_round_kernel=True, n_phases=1)
        p0, acol0 = cold.prices.numpy(), cold.acol.numpy()
        unc = np.full(C, 0.2, np.float32)
        kw_j = dict(p0=jnp.asarray(p0), price_uncertainty=jnp.asarray(unc),
                    acol0=jnp.asarray(acol0.astype(np.int32)),
                    keep_slack_extra=jnp.float32(0.0))
        kw_m = dict(p0=T(p0), price_uncertainty=T(unc), acol0=T(acol0),
                    keep_slack_extra=0.0)
    J = _jax_interpret(jau.auction_match, jnp.asarray(cd),
                       jnp.float32(penalty), jnp.asarray(ms),
                       jnp.asarray(mt), eps_final=eps, max_rounds=200,
                       quantize_bf16=True, use_round_kernel=True, n_phases=1,
                       **kw_j)
    M = tau.auction_match(T(cd), penalty, T(ms), T(mt), eps_final=eps,
                          max_rounds=200, quantize_bf16=True,
                          use_round_kernel=True, n_phases=1, **kw_m)
    tol = max(S, C) * max(float(J.eps_used), float(M.eps_used))
    assert abs(float(J.energy) - float(M.energy)) <= tol
    assert int(J.match.n_matches) > S // 2


@pytest.mark.parametrize("iteration", [0, 3])
def test_euclidean_matrix_and_blend_bsc(iteration):
    from ghicp_tpu.matching.cost import blend_bsc as j_blend
    from ghicp_tpu.matching.cost import euclidean_matrix as j_ed
    from ghicp_tpu_torch.matching.cost import blend_bsc, euclidean_matrix
    rng = np.random.default_rng(6)
    src = rng.uniform(-12, 12, (128, 3)).astype(np.float32)
    tgt = rng.uniform(-12, 12, (256, 3)).astype(np.float32)
    fd = rng.integers(0, 441, (128, 256)).astype(np.float32)
    ms, mt = np.ones(128, bool), np.ones(256, bool)
    ms[-5:] = False
    ed_j = np.array(j_ed(jnp.asarray(src), jnp.asarray(tgt),
                           jnp.float32(0.2)))
    ed_t = euclidean_matrix(T(src), T(tgt), 0.2)
    np.testing.assert_allclose(ed_t.numpy(), ed_j, rtol=1e-5, atol=1e-5)
    st = (1.3, 150.0, 20.0, 1.0, 1.0, 0.2)   # rms fdm fdstd para1 para2 scale
    j = j_blend(jnp.asarray(ed_j), jnp.asarray(fd), jnp.asarray(ms),
                jnp.asarray(mt), jnp.int32(iteration),
                *map(jnp.float32, st), 6.0, 2.0)
    t = blend_bsc(T(ed_j), T(fd), T(ms), T(mt), iteration,
                  *map(torch.tensor, st), 6.0, 2.0)
    np.testing.assert_allclose(t.cd.numpy(), np.asarray(j.cd), rtol=1e-6)
    np.testing.assert_allclose(float(t.penalty), float(j.penalty),
                               rtol=1e-4)
