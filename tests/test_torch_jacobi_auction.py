"""The Jacobi auction lane (bidding rounds through the top-2 of kernel
K6's contract) against the JAX package's default CPU path: the same cost
or benefit matrix, cold and warm, one and three phases, a binding budget
and a shape the Gauss-Seidel kernel does not take."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ghicp_tpu.matching.auction as jau
from ghicp_tpu_torch.matching import auction as tau

torch.set_num_threads(1)
T = torch.from_numpy
PENALTY, EPS = 12.0, 0.05


def _costs(seed, S=256, C=384, ties=False):
    """[S, C] costs with a planted near-diagonal, masked tail rows and
    columns (+inf); ``ties`` draws integer costs (many exact ties)."""
    rng = np.random.default_rng(seed)
    draw = ((lambda lo, hi, n: rng.integers(lo, hi, n)) if ties
            else (lambda lo, hi, n: rng.uniform(lo, hi, n)))
    cd = draw(0, 30, (S, C)).astype(np.float32)
    cd[np.arange(S), np.arange(S) % C] = draw(0, 2, S)
    ms = np.ones(S, bool)
    ms[-9:] = False
    mt = np.ones(C, bool)
    mt[-5:] = False
    return (np.where(ms[:, None] & mt[None, :], cd, np.inf).astype(
        np.float32), ms, mt)


def _warm(cd, ms, mt, C):
    """Warm-start arguments from a cold solve of the port (both packages
    get the same numbers)."""
    cold = tau.auction_match(T(cd), PENALTY, T(ms), T(mt), eps_final=EPS,
                             max_rounds=500, n_phases=1)
    rng = np.random.default_rng(1)
    return dict(p0=cold.prices.numpy(),
                price_uncertainty=rng.uniform(0.0, 0.3, C).astype(
                    np.float32),
                acol0=cold.acol.numpy(), keep_slack_extra=np.float32(0.1))


def _solve_both(fn, mat, ms, mt, kw, warm=None):
    warm = warm or {}
    jw = {k: jnp.asarray(v.astype(np.int32) if k == "acol0" else v)
          for k, v in warm.items()}
    tw = {k: torch.as_tensor(v) for k, v in warm.items()}
    J = getattr(jau, fn)(jnp.asarray(mat), jnp.float32(PENALTY),
                         jnp.asarray(ms), jnp.asarray(mt), eps_final=EPS,
                         **kw, **jw)
    M = getattr(tau, fn)(T(mat), PENALTY, T(ms), T(mt), eps_final=EPS,
                         **kw, **tw)
    return J, M


CASES = {
    "cold_1_phase": (256, 384, dict(n_phases=1, max_rounds=500), False),
    "cold_3_phases": (256, 384, dict(n_phases=3, max_rounds=500), False),
    "warm": (256, 384, dict(n_phases=1, max_rounds=500), True),
    "warm_3_phases": (256, 384, dict(n_phases=3, max_rounds=500), True),
    "budget_3": (256, 256, dict(n_phases=3, max_rounds=3), False),
    "gs_rejects_shape": (384, 1024, dict(n_phases=1, max_rounds=500,
                                         use_round_kernel=True), False),
}


@pytest.mark.parametrize("fn", ["auction_match", "auction_match_benefits"])
@pytest.mark.parametrize("case", list(CASES))
def test_tie_free_solve_equals_jax(case, fn):
    S, C, kw, warm = CASES[case]
    cd, ms, mt = _costs(3, S, C)
    mat = cd if fn == "auction_match" else np.where(
        np.isfinite(cd), -cd, np.float32(-3e38)).astype(np.float32)
    J, M = _solve_both(fn, mat, ms, mt, kw,
                       _warm(cd, ms, mt, C) if warm else None)
    np.testing.assert_array_equal(M.acol.numpy(), np.asarray(J.acol))
    assert int(M.rounds) == int(J.rounds)
    np.testing.assert_allclose(M.prices.numpy(), np.asarray(J.prices),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(M.eps_used), float(J.eps_used),
                               rtol=1e-6)
    np.testing.assert_allclose(M.punc.numpy(), np.asarray(J.punc),
                               rtol=1e-6)
    np.testing.assert_allclose(float(M.energy), float(J.energy), rtol=1e-6)
    if case == "budget_3":
        # the budget binds: rows still open after the rounds were
        # completed greedily
        b = T(mat) if fn != "auction_match" else T(np.where(
            np.isfinite(cd) & (cd < PENALTY), -cd, np.float32(-3e38)))
        raw = tau.auction_assign(b, -PENALTY, EPS, 3, n_phases=3)[0]
        assert int(M.rounds) == 3 and bool((raw == -1).any())
        assert not bool((M.acol == -1).any())


@pytest.mark.parametrize("warm", [False, True])
def test_tie_heavy_energy_within_bound(warm):
    S, C = 256, 384
    cd, ms, mt = _costs(5, S, C, ties=True)
    J, M = _solve_both("auction_match", cd, ms, mt,
                       dict(n_phases=3, max_rounds=500, quantize_bf16=True),
                       _warm(cd, ms, mt, C) if warm else None)
    tol = max(S, C) * max(float(J.eps_used), float(M.eps_used))
    assert abs(float(J.energy) - float(M.energy)) <= tol
    assert int(M.match.n_matches) > S // 2


@pytest.mark.parametrize("fn", ["auction_match", "auction_match_benefits"])
def test_batched_equals_per_pair(fn):
    P, S, C = 3, 128, 192
    probs = [_costs(10 + k, S, C, ties=(k == 1)) for k in range(P)]
    cd = np.stack([c for c, _, _ in probs])
    ms = np.stack([m for _, m, _ in probs])
    mt = np.stack([m for _, _, m in probs])
    mat = cd if fn == "auction_match" else np.where(
        np.isfinite(cd), -cd, np.float32(-3e38)).astype(np.float32)
    penalty = torch.tensor([12.0, 9.0, 15.0])
    max_rounds = [400, 5, 400]
    B = getattr(tau, fn)(T(mat), penalty, T(ms), T(mt), eps_final=EPS,
                         max_rounds=max_rounds, n_phases=2)
    for k in range(P):
        one = getattr(tau, fn)(T(mat[k]), float(penalty[k]), T(ms[k]),
                               T(mt[k]), eps_final=EPS,
                               max_rounds=max_rounds[k], n_phases=2)
        assert torch.equal(B.acol[k], one.acol)
        assert torch.equal(B.prices[k], one.prices)
        assert int(B.rounds[k]) == int(one.rounds)
        assert float(B.energy[k]) == float(one.energy)
    assert int(B.rounds[1]) == 5
