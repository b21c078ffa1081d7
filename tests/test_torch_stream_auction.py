"""The port's streaming auction (``stream_solve``) against the JAX package's
``stream_solve(use_kernel=False)`` and the Hungarian optimum, on the
fixtures of tests/test_stream_auction.py."""
import numpy as np
import jax.numpy as jnp
import torch

import test_stream_auction as jt
from ghicp_tpu.matching.stream_auction import StreamCarry as JaxCarry
from ghicp_tpu.matching.stream_auction import stream_solve as jax_solve
from ghicp_tpu_torch.interop import stream_features_from_numpy
from ghicp_tpu_torch.matching.stream_auction import (StreamCarry,
                                                     stream_solve)

torch.set_num_threads(1)


def _feats(jf):
    return stream_features_from_numpy(np.asarray(jf.fs), np.asarray(jf.ft),
                                      np.asarray(jf.na), np.asarray(jf.nb),
                                      device="cpu")


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _solve(kp_s, kp_t, feats, wed, wfd, scale, penalty_fn, budget, p0=None,
           unc=3.0e38, acol0=None, pen_prev=0.0, eps=0.01, rel_eps=0.0,
           **kw):
    S, C = kp_s.shape[0], kp_t.shape[0]
    return stream_solve(
        _t(kp_s), _t(kp_t), feats, torch.ones(S, dtype=torch.bool),
        torch.ones(C, dtype=torch.bool), wed, wfd, scale, penalty_fn,
        eps_final=eps, rel_eps=rel_eps, max_sweeps=budget,
        p0=torch.zeros(C) if p0 is None else p0, price_uncertainty=unc,
        acol0=torch.full((S,), -1) if acol0 is None else acol0,
        pen_prev=pen_prev, **kw)


def _agree(got, want, n):
    """Same solve as the JAX package: energies within the epsilon-CS
    bound (ties may resolve apart), assignments nearly all equal."""
    bound = n * max(float(got.eps_used), float(want.eps_used)) + 1e-2
    assert abs(float(got.energy) - float(want.energy)) <= bound
    same = np.mean(got.acol.numpy() == np.asarray(want.acol))
    assert same >= 0.98, same


def test_matches_jax_and_hungarian_bound():
    kp_s, kp_t, jf, fd = jt._problem()
    wed, wfd, scale = 0.4, 0.6, 0.12

    def pen(mean, std):
        return mean - 2.0 * std

    got = _solve(kp_s, kp_t, _feats(jf), wed, wfd, scale, pen, budget=4000)
    want = jt._solve(kp_s, kp_t, jf, wed, wfd, scale, pen, budget=4000)
    cd = jt._dense_cd(kp_s, kp_t, fd, wed, wfd, scale)
    np.testing.assert_allclose(float(got.penalty),
                               float(cd.mean() - 2.0 * cd.std()), rtol=1e-3)
    n = max(cd.shape)
    _agree(got, want, n)
    opt = jt._hungarian_energy(cd, float(got.penalty))
    assert float(got.energy) <= opt + n * float(got.eps_used) + 1e-2
    w, tj = got.match.w.numpy(), got.match.tgt_idx.numpy()
    assert (cd[np.nonzero(w > 0)[0], tj[w > 0]] < float(got.penalty)).all()
    assert len(np.unique(tj[w > 0])) == int((w > 0).sum())


def test_warm_start_matches_cold():
    kp_s, kp_t, jf, fd = jt._problem(seed=5)
    feats = _feats(jf)
    wed, wfd, scale = 0.8, 0.2, 0.1

    def pen(mean, std):
        return mean - 1.0 * std

    first = _solve(kp_s, kp_t, feats, wed, wfd, scale, pen, budget=4000)
    rng = np.random.default_rng(6)
    kp_s2 = kp_s + rng.uniform(-2e-3, 2e-3, kp_s.shape).astype(np.float32)
    drift = 0.1 * 2e-3 * np.sqrt(3) + 2 * float(first.eps_used)
    cold = _solve(kp_s2, kp_t, feats, wed, wfd, scale, pen, budget=4000)
    warm = _solve(kp_s2, kp_t, feats, wed, wfd, scale, pen, budget=4000,
                  p0=first.prices, unc=drift, acol0=first.acol,
                  pen_prev=float(first.penalty))
    n = max(kp_s.shape[0], kp_t.shape[0])
    bound = n * max(float(cold.eps_used), float(warm.eps_used)) + 1e-2
    assert abs(float(warm.energy) - float(cold.energy)) <= bound
    assert warm.rounds <= cold.rounds
    jfirst = jt._solve(kp_s, kp_t, jf, wed, wfd, scale, pen, budget=4000)
    jwarm = jt._solve(kp_s2, kp_t, jf, wed, wfd, scale, pen, budget=4000,
                      p0=jfirst.prices, unc=drift, acol0=jfirst.acol,
                      pen_prev=float(jfirst.penalty))
    _agree(warm, jwarm, n)


def test_compaction_is_exact():
    """Compacted sweeps change the dataflow only: assignments, prices and
    energy equal those of full sweeps, cold and warm."""
    kp_s, kp_t, jf, fd = jt._problem(seed=11)
    feats = _feats(jf)
    wed, wfd, scale = 0.6, 0.4, 0.1

    def pen(mean, std):
        return mean - 1.0 * std

    run = lambda cap, kp=kp_s, **kw: _solve(
        kp, kp_t, feats, wed, wfd, scale, pen, budget=64,
        rel_eps=1.0 / 64, open_cap=cap, **kw)
    cold_full, cold_cap = run(0), run(64)
    assert torch.equal(cold_full.acol, cold_cap.acol)
    assert torch.equal(cold_full.prices, cold_cap.prices)
    assert float(cold_full.energy) == float(cold_cap.energy)
    rng = np.random.default_rng(1)
    kp_s2 = kp_s + rng.uniform(-2e-3, 2e-3, kp_s.shape).astype(np.float32)
    warm_kw = dict(p0=cold_full.prices,
                   unc=0.1 * 2e-3 * np.sqrt(3) + 2 * float(
                       cold_full.eps_used),
                   acol0=cold_full.acol, pen_prev=float(cold_full.penalty))
    w_full, w_cap = run(0, kp_s2, **warm_kw), run(64, kp_s2, **warm_kw)
    assert torch.equal(w_full.acol, w_cap.acol)
    assert torch.equal(w_full.prices, w_cap.prices)
    want = jt.stream_solve(
        jnp.asarray(kp_s), jnp.asarray(kp_t), jf, jnp.ones(192, bool),
        jnp.ones(256, bool), wed, wfd, scale, pen, eps_final=0.01,
        rel_eps=1.0 / 64, max_sweeps=64, p0=jnp.zeros(256, jnp.float32),
        price_uncertainty=3.0e38, acol0=jnp.full((192,), -1, jnp.int32),
        pen_prev=0.0, use_kernel=False, tc=128, open_cap=64)
    _agree(cold_cap, want, 256)


def test_solve_counts_compacted_sweeps_and_open_rows():
    """The split of the sweeps that the launch counter cannot give: the
    sweeps over compacted blocks, and the rows open when bidding starts."""
    kp_s, kp_t, jf, fd = jt._problem(S=192, C=256, seed=31)
    feats = _feats(jf)

    def pen(mean, std):
        return mean - 1.0 * std

    run = lambda cap: _solve(kp_s, kp_t, feats, 0.6, 0.4, 0.1, pen,
                             budget=64, rel_eps=1.0 / 64, open_cap=cap)
    full, cap = run(0), run(64)
    assert full.compact_sweeps == 0 < cap.compact_sweeps <= cap.rounds
    assert full.open_rows == cap.open_rows == 192
    assert not full.fast and not cap.fast


def test_carry_fast_path_quality():
    """Carried hints in place of sweep 0: within the epsilon-CS bound of
    the Hungarian optimum, the KM gate exact, no more sweeps than cold,
    and the same solve as the JAX package from the same carry."""
    kp_s, kp_t, jf, fd = jt._problem(seed=13)
    feats = _feats(jf)
    wed, wfd, scale = 0.7, 0.3, 0.1
    pen_const = 18.0

    def pen(mean, std):
        return torch.tensor(pen_const) if isinstance(mean, torch.Tensor) \
            else jnp.float32(pen_const)

    first = _solve(kp_s, kp_t, feats, wed, wfd, scale, pen, budget=2000)
    rng = np.random.default_rng(2)
    kp_s2 = kp_s + rng.uniform(-2e-3, 2e-3, kp_s.shape).astype(np.float32)
    drift = 0.1 * 2e-3 * np.sqrt(3) + 2 * float(first.eps_used)
    cold = _solve(kp_s2, kp_t, feats, wed, wfd, scale, pen, budget=2000)
    f = lambda x: torch.tensor(np.float32(x))
    carry = StreamCarry(ok=True, v1_ub=first.v1_next, b_max=first.b_max_next,
                        ed_max=f(0.1 * 60.0), fd_max=first.fd_max,
                        v1_drift=f(0.1 * 2e-3 * np.sqrt(3)), fd_term=f(0.0),
                        decay_ratio=f(0.0))
    fast = _solve(kp_s2, kp_t, feats, wed, wfd, scale, pen, budget=2000,
                  p0=first.prices, unc=drift, acol0=first.acol,
                  pen_prev=pen_const, carry=carry, stats_free=True,
                  open_cap=64)
    cd = jt._dense_cd(kp_s2, kp_t, fd, wed, wfd, scale)
    opt = jt._hungarian_energy(cd, pen_const)
    n = max(cd.shape)
    bound = n * max(float(cold.eps_used), float(fast.eps_used)) + 1e-2
    assert float(fast.energy) <= opt + bound
    w, tj = fast.match.w.numpy(), fast.match.tgt_idx.numpy()
    assert (cd[np.nonzero(w > 0)[0], tj[w > 0]] < pen_const).all()
    assert len(np.unique(tj[w > 0])) == int((w > 0).sum())
    assert fast.rounds <= cold.rounds
    assert fast.fast and not cold.fast
    # the JAX solve from the port's carry and warm start
    S, C = kp_s.shape[0], kp_t.shape[0]
    jcarry = JaxCarry(ok=jnp.bool_(True),
                      **{k: jnp.asarray(getattr(carry, k).numpy())
                         for k in JaxCarry._fields if k != "ok"})
    want = jax_solve(
        jnp.asarray(kp_s2), jnp.asarray(kp_t), jf, jnp.ones(S, bool),
        jnp.ones(C, bool), wed, wfd, scale, pen, eps_final=0.01,
        rel_eps=0.0, max_sweeps=2000, p0=jnp.asarray(first.prices.numpy()),
        price_uncertainty=drift,
        acol0=jnp.asarray(first.acol.numpy().astype(np.int32)),
        pen_prev=pen_const, use_kernel=False, tc=128, carry=jcarry,
        stats_free=True, open_cap=64)
    _agree(fast, want, n)


def test_extended_compact_rounds_keep_the_base_epsilon():
    kp_s, kp_t, jf, fd = jt._problem(S=192, C=256, seed=31)
    feats = _feats(jf)

    def pen(mean, std):
        return mean - 1.0 * std

    run = lambda extra: _solve(kp_s, kp_t, feats, 0.6, 0.4, 0.1, pen,
                               budget=2, rel_eps=1.0 / 64, open_cap=64,
                               compact_extra_sweeps=extra)
    base, ext = run(0), run(24)
    assert ext.rounds >= base.rounds
    assert float(ext.eps_used) <= float(base.eps_used) * 1.001
