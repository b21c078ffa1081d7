"""The port's Gauss-Seidel phase and warm fused iteration (plain versions of
the K2 and K3 kernels) against the JAX Pallas kernels in interpret mode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from ghicp_tpu.ops.auction_rounds import (auction_phase_gs_pallas,
                                          auction_warm_fused_pallas)
from ghicp_tpu.ops.cost_kernel import fused_benefit_ref
from ghicp_tpu_torch.ops.auction_rounds import (auction_phase_gs,
                                                auction_warm_fused)

torch.set_num_threads(1)
T = torch.from_numpy


def _gs_problem(seed=7, S=512, C=640):
    rng = np.random.default_rng(seed)
    b = rng.uniform(-4, 0, (S, C)).astype(np.float32)
    b[rng.random((S, C)) < 0.3] = -3e38
    return np.array(jnp.asarray(b).astype(jnp.bfloat16)
                    .astype(jnp.float32))


def _run_both(b, state, eps, sink, budget, esc_after, esc_period):
    p0, o0, s0, op0 = state
    J = auction_phase_gs_pallas(
        jnp.asarray(b).astype(jnp.bfloat16), jnp.asarray(p0),
        jnp.asarray(o0), jnp.asarray(s0), jnp.asarray(op0), eps, sink,
        budget, ts=128, inner_cap=1, esc_after=esc_after,
        esc_period=esc_period, complete_open=1, interpret=True)
    M = auction_phase_gs(T(b).to(torch.bfloat16), T(p0), T(o0), T(s0),
                         T(op0), eps, sink, budget, ts=128,
                         esc_after=esc_after, esc_period=esc_period,
                         complete_open=True)
    return [np.asarray(x) for x in J], [np.asarray(x) for x in M]


def _warm_state(b, eps, sink):
    """A warm start: a converged phase with 10% of its columns released."""
    S, C = b.shape
    cold = (np.zeros(C, np.float32), np.full(C, -1, np.int32),
            np.zeros(S, np.int32), np.ones(S, np.int32))
    p, o, s, _, _ = auction_phase_gs(T(b).to(torch.bfloat16),
                                     *map(T, cold), eps, sink, 400, ts=128)
    p, o, s = p.numpy(), o.numpy(), s.numpy()
    rel = (np.random.default_rng(1).random(C) < 0.1) & (o >= 0)
    o = np.where(rel, -1, o).astype(np.int32)
    p = np.where(rel, 0.0, np.maximum(p - 2 * eps, 0.0)).astype(np.float32)
    owned = np.zeros(S, bool)
    owned[o[o >= 0]] = True
    return p, o, s, (~owned & (s == 0)).astype(np.int32)


@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("esc", [0, 8])
def test_plain_k2_matches_jax_gs_kernel(start, esc):
    b = _gs_problem()
    S, C = b.shape
    eps, sink, budget = 0.05, -2.0, 40
    if start == "cold":
        state = (np.zeros(C, np.float32), np.full(C, -1, np.int32),
                 np.zeros(S, np.int32), np.ones(S, np.int32))
    else:
        state = _warm_state(b, eps, sink)
    J, M = _run_both(b, state, eps, sink, budget, esc, 4)
    if esc == 0:
        for j, m in zip(J, M):
            assert np.array_equal(j, m)
    else:
        # one ulp of exp2 between jnp and torch may shift a late bid
        assert np.mean(J[1] == M[1]) >= 0.999
        assert np.mean(J[2] == M[2]) >= 0.999
        assert abs(int(J[3]) - int(M[3])) <= 1


def _warm_fixture(seed=11, S=256, C=384):
    rng = np.random.default_rng(seed)
    kps = rng.uniform(-4, 4, (S, 3)).astype(np.float32)
    kpt = rng.uniform(-4, 4, (C, 3)).astype(np.float32)
    fd = np.array(jnp.asarray(rng.integers(0, 200, (S, C))
                              .astype(np.float32)).astype(jnp.bfloat16)
                  .astype(jnp.float32))
    ms = np.ones(S, bool)
    ms[S - 6:] = False
    mt = np.ones(C, bool)
    mt[C - 10:] = False
    return kps, kpt, fd, ms, mt


def test_plain_k3_matches_jax_warm_kernel_and_hungarian():
    kps, kpt, fd, ms, mt = _warm_fixture()
    S, C = fd.shape
    wed, wfd, scale, penalty = 0.7, 0.3, 0.15, 40.0
    p0 = np.zeros(C, np.float32)
    o0 = np.full(C, -1, np.int32)
    acol0 = np.full(S, -1, np.int32)
    s0 = np.zeros(S, np.int32)
    ok0 = np.zeros(S, bool)
    J = auction_warm_fused_pallas(
        jnp.asarray(kps), jnp.asarray(kpt),
        jnp.asarray(fd).astype(jnp.bfloat16), jnp.asarray(ms),
        jnp.asarray(mt), wed, wfd, scale, jnp.asarray(p0), jnp.asarray(o0),
        jnp.asarray(acol0), jnp.asarray(s0), jnp.asarray(ok0), -penalty,
        0.5, 0.0, 0.0, 400, ts=128, esc_after=0, esc_period=1,
        quantize=False, interpret=True)
    M = auction_warm_fused(T(kps), T(kpt), T(fd).to(torch.bfloat16), T(ms),
                           T(mt), wed, wfd, scale, T(p0), T(o0), T(acol0),
                           T(s0), T(ok0), -penalty, 0.5, 0.0, 0.0, 400,
                           ts=128, esc_after=0, esc_period=1)
    owner_j, owner_m = np.asarray(J[1]), M[1].numpy()
    assert np.mean(owner_j == owner_m) >= 0.995
    assert abs(int(J[3]) - int(M[3])) <= 1
    # energy within n*eps of the Hungarian optimum on the gated problem
    b = np.asarray(fused_benefit_ref(
        jnp.asarray(kps), jnp.asarray(kpt),
        jnp.asarray(fd).astype(jnp.bfloat16), jnp.asarray(ms),
        jnp.asarray(mt), wed, wfd, scale)[0].astype(jnp.float32))
    acol = np.full(S, -1, np.int64)
    cols = np.nonzero(owner_m >= 0)[0]
    acol[owner_m[cols]] = cols
    gate = b > -penalty
    jc = np.where(acol >= 0, acol, 0)
    matched = (acol >= 0) & gate[np.arange(S), jc]
    energy = (-b[np.arange(S), jc][matched].sum()
              + penalty * (max(S, C) - matched.sum()))
    n = max(S, C)
    cost = np.full((n, n), penalty, np.float64)
    cost[:S, :C] = np.where(gate, -b, penalty)
    ri, ci = linear_sum_assignment(cost)
    eps = float(M[5][2])
    assert energy <= cost[ri, ci].sum() + (S + 2) * eps + 1e-3


def test_plain_k3_mult_blend_matches_jax_warm_kernel():
    """The FPFH/RoPS lane of K3 at 1024 x 1024 (the size from which the
    engine takes the warm kernel): a similarity FD with exact zeros, cold
    prices; owners and rounds against the JAX kernel in interpret mode,
    the energy against the Hungarian optimum of the gated problem."""
    kps, kpt, fd, ms, mt = _warm_fixture(seed=12, S=1024, C=1024)
    S, C = fd.shape
    sim = np.array(jnp.asarray(fd / 200.0).astype(jnp.bfloat16)
                   .astype(jnp.float32))
    sim[::7, ::5] = 0.0
    wfd, scale, penalty = 1.0 / 3.0, 0.15, 2.0
    p0 = np.zeros(C, np.float32)
    o0 = np.full(C, -1, np.int32)
    acol0 = np.full(S, -1, np.int32)
    s0 = np.zeros(S, np.int32)
    ok0 = np.zeros(S, bool)
    J = auction_warm_fused_pallas(
        jnp.asarray(kps), jnp.asarray(kpt),
        jnp.asarray(sim).astype(jnp.bfloat16), jnp.asarray(ms),
        jnp.asarray(mt), 1.0, wfd, scale, jnp.asarray(p0), jnp.asarray(o0),
        jnp.asarray(acol0), jnp.asarray(s0), jnp.asarray(ok0), -penalty,
        0.02, 0.0, 0.0, 200, ts=128, esc_after=0, esc_period=1,
        mult_blend=True, quantize=False, interpret=True)
    M = auction_warm_fused(T(kps), T(kpt), T(sim).to(torch.bfloat16), T(ms),
                           T(mt), 1.0, wfd, scale, T(p0), T(o0), T(acol0),
                           T(s0), T(ok0), -penalty, 0.02, 0.0, 0.0, 200,
                           ts=128, esc_after=0, esc_period=1,
                           mult_blend=True)
    owner_j, owner_m = np.asarray(J[1]), M[1].numpy()
    assert np.mean(owner_j == owner_m) >= 0.995
    assert abs(int(J[3]) - int(M[3])) <= 1
    b = np.asarray(fused_benefit_ref(
        jnp.asarray(kps), jnp.asarray(kpt),
        jnp.asarray(sim).astype(jnp.bfloat16), jnp.asarray(ms),
        jnp.asarray(mt), 1.0, wfd, scale,
        mult_blend=True)[0].astype(jnp.float32))
    acol = np.full(S, -1, np.int64)
    cols = np.nonzero(owner_m >= 0)[0]
    acol[owner_m[cols]] = cols
    gate = b > -penalty
    jc = np.where(acol >= 0, acol, 0)
    matched = (acol >= 0) & gate[np.arange(S), jc]
    energy = (-b[np.arange(S), jc][matched].sum()
              + penalty * (max(S, C) - matched.sum()))
    n = max(S, C)
    cost = np.full((n, n), penalty, np.float64)
    cost[:S, :C] = np.where(gate, -b, penalty)
    ri, ci = linear_sum_assignment(cost)
    eps = float(M[5][2])
    assert energy <= cost[ri, ci].sum() + (S + 2) * eps + 1e-3
