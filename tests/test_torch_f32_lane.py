"""The float32 kernel lane (``auction_bf16=False``): the plain versions of
K1-f32, K2-f32 and K3-f32 against the JAX package's Pallas kernels in
interpret mode on a float32 FD / benefit matrix, and the engine on that
lane against the JAX package's fused lane (one iteration from an identical
state, and a whole run)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import __graft_entry__ as ge
import ghicp_tpu.matching.auction as jau
import ghicp_tpu.registration.ghicp as jgh
import ghicp_tpu_torch.registration.ghicp as tgh
from ghicp_tpu.core.comm import LOCAL
from ghicp_tpu.core.config import (CorrespondenceType, FeatureType,
                                   GHICPConfig)
from ghicp_tpu.ops.auction_rounds import (auction_phase_gs_pallas,
                                          auction_warm_fused_pallas)
from ghicp_tpu.ops.cost_kernel import fused_benefit as jax_fused_benefit
from ghicp_tpu.registration.pipeline import transform_error
from ghicp_tpu_torch.interop import config_from_dict, state_from_numpy
from ghicp_tpu_torch.ops.auction_rounds import (auction_phase_gs,
                                                auction_warm_fused)
from ghicp_tpu_torch.ops.cost_kernel import fused_benefit
from test_torch_auction_rounds import _gs_problem, _warm_fixture
from test_torch_cost_kernel import _fixture
from test_torch_engine import _to_numpy

torch.set_num_threads(1)
T = torch.from_numpy
S = C = 1024
BASE = GHICPConfig(feature=FeatureType.BSC,
                   correspondence=CorrespondenceType.KM, max_iterations=6,
                   auction_max_rounds=4, auction_bf16=False)


@pytest.mark.parametrize("mult", [False, True])
def test_plain_k1_f32_matches_jax_kernel(mult):
    """b in float32 (the FD's type on both sides) and the statistics.  The
    JAX kernel's cross term is a dot product (another order than the port's
    three float32 products), so b keeps the norm-expansion ED's absolute
    accuracy: within atol 1e-6 + rtol 1e-6 of |b| on the BSC blend; on the
    multiplicative one within atol 1e-3 + rtol 1e-4, as the exact zeros of
    the similarity (floored at 1e-6) scale ED and its error by
    1e-6^(-1/3) = 100, and exp / log are XLA's on one side; the statistics
    as tests/test_torch_cost_kernel.py holds them."""
    ks, kt, fd, ms, mt, p, acol0 = _fixture(seed=7 if mult else 0)
    if mult:
        fd = fd / 441.0
        fd[::5, ::3] = 0.0
    w = (1.0, 1.0 / 3.0, 0.22) if mult else (0.7, 0.3, 0.22)
    jk = jax_fused_benefit(jnp.asarray(ks), jnp.asarray(kt), jnp.asarray(fd),
                           jnp.asarray(ms), jnp.asarray(mt), *w, ts=128,
                           interpret=True, out_dtype=jnp.float32,
                           p_defl=jnp.asarray(p), acol0=jnp.asarray(acol0),
                           mult_blend=mult)
    got = fused_benefit(T(ks), T(kt), T(fd), T(ms), T(mt), *w, p_defl=T(p),
                        acol0=T(acol0), mult_blend=mult)
    assert got[0].dtype == torch.float32
    tol = dict(rtol=1e-4, atol=1e-3) if mult else dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jk[0]), **tol)
    assert float(got[1]) == float(jk[1])                     # count
    for i in (2, 3):                                         # sums
        np.testing.assert_allclose(float(got[i]), float(jk[i]), rtol=1e-4)
    for i in (4, 5):                                         # cd_max, ed_max
        np.testing.assert_allclose(float(got[i]), float(jk[i]), rtol=1e-5)
    np.testing.assert_allclose(float(got[6]), float(jk[6]), atol=1e-4)
    for i in (7, 8):                                         # v1, vsel
        np.testing.assert_allclose(got[i].numpy(), np.asarray(jk[i]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_plain_k2_f32_matches_jax_gs_kernel(start):
    """K2 on a float32 benefit matrix (not a bf16 one: the entries carry
    float32 bits) against the JAX GS kernel on the same matrix: bit-equal."""
    rng = np.random.default_rng(3)
    b = _gs_problem() + rng.uniform(0, 2 ** -10, (512, 640)).astype(
        np.float32) * (_gs_problem() > -1e38)
    Sb, Cb = b.shape
    eps, sink, budget = 0.05, -2.0, 40
    p0, o0 = np.zeros(Cb, np.float32), np.full(Cb, -1, np.int32)
    s0, op0 = np.zeros(Sb, np.int32), np.ones(Sb, np.int32)
    if start == "warm":
        p, o, s, _, _ = auction_phase_gs(T(b), T(p0), T(o0), T(s0), T(op0),
                                         eps, sink, 400, ts=128)
        p, o, s = p.numpy(), o.numpy(), s.numpy()
        rel = (np.random.default_rng(1).random(Cb) < 0.1) & (o >= 0)
        o0 = np.where(rel, -1, o).astype(np.int32)
        p0 = np.where(rel, 0.0, np.maximum(p - 2 * eps, 0.0)).astype(
            np.float32)
        owned = np.zeros(Sb, bool)
        owned[o0[o0 >= 0]] = True
        s0, op0 = s, (~owned & (s == 0)).astype(np.int32)
    J = auction_phase_gs_pallas(
        jnp.asarray(b), jnp.asarray(p0), jnp.asarray(o0), jnp.asarray(s0),
        jnp.asarray(op0), eps, sink, budget, ts=128, inner_cap=1,
        esc_after=0, esc_period=1, complete_open=1, interpret=True)
    M = auction_phase_gs(T(b), T(p0), T(o0), T(s0), T(op0), eps, sink,
                         budget, ts=128, complete_open=True)
    for j, m in zip(J, M):
        assert np.array_equal(np.asarray(j), np.asarray(m))


def test_plain_k3_f32_matches_jax_warm_kernel_and_hungarian():
    """K3 with a float32 FD that bf16 cannot hold (Hamming distances plus a
    fraction) against the JAX warm kernel on the same FD, as
    tests/test_torch_auction_rounds.py holds the bf16 one: owners, rounds,
    and the energy within n * eps of the Hungarian optimum."""
    kps, kpt, fd, ms, mt = _warm_fixture()
    fd = fd + np.random.default_rng(2).uniform(0, 0.5, fd.shape).astype(
        np.float32)
    Sw, Cw = fd.shape
    wed, wfd, scale, penalty = 0.7, 0.3, 0.15, 40.0
    p0, o0 = np.zeros(Cw, np.float32), np.full(Cw, -1, np.int32)
    acol0, s0 = np.full(Sw, -1, np.int32), np.zeros(Sw, np.int32)
    ok0 = np.zeros(Sw, bool)
    J = auction_warm_fused_pallas(
        jnp.asarray(kps), jnp.asarray(kpt), jnp.asarray(fd), jnp.asarray(ms),
        jnp.asarray(mt), wed, wfd, scale, jnp.asarray(p0), jnp.asarray(o0),
        jnp.asarray(acol0), jnp.asarray(s0), jnp.asarray(ok0), -penalty,
        0.5, 0.0, 0.0, 400, ts=128, esc_after=0, esc_period=1,
        quantize=False, interpret=True)
    M = auction_warm_fused(T(kps), T(kpt), T(fd), T(ms), T(mt), wed, wfd,
                           scale, T(p0), T(o0), T(acol0), T(s0), T(ok0),
                           -penalty, 0.5, 0.0, 0.0, 400, ts=128,
                           esc_after=0, esc_period=1)
    owner_j, owner_m = np.asarray(J[1]), M[1].numpy()
    assert np.mean(owner_j == owner_m) >= 0.995
    assert abs(int(J[3]) - int(M[3])) <= 1
    d = np.sqrt(np.maximum(((kps[:, None] - kpt[None]) ** 2).sum(-1), 0.0))
    b = np.where(ms[:, None] & mt[None], -(wed * scale * d + wfd * fd),
                 -3e38)
    acol = np.full(Sw, -1, np.int64)
    cols = np.nonzero(owner_m >= 0)[0]
    acol[owner_m[cols]] = cols
    gate = b > -penalty
    jc = np.where(acol >= 0, acol, 0)
    matched = (acol >= 0) & gate[np.arange(Sw), jc]
    energy = (-b[np.arange(Sw), jc][matched].sum()
              + penalty * (max(Sw, Cw) - matched.sum()))
    n = max(Sw, Cw)
    cost = np.full((n, n), penalty, np.float64)
    cost[:Sw, :Cw] = np.where(gate, -b, penalty)
    ri, ci = linear_sum_assignment(cost)
    assert energy <= cost[ri, ci].sum() + (Sw + 2) * float(M[5][2]) + 1e-3


@pytest.fixture(scope="module")
def problem():
    src, tgt, fd, a, b_, T_gt = ge._registration_problem(S, C, seed=13)
    # a float32 FD that bf16 cannot hold: the lane's reason to exist
    fd = fd + np.random.default_rng(4).uniform(0, 0.5, fd.shape).astype(
        np.float32)
    return src, tgt, fd, T_gt


@pytest.fixture
def interpret():
    old = (jgh._FUSED_INTERPRET, jau._KERNEL_INTERPRET)
    jgh._FUSED_INTERPRET = jau._KERNEL_INTERPRET = True
    try:
        yield
    finally:
        jgh._FUSED_INTERPRET, jau._KERNEL_INTERPRET = old


@pytest.fixture
def dtypes(monkeypatch):
    """The matrix types the engine hands K1, K2 and K3."""
    seen = {"fused_benefit": set(), "auction_phase_gs": set(),
            "auction_warm_fused": set()}

    def spy(mod, name, pos):
        fn = getattr(mod, name)

        def wrapper(*a, **k):
            seen[name].add(a[pos].dtype)
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapper)

    import ghicp_tpu_torch.matching.auction as tau
    spy(tgh, "fused_benefit", 2)
    spy(tau, "auction_phase_gs", 0)
    spy(tgh, "auction_warm_fused", 2)
    return seen


@pytest.mark.parametrize("start_it", [0, 2])
def test_one_iteration_f32_from_identical_state(problem, interpret, dtypes,
                                                start_it):
    """it 0 takes the full solve (K1-f32 + K2-f32), it 2 the warm kernel
    (K3-f32): cor equal, rt within 1e-4, the penalty within rtol 1e-3
    (tests/test_torch_engine.py's tolerances)."""
    src, tgt, fd, _ = problem
    ms, mt = np.ones(S, bool), np.ones(C, bool)
    body_j = jax.jit(jgh._make_body(jnp.asarray(tgt), jnp.asarray(ms),
                                    jnp.asarray(mt), jnp.asarray(fd),
                                    jnp.float32(40.0), BASE, LOCAL, S))
    st = jgh._initial_state(jnp.asarray(src), C, BASE)
    for _ in range(start_it):
        st = body_j(st)
    want = body_j(st)
    body_t = tgh.make_body(T(tgt), T(ms), T(mt), T(fd), 40.0,
                           config_from_dict(dataclasses.asdict(BASE)))
    got = body_t(state_from_numpy(_to_numpy(st), "cpu",
                                  BASE.max_iterations))
    i = start_it
    assert int(got.metrics.cor[i]) == int(np.asarray(want.metrics.cor)[i])
    np.testing.assert_allclose(got.rt.numpy(), np.asarray(want.rt),
                               atol=1e-4)
    np.testing.assert_allclose(float(got.pen_prev), float(want.pen_prev),
                               rtol=1e-3)
    kernel = "auction_warm_fused" if start_it else "fused_benefit"
    assert dtypes[kernel] == {torch.float32}


def test_whole_engine_f32(problem, interpret, dtypes):
    """tests/test_torch_engine.py's whole run on the float32 lane, with
    its final resolve: the port's pose within 0.1 deg / 0.02 m of the JAX
    fused lane's, both within 1 deg / 0.2 m of the truth, a one-to-one
    matching, and K1 and K2 handed a float32 matrix (the run converges
    before a warm iteration; the it-2 iteration above holds K3-f32)."""
    src, tgt, fd, T_gt = problem
    ms, mt = np.ones(S, bool), np.ones(C, bool)
    want = jgh.ghicp_register(jnp.asarray(src), jnp.asarray(ms),
                              jnp.asarray(tgt), jnp.asarray(mt),
                              jnp.asarray(fd), jnp.float32(40.0), BASE)
    got = tgh.ghicp_register_chunked(
        src, ms, tgt, mt, fd, 40.0,
        config_from_dict(dataclasses.asdict(BASE)), device="cpu")
    Tj, Tt = np.asarray(want.transform), got.transform.numpy()
    rot, tr = transform_error(Tt, Tj)
    assert rot < 0.1 and tr < 0.02, (rot, tr)
    for T_est in (Tj, Tt):
        rot, tr = transform_error(T_est, T_gt)
        assert rot < 1.0 and tr < 0.2, (rot, tr)
    m = got.matches.numpy()
    m = m[m >= 0]
    assert len(m) > S // 2 and len(np.unique(m)) == len(m)
    for name in ("fused_benefit", "auction_phase_gs"):
        assert dtypes[name] == {torch.float32}, name
