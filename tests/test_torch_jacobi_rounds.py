"""The port's Jacobi auction rounds (plain versions of kernels K7 and K8)
against the JAX package's ``auction_rounds_ref`` (bit for bit, float32 and
bf16 benefits, the highest-row tie rule), on one small case against its
Pallas kernels in interpret mode, and against the port's Gauss-Seidel
phase (K2's plain version): the cases of tests/test_auction_rounds.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ghicp_tpu.ops.auction_rounds import (auction_phase_pallas,
                                          auction_rounds_pallas,
                                          auction_rounds_ref)
from ghicp_tpu_torch.ops import LAUNCHES, reset_launches
from ghicp_tpu_torch.ops.auction_rounds import (auction_phase,
                                                auction_phase_gs,
                                                auction_rounds)

torch.set_num_threads(1)
T = torch.from_numpy


def _benefits(seed, S, C, masked):
    rng = np.random.default_rng(seed)
    b = rng.uniform(-4, 0, (S, C)).astype(np.float32)
    if masked:
        b[rng.random((S, C)) < masked] = -3e38
    return b


def _cold(S, C):
    return (np.zeros(C, np.float32), np.full(C, -1, np.int32),
            np.zeros(S, np.int32))


def _ref(b, state, eps, sink, n):
    out = auction_rounds_ref(jnp.asarray(b), *map(jnp.asarray, state), eps,
                             sink, n)
    return [np.asarray(x) for x in out]


def _port(fn, b, state, eps, sink, n):
    return [np.asarray(x) for x in fn(T(b), *map(T, state), eps, sink, n)]


def _assert_equal(got, want):
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("n_rounds", [1, 7, 40])
def test_rounds_match_ref(n_rounds):
    """tests/test_auction_rounds.py:12 (its kernel at ts = 256)."""
    b = _benefits(0, 512, 640, 0.3)
    state = _cold(512, 640)
    _assert_equal(_port(auction_rounds, b, state, 0.05, -2.0, n_rounds),
                  _ref(b, state, 0.05, -2.0, n_rounds))


def test_phase_matches_ref_and_exits_early():
    """tests/test_auction_rounds.py:29: the early-exit phase lands on the
    budgeted reference's fixed point, below the budget, every row owned or
    sunk."""
    S, C, budget = 512, 640, 400
    b = _benefits(2, S, C, 0.3)
    state = _cold(S, C)
    p, o, s, r = _port(auction_phase, b, state, 0.05, -2.0, budget)
    assert int(r) < budget
    owned = np.zeros(S, bool)
    owned[o[o >= 0]] = True
    assert np.all(owned | (s == 1))
    _assert_equal((p, o, s), _ref(b, state, 0.05, -2.0, budget))
    # the rounds it ran are the reference's to the same state
    _assert_equal((p, o, s), _ref(b, state, 0.05, -2.0, int(r)))


@pytest.mark.parametrize("budget", [1, 5])
def test_phase_budget_cap_matches_ref(budget):
    """tests/test_auction_rounds.py:54: below convergence the phase stops
    at exactly ``max_rounds``, with the state of that many rounds."""
    S = C = 256
    b = _benefits(3, S, C, 0.0)
    state = _cold(S, C)
    _, o5, s5, _ = _port(auction_phase, b, state, 0.01, -10.0, 5)
    owned = np.zeros(S, bool)
    owned[o5[o5 >= 0]] = True
    assert not np.all(owned | (s5 == 1))     # the cap binds
    p, o, s, r = _port(auction_phase, b, state, 0.01, -10.0, budget)
    assert int(r) == budget
    _assert_equal((p, o, s), _ref(b, state, 0.01, -10.0, budget))


@pytest.mark.parametrize("fn", ["rounds", "phase"])
def test_bf16_benefits_match_ref(fn):
    """tests/test_auction_rounds.py:79: bf16-stored benefits, computed in
    float32 on both sides."""
    S = C = 256
    b16 = jnp.asarray(_benefits(4, S, C, 0.0)).astype(jnp.bfloat16)
    bt = T(np.array(b16.astype(jnp.float32))).to(torch.bfloat16)
    state = _cold(S, C)
    want = auction_rounds_ref(b16, *map(jnp.asarray, state), 0.05, -2.0,
                              500)
    if fn == "rounds":
        got = auction_rounds(bt, *map(T, state), 0.05, -2.0, 500)
    else:
        got = auction_phase(bt, *map(T, state), 0.05, -2.0, 500)
        assert int(got[3]) < 500
    _assert_equal([np.asarray(x) for x in got[:3]],
                  [np.asarray(x) for x in want])


def test_rounds_warm_state_continues():
    """tests/test_auction_rounds.py:96: 10 rounds in one call equal two
    calls of 5 rounds with the state carried, and the reference."""
    S, C = 256, 384
    b = _benefits(1, S, C, 0.0)
    state = _cold(S, C)
    a = _port(auction_rounds, b, state, 0.1, -2.0, 10)
    m = _port(auction_rounds, b, state, 0.1, -2.0, 5)
    m = _port(auction_rounds, b, m, 0.1, -2.0, 5)
    _assert_equal(a, m)
    _assert_equal(a, _ref(b, state, 0.1, -2.0, 10))


def test_phase_narrow_matrix_matches_ref():
    """tests/test_auction_rounds.py:112 (its kernel at ts = 64): 256 x 384,
    a quarter of the pairs masked."""
    S, C = 256, 384
    b = _benefits(6, S, C, 0.25)
    state = _cold(S, C)
    got = _port(auction_phase, b, state, 0.05, -2.0, 300)
    assert int(got[3]) < 300
    _assert_equal(got[:3], _ref(b, state, 0.05, -2.0, 300))


def test_highest_row_wins_equal_bids():
    """Planted ties: pairs of identical rows bid the same value on the same
    column, and the higher row takes it, as the reference's scatter-max of
    row ids decides (the GS kernel's lowest-row rule is not this one)."""
    S, C = 256, 256
    b = _benefits(10, S, C, 0.0)
    b[1::2] = b[0::2]
    state = _cold(S, C)
    p, o, s = _port(auction_rounds, b, state, 0.05, -5.0, 1)
    _assert_equal((p, o, s), _ref(b, state, 0.05, -5.0, 1))
    won = o[o >= 0]
    assert len(won) > 50 and np.all(won % 2 == 1)


def test_interpret_kernels_match_port():
    """One small case against the Pallas kernels themselves (interpret
    mode, ts = 128): K7 at 7 rounds, K8 from a cold start to its exit."""
    S = C = 256
    b = _benefits(11, S, C, 0.2)
    state = _cold(S, C)
    js = [jnp.asarray(x) for x in state]
    k7 = auction_rounds_pallas(jnp.asarray(b), *js, 0.05, -2.0, 7, ts=128,
                               interpret=True)
    _assert_equal(_port(auction_rounds, b, state, 0.05, -2.0, 7),
                  [np.asarray(x) for x in k7])
    k8 = auction_phase_pallas(jnp.asarray(b), *js, 0.05, -2.0, 200, ts=128,
                              interpret=True)
    _assert_equal(_port(auction_phase, b, state, 0.05, -2.0, 200),
                  [np.asarray(x) for x in k8])


def test_gs_no_slower_than_jacobi_with_same_value():
    """tests/test_auction_rounds.py:177 on the port: K2's plain version
    reaches the all-assigned fixed point in no more sweeps than K8's takes
    rounds, and the assignment values agree within S * eps."""
    S, C = 512, 640
    b = _benefits(9, S, C, 0.3)
    eps, sink = 0.02, -2.0
    state = _cold(S, C)
    pj, oj, sj, rj = _port(auction_phase, b, state, eps, sink, 2000)
    pg, og, sg, rg, _ = auction_phase_gs(
        T(b), *map(T, state), torch.ones(S, dtype=torch.int32), eps, sink,
        2000, ts=128)

    def value(o, s):
        o = np.asarray(o)
        cols = np.nonzero(o >= 0)[0]
        return (float(b[o[cols], cols].sum())
                + sink * float(np.asarray(s).sum()))

    assert int(rg) <= int(rj)
    assert abs(value(og, sg) - value(oj, sj)) <= S * eps + 1e-3


def test_contract_checks_and_no_launch_on_cpu():
    """Shapes off the 128 grid and other element types raise; the CPU runs
    the plain version and counts no kernel launch."""
    state = [T(x) for x in _cold(200, 256)]
    with pytest.raises(ValueError):
        auction_rounds(torch.zeros(200, 256), *state, 0.05, -2.0, 1)
    state = [T(x) for x in _cold(256, 256)]
    with pytest.raises(ValueError):
        auction_phase(torch.zeros(256, 256, dtype=torch.float64), *state,
                      0.05, -2.0, 1)
    reset_launches()
    auction_phase(torch.zeros(256, 256), *state, 0.05, -2.0, 3)
    assert all(v == 0 for v in LAUNCHES.values())


def _warm(S, C, seed):
    """A warm state at S x C: rows 20.. own columns 10..99, row 3 owns two
    columns (5 and 6), row 200 owns column 7 and is sunk, row 201 is sunk,
    column 8 points past the rows; prices from ``seed``."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0, 1, C).astype(np.float32)
    owner = np.full(C, -1, np.int32)
    owner[10:100] = np.arange(20, 110, dtype=np.int32)
    owner[5] = owner[6] = 3
    owner[7] = 200
    owner[8] = S + 5
    sunk = np.zeros(S, np.int32)
    sunk[200] = sunk[201] = 1
    return p, owner, sunk


def _open_rows(owner, sunk):
    """The exact open-row count: rows neither owning a column nor sunk."""
    S = len(sunk)
    owned = np.zeros(S, bool)
    o = owner[(owner >= 0) & (owner < S)]
    owned[o] = True
    return int((~owned & (sunk == 0)).sum())


@pytest.mark.parametrize("n_rounds", [1, 6, 60])
def test_warm_row_owning_two_columns_rounds_match_ref(n_rounds):
    """K7 from a warm state where one row owns two columns (and a sunk row
    owns one, and a column points past the rows): the exact open-row test
    decides which rows bid, so K7 equals the reference at every budget."""
    S = C = 256
    b = _benefits(12, S, C, 0.1)
    state = _warm(S, C, 13)
    _assert_equal(_port(auction_rounds, b, state, 0.05, -2.0, n_rounds),
                  _ref(b, state, 0.05, -2.0, n_rounds))


def test_warm_row_owning_two_columns_phase_matches_interpret():
    """K8 from the same warm state against the JAX Pallas kernel in
    interpret mode, rounds included, and K7 at K8's rounds lands on the
    same state.  Then the count decides, not the open rows: with most
    columns pointing past the rows and six rows sunk, S - #owned -
    sum(sunk) is 0 while 159 rows are open, so K8 runs no round (as the
    JAX kernel) while K7 bids."""
    S = C = 256
    b = _benefits(12, S, C, 0.1)
    state = _warm(S, C, 13)
    js = [jnp.asarray(x) for x in state]
    want = auction_phase_pallas(jnp.asarray(b), *js, 0.05, -2.0, 500,
                                ts=128, interpret=True)
    got = _port(auction_phase, b, state, 0.05, -2.0, 500)
    _assert_equal(got, [np.asarray(x) for x in want])
    assert 0 < int(got[3]) < 500
    _assert_equal(_port(auction_rounds, b, state, 0.05, -2.0, int(got[3])),
                  got[:3])
    p, owner, sunk = (x.copy() for x in state)
    owner[100:] = S + 5
    sunk[202:206] = 1
    assert S - int((owner >= 0).sum()) - int(sunk.sum()) == 0
    assert _open_rows(owner, sunk) == 159
    busy = (p, owner, sunk)
    js = [jnp.asarray(x) for x in busy]
    want = auction_phase_pallas(jnp.asarray(b), *js, 0.05, -2.0, 500,
                                ts=128, interpret=True)
    got = _port(auction_phase, b, busy, 0.05, -2.0, 500)
    _assert_equal(got, [np.asarray(x) for x in want])
    assert int(got[3]) == 0
    _assert_equal(got[:3], busy)
    k7 = _port(auction_rounds, b, busy, 0.05, -2.0, 3)
    _assert_equal(k7, _ref(b, busy, 0.05, -2.0, 3))
    assert not np.array_equal(k7[1], owner)


@pytest.mark.parametrize("fn", ["rounds", "phase"])
def test_rounds_past_no_open_row_match_ref(fn):
    """K7 run far past the round where no row is open (and K8 with a budget
    past its exit) leaves the state of that round: exact against the
    reference at the full budget."""
    S, C = 256, 384
    b = _benefits(14, S, C, 0.2)
    state = _cold(S, C)
    _, o, s, r = _port(auction_phase, b, state, 0.1, -1.5, 2000)
    assert _open_rows(o, s) == 0 and int(r) < 100
    n = 5 * int(r) + 17
    f = auction_rounds if fn == "rounds" else auction_phase
    got = _port(f, b, state, 0.1, -1.5, n)
    _assert_equal(got[:3], _ref(b, state, 0.1, -1.5, n))
    _assert_equal(got[:3], _ref(b, state, 0.1, -1.5, int(r)))


@pytest.mark.parametrize("n_rounds", [1, 25])
def test_tie_heavy_column_goes_to_highest_row(n_rounds):
    """Groups of eight identical rows: in round 1 each group bids the same
    value on the same column and the group's highest row takes it; exact
    against the reference, then over later rounds."""
    S, C = 256, 256
    b = _benefits(15, S, C, 0.0)
    b[:] = b[::8].repeat(8, axis=0)
    state = _cold(S, C)
    got = _port(auction_rounds, b, state, 0.05, -5.0, n_rounds)
    _assert_equal(got, _ref(b, state, 0.05, -5.0, n_rounds))
    if n_rounds == 1:
        won = got[1][got[1] >= 0]
        assert len(won) >= 16 and np.all(won % 8 == 7)
