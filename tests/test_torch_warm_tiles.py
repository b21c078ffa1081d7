"""A CPU model of K3's decomposition on the card (csrc/auction.cu
``warm_fused_kernel``) held bit for bit against the plain version.

Sweep 0: each lane's running top-2 over its 8-column pieces of every
1024-column chunk, the pieces of a row merged in a shuffled order (the
warp's shuffles), vsel and the benefit max as maxima, bands of rows in a
shuffled order.  Round 0: the bids' 64-bit maxima posted in a shuffled
order.  The Gauss-Seidel sweeps: for each active tile every block holds
its own replica of the prices, owners and open flags; the tile's open rows
are cut into column parts over the blocks, the parts merged in a shuffled
order, the tile's bid rule decided from the merged parts, and the
replica's writes made in a shuffled order (the concurrent threads of a
block).  Then one case of the model against the JAX kernel in interpret
mode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ghicp_tpu.ops.auction_rounds import auction_warm_fused_pallas
from ghicp_tpu_torch.ops.auction_rounds import (NEG,
                                                auction_warm_fused_plain,
                                                escalation_schedule,
                                                factor_benefits)
from ghicp_tpu_torch.ops.cost_kernel import _factors

torch.set_num_threads(1)

# the kernel's decomposition constants (csrc/auction.cu)
BAND, CHUNK, PASS, LANE_COLS, GMAX = 64, 1024, 256, 8, 16
F32 = np.float32


def _key(v, row):
    """(orderable(v) << 32) | (0xFFFFFFFF - row), the kernels' bid key."""
    u = int(np.float32(v).view(np.uint32))
    o = (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)
    return (o << 32) | (0xFFFFFFFF - int(row))


def _val(key):
    o = key >> 32
    u = (o & 0x7FFFFFFF) if o & 0x80000000 else (~o & 0xFFFFFFFF)
    return np.uint32(u).view(np.float32)


def _top2(v, cols):
    """A lane's running top-2 over columns ``cols`` (increasing) of the
    rows ``v`` [R, len(cols)]: highest value, lowest column on ties, v2
    the best of the rest floored at NEG (t2_push from t2_empty)."""
    i1 = np.argmax(v, axis=1)
    v1 = v[np.arange(len(v)), i1]
    rest = v.copy()
    rest[np.arange(len(v)), i1] = -np.inf
    v2 = np.maximum(rest.max(axis=1), F32(NEG)) if v.shape[1] > 1 else \
        np.full(len(v), F32(NEG), F32)
    return v1, cols[i1], v2.astype(F32)


def _merge(a, b):
    """t2_merge, row-wise."""
    bw = (b[0] > a[0]) | ((b[0] == a[0]) & (b[1] < a[1]))
    return (np.where(bw, b[0], a[0]), np.where(bw, b[1], a[1]),
            np.where(bw, np.maximum(b[2], a[0]),
                     np.maximum(a[2], b[0])).astype(F32))


def _merged(parts, rng):
    order = rng.permutation(len(parts))
    out = parts[order[0]]
    for k in order[1:]:
        out = _merge(out, parts[k])
    return out


def _model(bt, p0, owner0, acol0, sunk0, own_ok, ms, sink, eps_abs, rel_eps,
           dpen, max_rounds, ts, sched, nblocks, rng):
    """K3 as the card decomposes it; returns the plain version's outputs
    and the kernel's trace [open after the keep test, sweeps, rows
    scanned, active tiles a sweep...]."""
    S, C = bt.shape
    sink = F32(sink)
    # ---- sweep 0 ----
    hv1 = np.zeros(S, F32)
    hj1 = np.zeros(S, np.int64)
    hv2 = np.zeros(S, F32)
    hvsel = np.zeros(S, F32)
    bmax = F32(NEG)
    pieces = [np.arange(c, c + LANE_COLS)
              for cb in range(0, C, CHUNK)
              for ps in range(cb, min(cb + CHUNK, C), PASS)
              for c in range(ps, ps + PASS, LANE_COLS) if c < C]
    for band in rng.permutation(-(-S // BAND)):
        rows = np.arange(band * BAND, min((band + 1) * BAND, S))
        v = (bt[rows] - p0[None, :]).astype(F32)
        t = _merged([_top2(v[:, c], c) for c in pieces], rng)
        hv1[rows], hj1[rows], hv2[rows] = t
        a = acol0[rows]
        real = (a >= 0) & (a < C)
        vs = np.full(len(rows), F32(NEG), F32)
        for k in rng.permutation(len(pieces)):
            c = pieces[k]
            hit = real & (a >= c[0]) & (a <= c[-1])
            vs = np.where(hit, np.maximum(vs, v[np.arange(len(rows)),
                                                np.where(hit, a, 0)]), vs)
            bmax = max(bmax, F32(bt[rows][:, c].max()))
        hvsel[rows] = vs
    # ---- keep test, release, round-0 bids ----
    spread = max(F32(bmax - sink), F32(0.0))
    eps = max(F32(eps_abs), F32(F32(rel_eps) * spread))
    hi = max(F32(spread / F32(8.0)), eps)
    eps_keep = min(max(F32(F32(dpen) + F32(F32(2.0) * eps)), eps), hi)
    p = p0.copy()
    owner = owner0.astype(np.int64).copy()
    thr = (hv1 - eps_keep).astype(F32)
    keep = own_ok & (hvsel >= thr)
    stay = (sunk0 != 0) & (sink >= thr)
    open_t = ms & ~(keep | stay)
    to_sink = open_t & (hv1 <= sink)
    sunk = (stay | to_sink | ~ms).astype(np.int32)
    bidding = open_t & ~to_sink
    open_ = bidding.astype(np.int32)
    real0 = (acol0 >= 0) & (acol0 < C)
    owner[acol0[own_ok & ~keep & real0]] = -1
    slot = {}
    for i in rng.permutation(np.nonzero(bidding)[0]):
        delta = F32(F32(hv1[i] - max(hv2[i], sink)) + eps)
        k = _key(F32(delta + p0[hj1[i]]), i)
        slot[hj1[i]] = max(slot.get(hj1[i], 0), k)
    victims = []
    for c, k in slot.items():
        w = 0xFFFFFFFF - (k & 0xFFFFFFFF)
        victims.append(owner[c])
        owner[c] = w
        p[c] = _val(k)
        open_[w] = 0
    for v in victims:
        if v >= 0:
            open_[v] = 1
    # ---- Gauss-Seidel sweeps over the blocks' replicas ----
    U = C // 8
    gcap = min(GMAX, max(1, U // 64))
    r, scans, active = 1, 0, []
    while True:
        per_tile = open_.reshape(-1, ts).sum(axis=1)
        if per_tile.sum() == 0 or r >= max_rounds:
            break
        tiles = np.nonzero(per_tile)[0]
        active.append(len(tiles))
        eps_r = F32(eps * F32(sched[r]))
        for t in tiles:
            rows = t * ts + np.nonzero(open_[t * ts:(t + 1) * ts])[0]
            n = len(rows)
            scans += n
            g = min(gcap, max(1, nblocks // n))
            parts = []
            for q in range(g):
                c = np.arange(q * U // g * 8, (q + 1) * U // g * 8)
                v = (bt[rows][:, c] - p[c][None, :]).astype(F32)
                # the block's threads, 8 columns each, merged in any order
                parts.append(_merged([_top2(v[:, k:k + 8], c[k:k + 8])
                                      for k in range(0, len(c), 8)], rng))
            v1, j1, v2 = _merged(parts, rng)
            keys = {}
            for i in range(n):
                if v1[i] > sink:
                    d = F32(F32(v1[i] - max(v2[i], sink)) + eps_r)
                    keys[i] = _key(d, rows[i])
            for i in rng.permutation(n):
                row = rows[i]
                if i not in keys:
                    open_[row] = 0
                    sunk[row] = 1
                    continue
                col = j1[i]
                if any(j1[m] == col and keys[m] > keys[i] for m in keys):
                    continue
                victim = owner[col]
                owner[col] = row
                p[col] = F32(p[col] + _val(keys[i]))
                open_[row] = 0
                if victim >= 0:
                    open_[victim] = 1
        r += 1
    v1n = (hv1 + (p0[hj1] - p[hj1]).astype(F32)).astype(F32)
    gcol = np.where(open_ > 0, np.where(v1n > sink, hj1, C), -1)
    stats = np.array([bmax, 0.0, eps, eps_keep], F32)
    return ((p, owner.astype(np.int32), sunk, r, gcol.astype(np.int32),
             stats), [int(bidding.sum()), r, scans] + active)


def _problem(seed, mult, S=768, C=1024):
    """Keypoints, FD (a Hamming-like matrix, or a similarity in [0, 1]
    with exact zeros), masks and a warm state as the engine derives it:
    last columns (some shared by two rows, some rows parked at the sink),
    the owners (the highest row of a column), own_ok and prices."""
    rng = np.random.default_rng(seed)
    kps = rng.uniform(-4, 4, (S, 3)).astype(F32)
    kpt = np.concatenate([kps[:C // 2] + rng.normal(0, 0.05, (C // 2, 3)),
                          rng.uniform(-4, 4, (C - C // 2, 3))]).astype(F32)
    if mult:
        fd = rng.uniform(0, 1, (S, C))
        fd[::7, ::5] = 0.0
    else:
        fd = rng.integers(0, 200, (S, C)).astype(np.float64)
    fd = torch.from_numpy(fd.astype(F32)).to(torch.bfloat16)
    ms = np.ones(S, bool)
    ms[S - 9:] = False
    mt = np.ones(C, bool)
    mt[C - 13:] = False
    acol0 = np.full(S, -1, np.int64)
    rows = rng.permutation(S)[:S // 2]
    acol0[rows] = rng.permutation(C)[:S // 2]
    dup = rows[rng.random(len(rows)) < 0.1]
    acol0[dup] = acol0[rng.choice(rows, len(dup))]
    sunk0 = np.zeros(S, np.int32)
    parked = rng.permutation(np.setdiff1d(np.arange(S), rows))[:S // 8]
    sunk0[parked] = 1
    acol0[parked] = C          # the engine's sink marker is no real column
    real = (acol0 >= 0) & (acol0 < C)
    owner0 = np.full(C, -1, np.int64)
    np.maximum.at(owner0, acol0[real], np.nonzero(real)[0])
    own_ok = real & (owner0[np.where(real, acol0, 0)] == np.arange(S))
    p0 = np.where(owner0 >= 0, rng.uniform(0, 0.5, C), 0.0).astype(F32)
    return kps, kpt, fd, ms, mt, p0, owner0, acol0, sunk0, own_ok


@pytest.mark.parametrize("nblocks", [132, 7])
@pytest.mark.parametrize("budget", [1, 2, 16])
@pytest.mark.parametrize("mult", [False, True])
def test_warm_tiles_model_matches_plain(mult, budget, nblocks):
    kps, kpt, fd, ms, mt, p0, owner0, acol0, sunk0, own_ok = _problem(
        3 + budget, mult)
    S, C = fd.shape
    ts = 64
    wed, wfd = (1.0, 1.0 / 3.0) if mult else (0.7, 0.3)
    scale, sink, dpen = 0.15, (-1.2 if mult else -40.0), 0.05
    sched = escalation_schedule(budget, max(budget // 4, 1),
                                max(budget // 16, 1))
    T = torch.from_numpy
    want = auction_warm_fused_plain(
        T(kps), T(kpt), fd, T(ms), T(mt), wed, wfd, scale, T(p0),
        T(owner0), T(acol0), T(sunk0), T(own_ok), sink, 0.01, 1.0 / 64.0,
        dpen, budget, ts, sched, mult)
    bt = factor_benefits(_factors(T(kps)), _factors(T(kpt)), fd, T(ms),
                         T(mt), wed, wfd, scale, mult).numpy()
    got, trace = _model(bt, p0, owner0, acol0, sunk0, own_ok, ms, sink,
                        0.01, 1.0 / 64.0, dpen, budget, ts, sched.numpy(),
                        nblocks, np.random.default_rng(budget + nblocks))
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        if w.dtype == np.float32:
            g, w = g.astype(F32).view(np.uint32), w.view(np.uint32)
        assert np.array_equal(g, w)
    # the trace the kernel keeps: rows open after the keep test, sweeps,
    # rows scanned after round 0, active tiles of each sweep
    assert trace[0] > 0 and trace[1] == int(want[3])
    if budget > 1:
        assert trace[2] > 0 and len(trace) == 3 + trace[1] - 1


def test_warm_tiles_model_near_jax_kernel():
    """The model (bit-equal to the plain version above) against the JAX
    warm kernel in interpret mode on the FPFH/RoPS form from a cold start,
    as tests/test_torch_auction_rounds.py holds the plain version: owners
    on at least 99.5 % of the columns, sweeps within one."""
    kps, kpt, fd, ms, mt, *_ = _problem(21, True, S=512, C=1024)
    S, C = fd.shape
    sim = fd.to(torch.float32).numpy()
    wfd, scale, penalty, budget = 1.0 / 3.0, 0.15, 1.2, 16
    p0 = np.zeros(C, F32)
    o0 = np.full(C, -1, np.int32)
    a0 = np.full(S, -1, np.int32)
    s0 = np.zeros(S, np.int32)
    ok0 = np.zeros(S, bool)
    J = auction_warm_fused_pallas(
        jnp.asarray(kps), jnp.asarray(kpt),
        jnp.asarray(sim).astype(jnp.bfloat16), jnp.asarray(ms),
        jnp.asarray(mt), 1.0, wfd, scale, jnp.asarray(p0), jnp.asarray(o0),
        jnp.asarray(a0), jnp.asarray(s0), jnp.asarray(ok0), -penalty,
        0.02, 0.0, 0.0, budget, ts=128, esc_after=0, esc_period=1,
        mult_blend=True, quantize=False, interpret=True)
    T = torch.from_numpy
    bt = factor_benefits(_factors(T(kps)), _factors(T(kpt)), fd, T(ms),
                         T(mt), 1.0, wfd, scale, True).numpy()
    got, _ = _model(bt, p0, o0, a0, s0, ok0, ms, -penalty, 0.02, 0.0, 0.0,
                    budget, 128, escalation_schedule(budget, 0, 1).numpy(),
                    132, np.random.default_rng(0))
    assert np.mean(np.asarray(J[1]) == got[1]) >= 0.995
    assert abs(int(J[3]) - got[3]) <= 1
