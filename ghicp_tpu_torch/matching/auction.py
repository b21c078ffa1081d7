"""Auction assignment (the port's KM solver), on one device or row-sharded.

Forward auction with an outside option: each open row bids for its best
column, ``bid = p[j1] + v1 - max(v2, sink) + eps``; columns go to the
highest bidder; rows whose best surplus falls below the sink take it.
Warm starts reuse the previous solve's prices and assignment: rows still
satisfying eps-complementary slackness keep their columns and only the
violators re-bid.  Two branches, with the JAX package's dispatch
(``matching/auction.py::auction_assign``):

* Gauss-Seidel — with ``use_round_kernel``, one pair and the GS phase
  kernel's shapes: each phase is one launch of
  :func:`ghicp_tpu_torch.ops.auction_rounds.auction_phase_gs` (K2), over a
  geometric epsilon ladder of ``n_phases`` rungs;
* Jacobi — otherwise: synchronous bidding rounds, each one top-2 sweep
  :func:`ghicp_tpu_torch.ops.top2.top2_rows` (K6) plus column-wise
  scatter-max resolution, epsilon divided by ``eps_scaling`` between
  phases.  Written over a leading pair axis ([P, R, C] benefits; a
  single-pair call is P = 1): a pair with no open row, or out of budget,
  keeps its state and its round counter while the others bid, the
  semantics of the JAX package's vmapped ``while_loop``.  The loop is on
  the host, with one read of the open-row counts a round (one for all
  pairs) and one read a phase.

Under a distributed ``comm`` (:mod:`ghicp_tpu_torch.core.comm`, one pair)
the rows are this rank's shard of ``total_rows``, with global row ids from
``row_offset``: a column's best bid and then its winner are maxima over
the ranks, owners are global row ids (their rebuild a pmax, a release a
pmin) and the open-row counts are summed.  The Gauss-Seidel branch then
runs sharded (:func:`_gs_sharded`, the JAX package's gate: one phase):
each rank makes one K2 launch a sweep on its rows, a column held by
another rank's row carrying the owner R (the kernel's scratch slot), and
after each sweep the ranks reconcile prices and winners by two maxima.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ghicp_tpu_torch.core.comm import LOCAL, Comm
from ghicp_tpu_torch.matching.matchers import MatchResult
from ghicp_tpu_torch.ops.auction_rounds import auction_phase_gs, gs_tile_rows
from ghicp_tpu_torch.ops.top2 import top2_rows

NEG = -3.0e38
SINK = 2**30      # "unmatched" pseudo-column (infinite capacity)


class AuctionResult(NamedTuple):
    """One solve's result; every field gains a leading [P] axis when the
    benefits have a pair axis."""

    match: MatchResult
    prices: torch.Tensor     # [C] final dual prices
    energy: torch.Tensor     # sum matched CD + penalty * n_unmatched
    rounds: torch.Tensor     # sweeps (GS) or bidding rounds (Jacobi)
    eps_used: torch.Tensor   # terminal (escalated) epsilon bound
    acol: torch.Tensor       # [R] column, SINK or -1: next warm start
    cd_sel: torch.Tensor     # [R] CD at the assigned column
    punc: torch.Tensor       # [C] per-column price uncertainty


def _f(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(dev)


def _per_pair(x, P: int, dev) -> torch.Tensor:
    """A scalar or [P] argument as a [P] float32 tensor."""
    return _f(x, dev).reshape(-1).expand(P)


def derive_acol(owner: torch.Tensor, sunk: torch.Tensor, R: int):
    """Row assignment from column owners: column id, SINK or -1."""
    C = owner.shape[0]
    acol = torch.full((R + 1,), -1, dtype=torch.int64, device=owner.device)
    own = owner.to(torch.int64)
    acol.scatter_(0, torch.where(own >= 0, own, R),
                  torch.arange(C, device=owner.device))
    acol = acol[:R]
    return torch.where((sunk == 1) & (acol < 0), SINK, acol)


def _drop_scatter(x: torch.Tensor, idx: torch.Tensor, src) -> torch.Tensor:
    """``x`` [P, N] with ``x[p, idx[p, k]] = src`` where ``idx`` < N; index
    N is dropped (the JAX ``mode="drop"`` scatter)."""
    ext = torch.cat([x, x.new_zeros((x.shape[0], 1))], dim=1)
    if not torch.is_tensor(src):
        src = torch.full(idx.shape, src, dtype=x.dtype, device=x.device)
    ext.scatter_(1, idx, src.expand(idx.shape).to(x.dtype))
    return ext[:, :-1]


def _select(keep_new: torch.Tensor, new, old):
    """Per pair: ``new`` where ``keep_new`` [P], else ``old``."""
    return tuple(torch.where(keep_new.reshape((-1,) + (1,) * (n.ndim - 1)),
                             n, o) for n, o in zip(new, old))


def _reopen_violators(b, sink, st, eps_prev, eps_now, comm: Comm = LOCAL):
    """Deflate the +eps bid overshoot and unassign rows violating eps-CS
    at the tightened epsilon (between phases of a ladder).  b [P, R, C];
    ``sink``, ``eps_prev``, ``eps_now`` [P]; state (owner [P, C], acol
    [P, R], p [P, C]).  The cascade sweeps 2-4 run for the pairs whose
    sweep 1 reopened a row on any rank (the JAX ``lax.cond``, picked per
    pair)."""
    owner, acol, p = st
    C = b.shape[-1]
    p = torch.clamp(p - (eps_prev - eps_now)[:, None], min=0.0)

    def sweep(owner, acol, p):
        v1 = torch.maximum(b.float() - p[:, None, :],
                           sink[:, None, None]).amax(dim=-1)
        real = (acol >= 0) & (acol < C)
        cur = torch.where(real, acol, 0)
        val = torch.where(acol == SINK, sink[:, None],
                          b.gather(-1, cur[..., None])[..., 0].float()
                          - p.gather(-1, cur))
        ok = (acol < 0) | (val >= v1 - eps_now[:, None])
        owner = comm.pmin(_drop_scatter(owner,
                                        torch.where(~ok & real, acol, C),
                                        -1))
        acol = torch.where(ok, acol, -1)
        p = torch.where(owner < 0, 0.0, p)
        return owner, acol, p

    st1 = sweep(owner, acol, p)
    reopened = comm.psum(((st1[1] == -1) & (acol != -1)).sum(dim=-1)) > 0
    if bool(reopened.any()):
        st4 = st1
        for _ in range(3):
            st4 = sweep(*st4)
        st1 = _select(reopened, st4, st1)
    return st1


def _local_rows(ids, cond, offset: int, R: int):
    """Global row ``ids`` as this rank's local rows where ``cond`` holds and
    the row is local, else R (dropped by :func:`_drop_scatter`)."""
    loc = ids - offset
    return torch.where(cond & (loc >= 0) & (loc < R), loc, R)


def _bidding_round(b, eps, sink, st, row_offset: int = 0,
                   comm: Comm = LOCAL):
    """One synchronous (Jacobi) bidding round over [P, R, C] benefits at
    epsilon ``eps`` [P] and outside option ``sink`` [P]; state (owner
    [P, C] global row ids, acol [P, R], p [P, C]); this rank's rows start
    at global row ``row_offset``."""
    owner, acol, p = st
    P, R, C = b.shape
    unassigned = acol < 0
    v1, j1, v2 = top2_rows(b, p)
    j1 = j1.to(torch.int64)
    to_sink = unassigned & (v1 <= sink[:, None])
    acol = torch.where(to_sink, SINK, acol)
    bidding = unassigned & ~to_sink
    v2 = torch.maximum(v2, sink[:, None])
    bid = ((p.gather(-1, j1) + v1) - v2) + eps[:, None]
    bid = torch.where(bidding, bid, NEG)
    win_bid = torch.full((P, C), NEG, dtype=torch.float32, device=b.device)
    win_bid.scatter_reduce_(1, j1, bid, "amax")
    win_bid = comm.pmax(win_bid)
    wb = win_bid.gather(-1, j1)
    is_best = bidding & (bid == wb) & (wb > NEG)
    rows = (row_offset + torch.arange(R, device=b.device)).expand(P, R)
    # among equal best bids the highest row id wins (a scatter-max)
    winner = torch.full((P, C), -1, dtype=torch.int64, device=b.device)
    winner.scatter_reduce_(1, j1, torch.where(is_best, rows, -1), "amax")
    winner = comm.pmax(winner)
    has = winner >= 0
    acol = _drop_scatter(acol, _local_rows(owner, has & (owner >= 0),
                                           row_offset, R), -1)
    acol = _drop_scatter(acol, _local_rows(winner, has, row_offset, R),
                         torch.arange(C, device=b.device))
    owner = torch.where(has, winner, owner)
    p = torch.where(has, win_bid, p)
    return owner, acol, p


def _esc_eps(eps, r, r0, esc_after, esc_period):
    """eps * 2^(max(r - r0 - esc_after, 0) / esc_period), in float32."""
    k = torch.as_tensor(np.maximum(r - r0 - esc_after, 0),
                        dtype=torch.float32).to(eps.device)
    return eps * torch.exp2(k / torch.as_tensor(
        esc_period, dtype=torch.float32).to(eps.device))


def _run_phase(b, eps, sink, st, r0: np.ndarray, max_rounds: np.ndarray,
               run: np.ndarray, row_offset: int = 0, comm: Comm = LOCAL):
    """Bid until every row of each running pair is assigned (to a column or
    the sink) or the pair's TOTAL round budget ``max_rounds`` is spent;
    epsilon escalates geometrically past a quarter of the remaining budget.
    Round counters are host integers.  Returns (state, rounds, terminal
    escalated epsilon)."""
    remaining = np.maximum(max_rounds - r0, 1)
    esc_after = np.maximum(remaining // 4, 1)
    esc_period = np.maximum(remaining // 16, 1)
    r = r0.copy()
    while True:
        n_open = comm.psum((st[1] < 0).sum(dim=-1)).cpu().numpy()
        go = run & (n_open > 0) & (r < max_rounds)
        if not go.any():
            break
        new = _bidding_round(b, _esc_eps(eps, r + 1, r0, esc_after,
                                         esc_period), sink, st, row_offset,
                             comm)
        st = _select(torch.as_tensor(go).to(b.device), new, st)
        r = r + go
    return st, r, _esc_eps(eps, r, r0, esc_after, esc_period)


def _jacobi(b, sink, eps_final, eps0, st, max_rounds: np.ndarray,
            active: np.ndarray, eps_scaling: float, row_offset: int = 0,
            comm: Comm = LOCAL):
    """The epsilon-scaling ladder of Jacobi phases: from ``eps0`` divide by
    ``eps_scaling`` down to ``eps_final``, reopening eps-CS violators only
    when another phase follows.  Returns (owner, acol, p, rounds [P] host,
    terminal epsilon [P])."""
    dev = b.device
    # XLA computes the division by the constant as a product with its
    # float32 reciprocal; so does this, to the same bits
    shrink = float(np.float32(1.0 / eps_scaling))
    done = ~active
    eps_now = eps0
    rounds = np.zeros_like(max_rounds)
    eps_term = eps_final
    while not done.all():
        run = ~done
        st_new, r_new, term_new = _run_phase(b, eps_now, sink, st, rounds,
                                             max_rounds, run, row_offset,
                                             comm)
        at_final = (eps_now <= eps_final * 1.0001).cpu().numpy()
        fin = at_final | (r_new >= max_rounds)
        eps_next = torch.maximum(eps_now * shrink, eps_final)
        again = run & ~fin
        if again.any():
            st_re = _reopen_violators(b, sink, st_new, eps_now, eps_next,
                                      comm)
            st_new = _select(torch.as_tensor(again).to(dev), st_re, st_new)
        run_t = torch.as_tensor(run).to(dev)
        st = _select(run_t, st_new, st)
        eps_now, eps_term = _select(run_t, (eps_next, term_new),
                                    (eps_now, eps_term))
        rounds = np.where(run, r_new, rounds)
        done = done | fin
    return st[0], st[1], st[2], rounds, eps_term


def _gs_phases(b, sink_t, eps_final, eps0, owner, acol, p, max_rounds: int,
               n_phases: int):
    """The GS branch for one pair: ``n_phases`` launches of K2 over a
    geometric ladder from ``eps0`` to exactly ``eps_final``, with the CS
    repair between phases and the last phase's in-kernel greedy
    completion.  Epsilon and the sink reach K2 as device scalars and the
    sweep count stays on the device: with one phase nothing is read back
    before the next launch (a ladder reads each phase's sweeps for the
    next one's budget).  Returns (acol [R], p [C], sweeps, eps bound)."""
    R, C = b.shape
    ts = gs_tile_rows(C)
    sunk = (acol == SINK).to(torch.int32)
    open_ = (acol == -1).to(torch.int32)
    remaining = int(max_rounds)
    spent = None
    ratio = None
    if n_phases > 1:
        ratio = torch.clamp((eps_final / torch.clamp(eps0, min=1e-30))
                            ** (1.0 / (n_phases - 1)), max=1.0)
    for k in range(n_phases):
        last = k == n_phases - 1
        eps_now = (eps_final if last
                   else torch.maximum(eps0 * ratio ** k, eps_final))
        esc_after = max(remaining // 4, 1)
        esc_period = max(remaining // 16, 1)
        p, owner_k, sunk, r, gcol = auction_phase_gs(
            b, p, owner.to(torch.int32), sunk, open_, eps_now, sink_t,
            remaining, ts=ts, esc_after=esc_after, esc_period=esc_period,
            complete_open=last)
        owner = owner_k.to(torch.int64)
        r = torch.as_tensor(r, device=b.device)
        spent = r if spent is None else spent + r
        if not last:
            remaining -= int(r)
            eps_next = torch.maximum(eps0 * ratio ** (k + 1), eps_final)
            acol = derive_acol(owner, sunk, R)
            st = _reopen_violators(
                b[None], sink_t.reshape(1), (owner[None], acol[None],
                                             p[None]),
                eps_now.reshape(1), eps_next.reshape(1))
            owner, acol, p = (x[0] for x in st)
            sunk = (acol == SINK).to(torch.int32)
            open_ = (acol == -1).to(torch.int32)
    acol = derive_acol(owner, sunk, R)
    gcol = gcol.to(torch.int64)
    acol = torch.where((acol == -1) & (gcol >= 0),
                       torch.where(gcol < C, gcol, SINK), acol)
    eps_bound = eps_final * torch.exp2(
        torch.clamp(r - esc_after, min=0).to(torch.float32)
        / float(esc_period))
    return acol, p, spent, eps_bound


def _gs_sharded(b, sink_t, eps_final, owner_g, acol, p, max_rounds: int,
                row_offset: int, comm: Comm):
    """The sharded Gauss-Seidel branch (one phase): each sweep is one K2
    launch of one sweep on this rank's rows at the escalated epsilon (the
    kernel's own escalation off), columns owned by another rank's row
    passed with the owner R; then every column goes to the highest price
    over the ranks and, among its bidders at that price, the highest
    global row; rows rebuild their columns from the reconciled owners.
    Prices only rise and winners pay their own bids: the asynchronous
    auction, with the single-device kernel's eps-CS end but not its
    trajectory.  Returns (acol [R], p [C], sweeps, eps bound)."""
    R, C = b.shape
    dev = b.device
    ts = gs_tile_rows(C)
    esc_after = max(int(max_rounds) // 4, 1)
    esc_period = max(int(max_rounds) // 16, 1)
    cols = torch.arange(C, device=dev)

    def esc(r: int):
        return eps_final * torch.exp2(torch.tensor(
            float(max(r - esc_after, 0)), device=dev) / float(esc_period))

    r = 0
    while True:
        n_open = int(comm.psum((acol == -1).sum()))
        if n_open == 0 or r >= int(max_rounds):
            break
        mine = (owner_g >= row_offset) & (owner_g < row_offset + R)
        owner_l = torch.where(mine, owner_g - row_offset,
                              torch.where(owner_g >= 0, R, -1))
        p2, owner_o, sunk_o, _, _ = auction_phase_gs(
            b, p, owner_l.to(torch.int32), (acol == SINK).to(torch.int32),
            (acol == -1).to(torch.int32), esc(r + 1), sink_t, 1, ts=ts,
            esc_after=0, esc_period=1, complete_open=False)
        owner_o = owner_o.to(torch.int64)
        won = (owner_o >= 0) & (owner_o < R) & (p2 > p)
        cand = torch.where(won, owner_o + row_offset, -1)
        win_p = comm.pmax(p2)
        winner = comm.pmax(torch.where((p2 >= win_p) & (cand >= 0), cand,
                                       -1))
        changed = (win_p > p) & (winner >= 0)
        owner_g = torch.where(changed, winner, owner_g)
        p = torch.where(changed, win_p, p)
        acol_n = torch.full((R + 1,), -1, dtype=torch.int64, device=dev)
        acol_n[_local_rows(owner_g, owner_g >= 0, row_offset, R)] = cols
        acol = torch.where((acol == SINK) | (sunk_o == 1), SINK,
                           acol_n[:R])
        r += 1
    return acol, p, torch.tensor(r, device=dev), esc(r)


def _batched(x, single: bool):
    """``x`` with a leading pair axis of 1 for a single-pair call."""
    if x is None or not single:
        return x
    return torch.as_tensor(x)[None]


def auction_assign(b, sink_value, eps, max_rounds, eps_scaling: float = 5.0,
                   rel_eps: float = 0.0,
                   p0: Optional[torch.Tensor] = None, price_uncertainty=None,
                   use_round_kernel: bool = False, n_phases: int = 4,
                   b_max=None, acol0: Optional[torch.Tensor] = None,
                   hint_v1: Optional[torch.Tensor] = None,
                   hint_vsel: Optional[torch.Tensor] = None,
                   keep_slack_extra=None, active=None, comm: Comm = LOCAL,
                   row_offset: Optional[int] = None):
    """Assignment on a benefit matrix b [R, C] or [P, R, C] (maximization)
    with an outside option at ``sink_value`` (a scalar or [P]).  Per-pair
    arguments gain the pair axis: ``p0``, ``acol0``, the hints; the
    scalars ``max_rounds``, ``b_max`` and ``keep_slack_extra`` may be [P];
    ``price_uncertainty`` is a scalar, [C] (one pair) or [P] / [P, C].
    ``active`` [P] (host bools, default all) lists the pairs to solve; the
    others keep their start state.  Under a distributed ``comm`` (one
    pair) ``b`` holds this rank's rows, the first at global row
    ``row_offset`` (default rank * R).  ``eps_scaling`` divides epsilon
    between the Jacobi branch's phases (the Gauss-Seidel branch's ladder
    has ``n_phases`` rungs).  Returns (acol [R], prices [C],
    rounds, eps_bound, punc [C]), each with the pair axis of ``b``."""
    single = b.ndim == 2
    if single:
        b = b[None]
        p0, acol0, hint_v1, hint_vsel = (_batched(x, True) for x in (
            p0, acol0, hint_v1, hint_vsel))
    P, R, C = b.shape
    dev = b.device
    if comm.distributed and P != 1:
        raise ValueError("auction_assign: a distributed solve takes one pair")
    if row_offset is None:
        row_offset = comm.axis_index() * R
    rows = row_offset + torch.arange(R, device=dev)
    sink = _per_pair(sink_value, P, dev)
    if b_max is None:
        b_max = comm.pmax(b.masked_fill(~torch.isfinite(b), float("-inf"))
                          .amax(dim=(-2, -1)).float().clamp(min=NEG))
    spread = torch.clamp(_per_pair(b_max, P, dev) - sink, min=0.0)
    eps_final = torch.maximum(_per_pair(eps, P, dev), rel_eps * spread)
    cold_eps0 = (eps_final if n_phases <= 1
                 else torch.maximum(spread / 8.0, eps_final))
    if p0 is None:
        eps0 = cold_eps0
        p_init = torch.zeros((P, C), dtype=torch.float32, device=dev)
    else:
        d = _f(price_uncertainty, dev)
        d = d.reshape(1, -1) if single else (
            d.reshape(-1, 1) if d.ndim < 2 else d)
        eps0 = torch.minimum(torch.maximum(d.amax(dim=-1), eps_final),
                             cold_eps0)
        p_init = torch.clamp(p0.to(torch.float32) - d, min=0.0)
    eps_keep = None
    if acol0 is None:
        owner_init = torch.full((P, C), -1, dtype=torch.int64, device=dev)
        acol_init = torch.full((P, R), -1, dtype=torch.int64, device=dev)
    else:
        acol0 = acol0.to(torch.int64)
        real0 = (acol0 >= 0) & (acol0 < C)
        jc0 = torch.where(real0, acol0, 0)
        # rebuild owners (duplicated columns keep the highest row)
        owner_init = torch.full((P, C + 1), -1, dtype=torch.int64,
                                device=dev)
        owner_init.scatter_reduce_(1, torch.where(real0, acol0, C),
                                   torch.where(real0, rows, -1), "amax")
        owner_init = comm.pmax(owner_init[:, :C])
        p_init = torch.where(owner_init >= 0, p_init, 0.0)
        if hint_v1 is not None:
            v1, vsel = hint_v1, hint_vsel
        else:
            v1 = (b.float() - p_init[:, None, :]).amax(dim=-1)
            vsel = (b.gather(-1, jc0[..., None])[..., 0].float()
                    - p_init.gather(-1, jc0))
        if keep_slack_extra is not None:
            eps_keep = torch.minimum(
                torch.maximum(_per_pair(keep_slack_extra, P, dev)
                              + 2.0 * eps_final, eps_final),
                torch.maximum(spread / 8.0, eps_final))
        else:
            eps_keep = eps0
        own_ok = real0 & (owner_init.gather(-1, jc0) == rows)
        keep = own_ok & (vsel >= v1 - eps_keep[:, None])
        stay_sunk = (acol0 == SINK) & (sink[:, None] >= v1
                                       - eps_keep[:, None])
        owner_init = comm.pmin(_drop_scatter(
            owner_init, torch.where(own_ok & ~keep, acol0, C), -1))
        acol_init = torch.where(keep, acol0,
                                torch.where(stay_sunk, SINK, -1))

    mr = np.broadcast_to(np.asarray(max_rounds, np.int64), (P,)).copy()
    ts = gs_tile_rows(C)
    gs_shape = (use_round_kernel and P == 1 and R % ts == 0
                and R % 128 == 0 and C % 128 == 0 and ts * C <= 256 * 8192)
    if gs_shape and comm.distributed and n_phases == 1:
        acol, p, spent, eps_bound = _gs_sharded(
            b[0], sink[0], eps_final[0], owner_init[0], acol_init[0],
            p_init[0], int(mr[0]), row_offset, comm)
        acol, p, eps_bound = acol[None], p[None], eps_bound.reshape(1)
        rounds = spent.reshape(1)
    elif gs_shape and not comm.distributed:
        acol, p, spent, eps_bound = _gs_phases(
            b[0], sink[0], eps_final[0], eps0[0], owner_init[0],
            acol_init[0], p_init[0], int(mr[0]), n_phases)
        acol, p, eps_bound = acol[None], p[None], eps_bound.reshape(1)
        rounds = spent.reshape(1)
    else:
        act = (np.ones(P, bool) if active is None
               else np.asarray(active, bool))
        _, acol, p, rounds, eps_bound = _jacobi(
            b, sink, eps_final, eps0, (owner_init, acol_init, p_init), mr,
            act, eps_scaling, row_offset, comm)
    cert = eps_keep if acol0 is not None else torch.zeros_like(eps_bound)
    punc = torch.where(p != p_init, 2.0 * eps_bound[:, None], cert[:, None])
    rounds = torch.as_tensor(rounds)
    if single:
        return acol[0], p[0], rounds[0], eps_bound[0], punc[0]
    return acol, p, rounds, eps_bound, punc


def _complete(acol, b, p, penalty, gate=None):
    """Greedy completion of rows still open at budget exhaustion: each
    takes its best column at the current prices (duplicates allowed), or
    the sink.  Skipped (one host read) when no row is open."""
    leftover = acol == -1
    if not bool(leftover.any()):
        return acol
    v = b.float() - p[..., None, :]
    if gate is not None:
        v = v.masked_fill_(~gate, NEG)
    j1 = torch.argmax(v, dim=-1)
    del v
    v1 = (b.gather(-1, j1[..., None])[..., 0].float() - p.gather(-1, j1))
    if gate is not None:
        v1 = torch.where(gate.gather(-1, j1[..., None])[..., 0], v1, NEG)
    return torch.where(leftover, torch.where(v1 > -penalty[..., None], j1,
                                             SINK), acol)


def _finish(real, acol, jc, penalty, S, T, p, rounds, eps_used, punc,
            cd_sel, comm: Comm = LOCAL):
    """The result; ``S`` the total rows (every rank's)."""
    w = real.to(torch.float32)
    cor = comm.psum(w.sum(dim=-1))
    matched_cd = comm.psum(torch.where(real, cd_sel, 0.0).sum(dim=-1))
    energy = matched_cd + penalty * (float(max(S, T)) - cor)
    match = MatchResult(tgt_idx=jc, w=w, n_matches=cor.to(torch.int64))
    return AuctionResult(match=match, prices=p, energy=energy,
                         rounds=rounds, eps_used=eps_used, acol=acol,
                         cd_sel=cd_sel, punc=punc)


def auction_match_benefits(b, penalty, mask_s, mask_t,
                           eps_final: float = 0.01, max_rounds=8000,
                           rel_eps: float = 0.0, p0=None,
                           price_uncertainty=None,
                           use_round_kernel: bool = False,
                           n_phases: int = 2, b_max=None, acol0=None,
                           hint_v1=None, hint_vsel=None,
                           keep_slack_extra=None, active=None,
                           comm: Comm = LOCAL,
                           total_rows: Optional[int] = None
                           ) -> AuctionResult:
    """Auction on a prebuilt benefit matrix b [S, T] or [P, S, T] (-CD at
    candidate pairs, very negative at masked pairs); the penalty gate is
    the sink.  Under a distributed ``comm`` ``b`` holds this rank's rows
    of ``total_rows``."""
    S, T = b.shape[-2:]
    dev = b.device
    penalty = _f(penalty, dev)
    acol, p, rounds, eps_used, punc = auction_assign(
        b, -penalty, eps_final, max_rounds, rel_eps=rel_eps, p0=p0,
        price_uncertainty=price_uncertainty,
        use_round_kernel=use_round_kernel, n_phases=n_phases, b_max=b_max,
        acol0=acol0, hint_v1=hint_v1, hint_vsel=hint_vsel,
        keep_slack_extra=keep_slack_extra, active=active, comm=comm)
    acol = _complete(acol, b, p, penalty)
    matched = (acol >= 0) & (acol < T)
    jc = torch.where(matched, acol, 0)
    bsel = b.gather(-1, jc[..., None])[..., 0].float()
    real = mask_s & matched & (bsel > -penalty[..., None])
    return _finish(real, acol, jc, penalty, total_rows or S, T, p, rounds,
                   eps_used, punc, -bsel, comm)


def auction_match(cd, penalty, mask_s, mask_t, eps_final: float = 0.01,
                  max_rounds=8000, rel_eps: float = 0.0, p0=None,
                  price_uncertainty=None, quantize_bf16: bool = False,
                  use_round_kernel: bool = False, n_phases: int = 4,
                  acol0=None, keep_slack_extra=None, active=None,
                  comm: Comm = LOCAL,
                  total_rows: Optional[int] = None) -> AuctionResult:
    """Global-optimal correspondence via auction on a cost matrix cd
    [S, T] or [P, S, T] (+inf at invalid pairs): maximize the matched
    (penalty - CD) over gated pairs with rows free to stay unmatched.
    ``quantize_bf16`` stores the benefits in bf16 (the type the GS phase
    kernel takes; the Jacobi lane takes either).  Under a distributed
    ``comm`` ``cd`` holds this rank's rows of ``total_rows``."""
    S, T = cd.shape[-2:]
    dev = cd.device
    penalty = _f(penalty, dev)
    gate = torch.isfinite(cd) & (cd < penalty[..., None, None])
    b = cd.neg().masked_fill_(~gate, NEG)
    if quantize_bf16:
        b = b.to(torch.bfloat16)
    acol, p, rounds, eps_used, punc = auction_assign(
        b, -penalty, eps_final, max_rounds, rel_eps=rel_eps, p0=p0,
        price_uncertainty=price_uncertainty,
        use_round_kernel=use_round_kernel, n_phases=n_phases,
        acol0=acol0, keep_slack_extra=keep_slack_extra, active=active,
        comm=comm)
    acol = _complete(acol, b, p, penalty, gate)
    del b
    matched = (acol >= 0) & (acol < T)
    jc = torch.where(matched, acol, 0)
    cd_sel = cd.gather(-1, jc[..., None])[..., 0]
    real = mask_s & matched & gate.gather(-1, jc[..., None])[..., 0]
    return _finish(real, acol, jc, penalty, total_rows or S, T, p, rounds,
                   eps_used, punc, cd_sel, comm)
