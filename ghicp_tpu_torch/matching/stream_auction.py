"""Streaming (matrix-free) auction: the KM-equivalent solve of one engine
iteration with no [S, T] tensor (PyTorch port, one device or row-sharded).

Same forward-auction semantics as :mod:`ghicp_tpu_torch.matching.auction`
(outside-option sink = -penalty, epsilon-CS, price and assignment warm
starts), with every full-matrix reduction replaced by a sweep of kernel K5
(:func:`ghicp_tpu_torch.ops.stream_kernel.stream_sweep`): benefits are
rebuilt from the coordinate and feature factors inside each sweep (packed
BSC bits, FPFH/RoPS descriptor rows or, with :class:`NoFeatures`, none at
all; the features' type picks the blend).

A solve spends one sweep for the CD statistics and the warm-start hints
(sweep 0; skipped on the warm fast path, where a :class:`StreamCarry` from
the previous solve bounds each row's best value), then Jacobi bidding
sweeps with epsilon escalation over the first ``max_sweeps`` rounds, then a
greedy completion of the rows left open.  Once the open rows fit in
``open_cap``, sweeps run over only those rows (compaction), and such cheap
rounds may continue past the base budget up to ``compact_extra_sweeps``
at the frozen epsilon.  Semantics follow the JAX package's
``matching/stream_auction.py``; its control flow (``lax.cond`` /
``while_loop``) is a host loop here, with one read of the open-row count
a round.

Under a distributed ``comm`` the rows are this rank's shard of
``total_rows``: owners are global row ids (pmax to rebuild, pmin to
release), sweep 0's statistics are summed and its maxima maxed, each
round's best bids and winners are maxima over the ranks, and the open-row
and leftover counts are summed, so every rank takes the same branch.  The
ring lane passes its own sweep (``sweep_fn``, ``sweep_sub_fn``: these
carry collectives, so the compaction choice is then the ranks' largest
open count) and matched-pair gathers (``select_fn``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ghicp_tpu_torch.core import trace
from ghicp_tpu_torch.core.comm import LOCAL, Comm
from ghicp_tpu_torch.matching.auction import SINK, _local_rows
from ghicp_tpu_torch.matching.matchers import MatchResult
from ghicp_tpu_torch.ops.stream_kernel import (RT, SweepTarget,
                                               stream_selected, stream_sweep,
                                               subset_rows)

NEG = -3.0e38


class StreamSolveResult(NamedTuple):
    match: MatchResult
    prices: torch.Tensor     # [C]
    energy: torch.Tensor
    rounds: int              # bidding sweeps executed
    eps_used: torch.Tensor
    acol: torch.Tensor       # [S] column, SINK or -1
    cd_sel: torch.Tensor     # [S] matched-pair blended cost
    fd_sel: torch.Tensor     # [S] matched-pair feature distance
    penalty: torch.Tensor
    cd_mean: torch.Tensor
    cd_std: torch.Tensor
    ed_max: torch.Tensor     # drift-bound input for the next warm start
    v1_next: torch.Tensor    # [S] per-row bound on max_j (b - p): the carry
    b_max_next: torch.Tensor
    fd_max: torch.Tensor     # max FD over valid pairs (exact, permanent)
    punc: torch.Tensor       # [C] per-column price uncertainty
    open_rows: int           # rows open when bidding started
    compact_sweeps: int      # sweeps over a compacted block of open rows
    fast: bool               # the carry replaced sweep 0 (fast path)


class StreamCarry(NamedTuple):
    """Cross-iteration hint carry of the warm fast path (see the JAX
    package's ``StreamCarry`` for the soundness argument of each bound)."""

    ok: bool                 # the fields below are valid
    v1_ub: torch.Tensor      # [S] upper bound of each row's best value
    b_max: torch.Tensor      # benefit max at carry time
    ed_max: torch.Tensor     # ED max bound
    fd_max: torch.Tensor     # max FD over valid pairs
    v1_drift: torch.Tensor   # additive benefit-rise bound (keypoint motion)
    fd_term: torch.Tensor    # dwfd * fd_max: global wfd-decay rise bound
    decay_ratio: torch.Tensor  # dwfd / wfd_next: per-row decay bound


def carry_init(n_rows: int, device=None) -> StreamCarry:
    """An invalid carry of the right shapes (iteration 0)."""
    z = lambda: torch.zeros((), dtype=torch.float32, device=device)
    return StreamCarry(ok=False,
                       v1_ub=torch.zeros((n_rows,), dtype=torch.float32,
                                         device=device),
                       b_max=z(), ed_max=z(), fd_max=z(), v1_drift=z(),
                       fd_term=z(), decay_ratio=z())


def _resolve_round(v1, j1, v2, eps_r, sink, owner, acol, p,
                   row_offset: int = 0, comm: Comm = LOCAL):
    """One Jacobi bidding round from the rows' top-2: the highest bid wins
    a column (over every rank), and among equal bids the highest global
    row id; owners are global row ids, this rank's rows start at
    ``row_offset``."""
    R, C = v1.shape[0], p.shape[0]
    dev = v1.device
    rows = row_offset + torch.arange(R, device=dev)
    unassigned = acol == -1
    to_sink = unassigned & (v1 <= sink)
    acol = torch.where(to_sink, SINK, acol)
    bidding = unassigned & ~to_sink
    v2s = torch.maximum(v2, sink)
    bid = torch.where(bidding, p[j1] + v1 - v2s + eps_r, NEG)
    win_bid = torch.full((C,), NEG, dtype=torch.float32, device=dev)
    win_bid = comm.pmax(win_bid.scatter_reduce(0, j1, bid, "amax"))
    is_best = bidding & (bid == win_bid[j1]) & (win_bid[j1] > NEG)
    winner = torch.full((C,), -1, dtype=torch.int64, device=dev)
    winner = comm.pmax(winner.scatter_reduce(
        0, j1, torch.where(is_best, rows, -1), "amax"))
    has = winner >= 0
    ext = torch.cat([acol, acol.new_zeros(1)])
    ext[_local_rows(owner, has & (owner >= 0), row_offset, R)] = -1
    ext[_local_rows(winner, has, row_offset, R)] = torch.arange(C,
                                                                device=dev)
    return (torch.where(has, winner, owner), ext[:R],
            torch.where(has, win_bid, p))


def sweep_moments(sw):
    """(mean, std) of CD over a sweep's valid pairs.  Raises if the sweep
    ran without its statistics (``with_stats=False``: NaN)."""
    if trace.read(bool, torch.isnan(sw.cnt)):
        raise ValueError("sweep_moments: the sweep ran with_stats=False")
    cnt = torch.clamp(sw.cnt, min=1.0)
    mean = sw.cd_sum / cnt
    return mean, torch.sqrt(torch.clamp(sw.cd_sumsq / cnt - mean * mean,
                                        min=0.0))


def stream_solve(kp_s, kp_t, feats, mask_s, mask_t, wed, wfd, scale,
                 penalty_from_stats: Callable, eps_final: float,
                 rel_eps: float, max_sweeps: int, p0, price_uncertainty,
                 acol0, pen_prev, carry: Optional[StreamCarry] = None,
                 stats_free: bool = False, open_cap: int = 0,
                 compact_extra_sweeps: int = 0,
                 target: Optional[SweepTarget] = None, comm: Comm = LOCAL,
                 total_rows: Optional[int] = None,
                 sweep_fn: Optional[Callable] = None,
                 select_fn: Optional[Callable] = None,
                 sweep_sub_fn: Optional[Callable] = None
                 ) -> StreamSolveResult:
    """Matrix-free KM-equivalent solve for one engine iteration.

    ``penalty_from_stats(cd_mean, cd_std)`` gives the penalty (the engine
    owns the schedule).  ``p0`` / ``price_uncertainty`` / ``acol0`` /
    ``pen_prev`` warm-start as on the dense lane; ``price_uncertainty``
    excludes the penalty drift, which is added here.  ``carry`` with
    ``stats_free`` replaces sweep 0 by factor gathers at the kept columns
    and the carried bounds.  ``open_cap`` > 0 compacts the open rows into
    a block of that many rows (rounded up to the kernel's row tile) once
    they fit.  ``feats`` a ``DescFeatures``: the FPFH/RoPS lane (k in
    ``wfd``); a ``NoFeatures``: the feature-"none" lane (CD = W_ED * ED).
    ``target``: the sweeps' target inputs (``sweep_target`` of ``kp_t``,
    ``feats`` and ``mask_t``), made once by the caller; on the card each
    sweep makes its own without it.  ``comm`` and ``total_rows``: this
    rank's rows of a row-sharded solve.  ``sweep_fn(p, acol, with_stats)``,
    ``sweep_sub_fn(idx, sub_mask, p, acol_sub)`` and ``select_fn(tgt_idx)``
    replace the sweeps over ``feats`` and its gathers (the ring lane, with
    ``feats`` None).
    """
    S, C = kp_s.shape[0], kp_t.shape[0]
    dev = kp_s.device
    f = lambda x: torch.as_tensor(x, dtype=torch.float32).to(dev)
    row_offset = comm.axis_index() * S
    rows = torch.arange(S, device=dev)
    gid = row_offset + rows              # global row ids
    acol0 = acol0.to(torch.int64)
    cap = min(open_cap, S)
    if cap > 0:
        cap = min(-(-cap // RT) * RT, S)
    can_compact = 0 < cap < S and (sweep_fn is None
                                   or sweep_sub_fn is not None)
    # a ring sweep carries collectives: every rank compacts or none does
    uniform_compact = sweep_sub_fn is not None

    n_compact = 0
    if sweep_fn is None:
        def sweep_fn(p, ac, with_stats=False):
            return stream_sweep(kp_s, kp_t, feats, mask_s, mask_t, p, ac,
                                wed, wfd, scale, with_stats=with_stats,
                                target=target)
    if select_fn is None:
        def select_fn(jc):
            return stream_selected(kp_s, kp_t, feats, jc, wed, wfd, scale)

    def sub_sweep(idx, sub_mask, p, ac_sub):
        nonlocal n_compact
        n_compact += 1
        with trace.span("sweep"):
            if sweep_sub_fn is not None:
                return sweep_sub_fn(idx, sub_mask, p, ac_sub)
            return stream_sweep(kp_s[idx], kp_t, subset_rows(feats, idx),
                                sub_mask, mask_t, p, ac_sub, wed, wfd, scale,
                                with_stats=False, target=target)

    # --- sweep 0: statistics + warm-start hints at mid-deflated prices ---
    real0 = (acol0 >= 0) & (acol0 < C)
    owner0 = torch.full((C + 1,), -1, dtype=torch.int64, device=dev)
    owner0 = comm.pmax(owner0.scatter_reduce(
        0, torch.where(real0, acol0, C), torch.where(real0, gid, -1),
        "amax")[:C])
    d_pre = f(price_uncertainty)
    d_pre_max = d_pre.max()
    p_mid = torch.where(owner0 >= 0, torch.clamp(f(p0) - d_pre, min=0.0),
                        0.0)
    jc0 = torch.where(real0, acol0, 0)
    zero = f(0.0)
    fast = carry is not None and carry.ok and bool(stats_free)
    if fast:
        penalty = penalty_from_stats(zero, zero)
        cd0, _, _ = select_fn(jc0)
        vsel0 = torch.where(real0 & mask_s & mask_t[jc0],
                            -cd0 - p_mid[jc0], NEG)
        dp = torch.abs(penalty - f(pen_prev))
        A = carry.v1_ub + carry.v1_drift + d_pre_max + dp
        tight = torch.where(A > 0, A, A / (1.0 + carry.decay_ratio))
        bound = torch.minimum(A + carry.fd_term, tight)
        cd_mean = cd_std = zero
        b_max = torch.clamp(carry.b_max + carry.fd_term, max=0.0)
        ed_max, fd_max = carry.ed_max, carry.fd_max
        v1_base = bound - dp
        sw0_j1 = torch.zeros((S,), dtype=torch.int64, device=dev)
        sw0_v2 = torch.full((S,), NEG, dtype=torch.float32, device=dev)
        swept0 = False
    else:
        with trace.span("sweep"):
            sw0 = sweep_fn(p_mid, acol0, with_stats=True)
        if trace.read(bool, torch.isnan(sw0.cnt)):
            raise ValueError("stream_solve: sweep 0 ran without statistics")
        cnt, s1, s2 = comm.psum(torch.stack([sw0.cnt, sw0.cd_sum,
                                             sw0.cd_sumsq])).unbind()
        cd_mean, cd_std = sweep_moments(sw0._replace(cnt=cnt, cd_sum=s1,
                                                     cd_sumsq=s2))
        penalty = penalty_from_stats(cd_mean, cd_std)
        b_max, ed_max, fd_max = comm.pmax(torch.stack(
            [sw0.b_max, sw0.ed_max, sw0.fd_max])).unbind()
        v1_base, vsel0, sw0_j1, sw0_v2 = sw0.v1, sw0.vsel, sw0.j1, sw0.v2
        swept0 = True
    sink = -penalty
    spread = torch.clamp(b_max - sink, min=0.0)
    eps = torch.maximum(f(eps_final), f(rel_eps) * spread)

    # --- warm-start keep test (epsilon-CS under the new prices) ---
    dpen = torch.abs(penalty - f(pen_prev))
    v1_ub = v1_base + dpen
    eps0 = torch.minimum(torch.maximum(dpen + 2.0 * eps, eps),
                         torch.maximum(spread / 8.0, eps))
    own_ok = real0 & (owner0[jc0] == gid)
    keep = own_ok & (vsel0 >= v1_ub - eps0)
    stay_sunk = (acol0 == SINK) & (sink >= v1_ub - eps0)
    rel = own_ok & ~keep
    ext = torch.cat([owner0, owner0.new_zeros(1)])
    ext[torch.where(rel, acol0, C)] = -1
    owner = comm.pmin(ext[:C])
    acol = torch.where(keep, acol0, torch.where(stay_sunk, SINK, -1))
    p = torch.where(owner >= 0, torch.clamp(p_mid - dpen, min=0.0), 0.0)
    p_bid0 = p

    # --- Jacobi bidding sweeps with epsilon escalation ---
    budget = int(max_sweeps)
    extend = can_compact and compact_extra_sweeps > 0
    budget_ext = max(budget, int(compact_extra_sweeps)) if extend else budget
    esc_after = max(budget // 4, 1)

    def esc_eps(r: int):
        """Epsilon doubles each round past a quarter of the base budget
        and freezes beyond it."""
        return eps * torch.exp2(f(float(max(min(r, budget) - esc_after, 0))))

    neg_s = torch.full((S,), NEG, dtype=torch.float32, device=dev)

    def open_top2(rows_open, n_open: int, p, acol):
        """Top-2 of the open rows: compacted when they fit in ``cap``, else
        a full sweep; full-[S] (v1, j1, v2) with NEG at untouched rows,
        plus the fresh v1 observations and the rows they cover.
        ``n_open``: this rank's open rows (the ranks' largest count where
        the sweep carries collectives)."""
        if uniform_compact:
            n_open = trace.read(int, comm.pmax(torch.tensor(n_open,
                                                            device=dev)))
        if not can_compact or n_open > cap:
            with trace.span("sweep"):
                sw = sweep_fn(p, acol)
            return sw.v1, sw.j1, sw.v2, sw.v1, mask_s
        with trace.span("compact"):
            rank = torch.cumsum(rows_open.to(torch.int64), 0) - 1
            pos = torch.where(rows_open & (rank < cap), rank, cap)
            idx = torch.zeros((cap + 1,), dtype=torch.int64, device=dev)
            idx[pos] = rows
            idx = idx[:cap]
            filled = torch.zeros((cap + 1,), dtype=torch.bool, device=dev)
            filled[pos] = rows_open
            sub_mask = filled[:cap] & mask_s[idx]
            ac_sub = acol[idx]
        sw = sub_sweep(idx, sub_mask, p, ac_sub)
        with trace.span("compact"):
            idx_sc = torch.where(sub_mask, idx, S)
            v1 = torch.cat([neg_s, neg_s[:1]])
            v1[idx_sc] = sw.v1
            j1 = torch.zeros((S + 1,), dtype=torch.int64, device=dev)
            j1[idx_sc] = sw.j1
            v2 = torch.cat([neg_s, neg_s[:1]])
            v2[idx_sc] = sw.v2
            obs = torch.zeros((S + 1,), dtype=torch.bool, device=dev)
            obs[idx_sc] = sub_mask
        return v1[:S], j1[:S], v2[:S], v1[:S], obs[:S]

    # cold solves reuse sweep 0's top-2 for the first bidding round
    cold0 = not trace.read(bool, (owner0 >= 0).any())
    v1_obs = neg_s
    j1_obs = torch.zeros((S,), dtype=torch.int64, device=dev)
    obs = torch.zeros((S,), dtype=torch.bool, device=dev)
    r = 0
    while True:
        rows_open = acol == -1
        n_local = rows_open.sum()
        n_open = trace.read(int, comm.psum(n_local))
        # the extension needs every rank's open rows to fit its block
        n_most = (trace.read(int, comm.pmax(n_local))
                  if extend and comm.distributed else n_open)
        if r == 0:
            open_rows = n_open
        in_budget = r < budget or (extend and n_most <= cap
                                   and r < budget_ext)
        if n_open == 0 or not in_budget:
            break
        if r == 0 and cold0 and swept0:
            v1, j1, v2, v1_new, touched = (v1_base, sw0_j1, sw0_v2, v1_base,
                                           mask_s)
        else:
            v1, j1, v2, v1_new, touched = open_top2(
                rows_open, trace.read(int, n_local), p, acol)
        v1_obs = torch.where(touched, v1_new, v1_obs)
        j1_obs = torch.where(touched, j1, j1_obs)
        obs = obs | touched
        with trace.span("resolve"):
            owner, acol, p = _resolve_round(v1, j1, v2, esc_eps(r + 1), sink,
                                            owner, acol, p, row_offset, comm)
        r += 1

    # --- greedy completion at final prices (budget exhaustion) ---
    leftover = acol == -1
    n_left_local = leftover.sum()
    with trace.wait():
        n_left, n_unseen = (int(x) for x in comm.psum(torch.stack(
            [n_left_local, (leftover & ~obs).sum()])).unbind())
    if n_left > 0:
        stale = can_compact and n_left > cap and n_unseen == 0
        if stale:
            v1, j1 = v1_obs, j1_obs
        else:
            v1, j1, _, v1_new, touched = open_top2(
                leftover, trace.read(int, n_left_local), p, acol)
            v1_obs = torch.where(touched, v1_new, v1_obs)
            obs = obs | touched
        acol = torch.where(leftover, torch.where(v1 > sink, j1, SINK), acol)

    # --- selection, gate, energy (matrix-free gathers) ---
    matched = (acol >= 0) & (acol < C)
    jc = torch.where(matched, acol, 0)
    cd_sel, _, fd_sel = select_fn(jc)
    real = mask_s & matched & mask_t[jc] & (cd_sel < penalty)
    w = real.to(torch.float32)
    cor = comm.psum(w.sum())
    matched_cd = comm.psum(torch.where(real, cd_sel, 0.0).sum())
    energy = matched_cd + penalty * (float(max(total_rows or S, C)) - cor)
    eps_used = esc_eps(r)
    return StreamSolveResult(
        match=MatchResult(tgt_idx=jc, w=w, n_matches=cor), prices=p,
        energy=energy, rounds=r, eps_used=eps_used, acol=acol,
        cd_sel=cd_sel, fd_sel=fd_sel, penalty=penalty, cd_mean=cd_mean,
        cd_std=cd_std, ed_max=ed_max,
        v1_next=torch.where(obs, v1_obs, v1_ub), b_max_next=b_max,
        fd_max=fd_max,
        punc=torch.where(p != p_bid0, 2.0 * eps_used, eps0),
        open_rows=open_rows, compact_sweeps=n_compact, fast=fast)
