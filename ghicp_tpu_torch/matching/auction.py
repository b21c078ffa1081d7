"""Auction assignment (the port's KM solver), single device.

Forward auction with an outside option: each open row bids for its best
column, ``bid = p[j1] + v1 - max(v2, sink) + eps``; columns go to the
highest bidder; rows whose best surplus falls below the sink take it.  The
solve runs through the Gauss-Seidel phase kernel
(:func:`ghicp_tpu_torch.ops.auction_rounds.auction_phase_gs`), warm-started
from the previous solve's prices and assignment: rows still satisfying
eps-complementary slackness keep their columns and only the violators
re-bid.  Semantics follow the JAX package's ``matching/auction.py`` (its
single-device GS branch); the XLA Jacobi round loop and the sharded branch
are not ported yet, so shapes the GS kernel does not take raise.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ghicp_tpu_torch.matching.matchers import MatchResult
from ghicp_tpu_torch.ops.auction_rounds import auction_phase_gs, gs_tile_rows

NEG = -3.0e38
SINK = 2**30      # "unmatched" pseudo-column (infinite capacity)


class AuctionResult(NamedTuple):
    match: MatchResult
    prices: torch.Tensor     # [C] final dual prices
    energy: torch.Tensor     # sum matched CD + penalty * n_unmatched
    rounds: torch.Tensor     # sweeps executed
    eps_used: torch.Tensor   # terminal (escalated) epsilon bound
    acol: torch.Tensor       # [R] column, SINK or -1: next warm start
    cd_sel: torch.Tensor     # [R] CD at the assigned column
    punc: torch.Tensor       # [C] per-column price uncertainty


def _f(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(dev)


def derive_acol(owner: torch.Tensor, sunk: torch.Tensor, R: int):
    """Row assignment from column owners: column id, SINK or -1."""
    C = owner.shape[0]
    acol = torch.full((R + 1,), -1, dtype=torch.int64, device=owner.device)
    own = owner.to(torch.int64)
    acol.scatter_(0, torch.where(own >= 0, own, R),
                  torch.arange(C, device=owner.device))
    acol = acol[:R]
    return torch.where((sunk == 1) & (acol < 0), SINK, acol)


def _reopen_violators(b, sink_value, st, eps_prev, eps_now):
    """Deflate the +eps bid overshoot and unassign rows violating eps-CS
    at the tightened epsilon (between phases of a multi-phase ladder)."""
    owner, acol, p = st
    R, C = b.shape
    rows = torch.arange(R, device=b.device)
    p = torch.clamp(p - (eps_prev - eps_now), min=0.0)

    def sweep(owner, acol, p):
        v1 = torch.clamp(b.float() - p[None, :], min=sink_value).amax(dim=1)
        cur = torch.where((acol >= 0) & (acol < C), acol, 0)
        val = torch.where(acol == SINK, sink_value,
                          b[rows, cur].float() - p[cur])
        ok = (acol < 0) | (val >= v1 - eps_now)
        col = torch.where(~ok & (acol >= 0) & (acol < C), acol, C)
        ext = torch.cat([owner, owner.new_zeros(1)])
        ext.scatter_(0, col, -1)
        owner = ext[:C]
        acol = torch.where(ok, acol, -1)
        p = torch.where(owner < 0, 0.0, p)
        return owner, acol, p

    owner1, acol1, p1 = sweep(owner, acol, p)
    if bool(((acol1 == -1) & (acol != -1)).any()):
        for _ in range(3):
            owner1, acol1, p1 = sweep(owner1, acol1, p1)
    return owner1, acol1, p1


def auction_assign(b, sink_value, eps, max_rounds: int, rel_eps: float = 0.0,
                   p0: Optional[torch.Tensor] = None, price_uncertainty=None,
                   n_phases: int = 4, b_max=None,
                   acol0: Optional[torch.Tensor] = None,
                   hint_v1: Optional[torch.Tensor] = None,
                   hint_vsel: Optional[torch.Tensor] = None,
                   keep_slack_extra=None):
    """Assignment on a benefit matrix b [R, C] (maximization) with an
    outside option at ``sink_value``.  Returns (acol [R], prices [C],
    rounds, eps_bound, punc [C])."""
    R, C = b.shape
    dev = b.device
    ts = gs_tile_rows(C)
    if not (R % ts == 0 and R % 128 == 0 and C % 128 == 0
            and ts * C <= 256 * 8192):
        raise NotImplementedError(
            f"auction_assign: the GS phase kernel needs R % {ts} == 0, "
            f"R, C % 128 == 0 (got {R}x{C}); the Jacobi round loop is not "
            "ported yet")
    row_gid = torch.arange(R, device=dev)
    sink_t = _f(sink_value, dev)
    if b_max is None:
        bf = b.float()
        b_max = torch.where(torch.isfinite(bf), bf, NEG).amax()
    spread = torch.clamp(_f(b_max, dev) - sink_t, min=0.0)
    eps_final = torch.maximum(_f(eps, dev), _f(rel_eps, dev) * spread)
    cold_eps0 = (eps_final if n_phases <= 1
                 else torch.maximum(spread / 8.0, eps_final))
    if p0 is None:
        eps0 = cold_eps0
        p_init = torch.zeros((C,), dtype=torch.float32, device=dev)
    else:
        d = _f(price_uncertainty, dev)
        eps0 = torch.minimum(torch.maximum(d.max(), eps_final), cold_eps0)
        p_init = torch.clamp(p0 - d, min=0.0)
    eps_keep = None
    if acol0 is None:
        owner_init = torch.full((C,), -1, dtype=torch.int64, device=dev)
        acol_init = torch.full((R,), -1, dtype=torch.int64, device=dev)
    else:
        acol0 = acol0.to(torch.int64)
        real0 = (acol0 >= 0) & (acol0 < C)
        jc0 = torch.where(real0, acol0, 0)
        # rebuild owners (duplicated columns keep the highest row)
        owner_init = torch.full((C + 1,), -1, dtype=torch.int64, device=dev)
        owner_init.scatter_reduce_(0, torch.where(real0, acol0, C),
                                   torch.where(real0, row_gid, -1), "amax")
        owner_init = owner_init[:C]
        p_init = torch.where(owner_init >= 0, p_init, 0.0)
        if hint_v1 is not None:
            v1, vsel = hint_v1, hint_vsel
        else:
            v1 = (b.float() - p_init[None, :]).amax(dim=1)
            vsel = b[row_gid, jc0].float() - p_init[jc0]
        if keep_slack_extra is not None:
            eps_keep = torch.minimum(
                torch.maximum(_f(keep_slack_extra, dev) + 2.0 * eps_final,
                              eps_final),
                torch.maximum(spread / 8.0, eps_final))
        else:
            eps_keep = eps0
        own_ok = real0 & (owner_init[jc0] == row_gid)
        keep = own_ok & (vsel >= v1 - eps_keep)
        stay_sunk = (acol0 == SINK) & (sink_t >= v1 - eps_keep)
        rel = own_ok & ~keep
        ext = torch.cat([owner_init, owner_init.new_zeros(1)])
        ext.scatter_(0, torch.where(rel, acol0, C), -1)
        owner_init = ext[:C]
        acol_init = torch.where(keep, acol0, torch.where(stay_sunk, SINK, -1))

    owner, acol, p = owner_init, acol_init, p_init
    sunk = (acol == SINK).to(torch.int32)
    open_ = (acol == -1).to(torch.int32)
    remaining = int(max_rounds)
    spent = 0
    esc_after = esc_period = 1
    r = 0
    ratio = None
    if n_phases > 1:
        ratio = torch.clamp((eps_final / torch.clamp(eps0, min=1e-30))
                            ** (1.0 / (n_phases - 1)), max=1.0)
    gcol = None
    for k in range(n_phases):
        eps_now = (eps_final if k == n_phases - 1
                   else torch.maximum(eps0 * ratio ** k, eps_final))
        esc_after = max(remaining // 4, 1)
        esc_period = max(remaining // 16, 1)
        p, owner_k, sunk, r, gcol = auction_phase_gs(
            b, p, owner.to(torch.int32), sunk, open_, float(eps_now),
            float(sink_t), remaining, ts=ts, esc_after=esc_after, esc_period=esc_period,
            complete_open=(k == n_phases - 1))
        owner = owner_k.to(torch.int64)
        r = int(r)
        remaining -= r
        spent += r
        if k < n_phases - 1:
            eps_next = torch.maximum(eps0 * ratio ** (k + 1), eps_final)
            acol = derive_acol(owner, sunk, R)
            owner, acol, p = _reopen_violators(b, sink_t, (owner, acol, p),
                                               eps_now, eps_next)
            sunk = (acol == SINK).to(torch.int32)
            open_ = (acol == -1).to(torch.int32)
    acol = derive_acol(owner, sunk, R)
    gcol = gcol.to(torch.int64)
    acol = torch.where((acol == -1) & (gcol >= 0),
                       torch.where(gcol < C, gcol, SINK), acol)
    eps_bound = eps_final * torch.exp2(
        _f(max(r - esc_after, 0), dev) / float(esc_period))
    cert = eps_keep if acol0 is not None else _f(0.0, dev)
    punc = torch.where(p != p_init, 2.0 * eps_bound, cert)
    return acol, p, spent, eps_bound, punc


def _finish(real, acol, jc, penalty, S, T, p, rounds, eps_used, punc,
            cd_sel):
    w = real.to(torch.float32)
    cor = w.sum()
    matched_cd = torch.where(real, cd_sel, 0.0).sum()
    energy = matched_cd + penalty * (float(max(S, T)) - cor)
    match = MatchResult(tgt_idx=jc, w=w, n_matches=cor.to(torch.int64))
    return AuctionResult(match=match, prices=p, energy=energy,
                         rounds=torch.as_tensor(rounds), eps_used=eps_used,
                         acol=acol, cd_sel=cd_sel, punc=punc)


def auction_match_benefits(b, penalty, mask_s, mask_t,
                           eps_final: float = 0.01, max_rounds: int = 8000,
                           rel_eps: float = 0.0, p0=None,
                           price_uncertainty=None, n_phases: int = 2,
                           b_max=None, acol0=None, hint_v1=None,
                           hint_vsel=None,
                           keep_slack_extra=None) -> AuctionResult:
    """Auction on a prebuilt benefit matrix b [S, T] (-CD at candidate
    pairs, very negative at masked pairs); the penalty gate is the sink."""
    S, T = b.shape
    dev = b.device
    penalty = _f(penalty, dev)
    acol, p, rounds, eps_used, punc = auction_assign(
        b, -penalty, eps_final, max_rounds, rel_eps=rel_eps, p0=p0,
        price_uncertainty=price_uncertainty, n_phases=n_phases, b_max=b_max,
        acol0=acol0, hint_v1=hint_v1, hint_vsel=hint_vsel,
        keep_slack_extra=keep_slack_extra)
    rows = torch.arange(S, device=dev)
    leftover = acol == -1
    if bool(leftover.any()):
        j1 = torch.argmax(b.float() - p[None, :], dim=1)
        v1 = b[rows, j1].float() - p[j1]
        acol = torch.where(leftover, torch.where(v1 > -penalty, j1, SINK),
                           acol)
    matched = (acol >= 0) & (acol < T)
    jc = torch.where(matched, acol, 0)
    bsel = b[rows, jc].float()
    real = mask_s & matched & (bsel > -penalty)
    return _finish(real, acol, jc, penalty, S, T, p, rounds, eps_used, punc,
                   -bsel)


def auction_match(cd, penalty, mask_s, mask_t, eps_final: float = 0.01,
                  max_rounds: int = 8000, rel_eps: float = 0.0, p0=None,
                  price_uncertainty=None, n_phases: int = 4, acol0=None,
                  keep_slack_extra=None) -> AuctionResult:
    """Global-optimal correspondence via auction on a cost matrix cd
    [S, T] (+inf at invalid pairs): maximize the matched (penalty - CD)
    over gated pairs with rows free to stay unmatched.  The benefits are
    stored in bf16, the type the Gauss-Seidel phase kernel takes."""
    S, T = cd.shape
    dev = cd.device
    penalty = _f(penalty, dev)
    gate = torch.isfinite(cd) & (cd < penalty)
    b = torch.where(gate, -cd, NEG).to(torch.bfloat16)
    acol, p, rounds, eps_used, punc = auction_assign(
        b, -penalty, eps_final, max_rounds, rel_eps=rel_eps, p0=p0,
        price_uncertainty=price_uncertainty, n_phases=n_phases,
        acol0=acol0, keep_slack_extra=keep_slack_extra)
    rows = torch.arange(S, device=dev)
    leftover = acol == -1
    if bool(leftover.any()):
        j1 = torch.argmax(torch.where(gate, b.float() - p[None, :], NEG),
                          dim=1)
        v1 = torch.where(gate[rows, j1], b[rows, j1].float() - p[j1], NEG)
        acol = torch.where(leftover, torch.where(v1 > -penalty, j1, SINK),
                           acol)
    matched = (acol >= 0) & (acol < T)
    jc = torch.where(matched, acol, 0)
    cd_sel = cd[rows, jc]
    real = mask_s & matched & gate[rows, jc]
    return _finish(real, acol, jc, penalty, S, T, p, rounds, eps_used, punc,
                   cd_sel)
