"""Nearest-neighbour correspondence matchers (penalty-gated NN, reciprocal
NN) and the fixed-shape match encoding shared by every matcher.

Counterparts of the JAX package's ``matching/matchers.py`` (the
reference's ``findcorrespondenceNN`` / ``NNR``): masked argmin reductions
over a dense cost matrix that holds +inf at masked pairs.  Both take an
optional leading pair axis ([P, S, T] costs, [P, S] / [P, T] masks, [P]
penalties).  Ties: the lowest column in a row (``argmin`` returns the first
minimum), the lowest row at a column minimum.  Under a distributed
``comm`` the rows are this rank's shard: NN is row-local (its match count
is summed), NNR resolves each column's minimum and its lowest global row
over the ranks (pmin of the value, then of the row id).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ghicp_tpu_torch.core.comm import LOCAL, Comm

BIG_ROW = 2**30


class MatchResult(NamedTuple):
    tgt_idx: torch.Tensor    # [S] int — matched target per source row
    w: torch.Tensor          # [S] float32 1/0
    n_matches: torch.Tensor  # scalar


def nn_match(cd, penalty, mask_s, mask_t, comm: Comm = LOCAL) -> MatchResult:
    """Closest target per source row, kept where its cost is below the
    penalty gate."""
    penalty = torch.as_tensor(penalty, dtype=cd.dtype, device=cd.device)
    j = cd.argmin(dim=-1)
    mincd = cd.amin(dim=-1)
    w = (mask_s & (mincd < penalty[..., None])).to(torch.float32)
    return MatchResult(tgt_idx=j, w=w, n_matches=comm.psum(w.sum(dim=-1)))


def nnr_match(cd, mask_s, mask_t, comm: Comm = LOCAL) -> MatchResult:
    """Reciprocal nearest neighbours, no gate: row i keeps its closest
    column j where i is the lowest (global) row at column j's minimum, and
    its minimum is finite."""
    S = cd.shape[-2]
    rows = comm.axis_index() * S + torch.arange(S, device=cd.device)
    sv = cd.argmin(dim=-1)
    colmin = comm.pmin(cd.amin(dim=-2, keepdim=True))
    tv = comm.pmin(torch.where(cd == colmin, rows[:, None], BIG_ROW)
                   .amin(dim=-2))
    mutual = tv.gather(-1, sv) == rows
    ok = mask_s & mutual & torch.isfinite(cd.amin(dim=-1))
    w = ok.to(torch.float32)
    return MatchResult(tgt_idx=sv, w=w, n_matches=comm.psum(w.sum(dim=-1)))
