"""Fixed-shape match encoding shared by the matchers."""
from __future__ import annotations

from typing import NamedTuple

import torch


class MatchResult(NamedTuple):
    tgt_idx: torch.Tensor    # [S] int — matched target per source row
    w: torch.Tensor          # [S] float32 1/0
    n_matches: torch.Tensor  # scalar
