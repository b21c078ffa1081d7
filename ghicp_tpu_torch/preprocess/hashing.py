"""int32 cell hashes shared by the voxel filter and the neighbor grid.

The three integer cell coordinates are mixed into 32 bits with wrap-around
arithmetic, exactly as the JAX package's int32 hashes wrap; the hash is
linear, so hash(c + offset) = hash(c) + hash(offset) (mod 2^32).
"""
from __future__ import annotations

import numpy as np
import torch

P1, P2, P3 = 73856093, 19349663, 83492791
IMAX = 2**31 - 1


def wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to the signed 32-bit range (two's complement)."""
    return torch.remainder(v + 2**31, 2**32) - 2**31


def cell_hash(xyz: torch.Tensor, min_xyz: torch.Tensor,
              cell: float) -> torch.Tensor:
    """[N] int64 holding the int32 hash of each point's cell."""
    inv = torch.tensor(1.0 / cell, dtype=torch.float32, device=xyz.device)
    ijk = torch.floor((xyz - min_xyz[None, :]) * inv).to(torch.int64)
    return wrap32(ijk[:, 0] * P1 + ijk[:, 1] * P2 + ijk[:, 2] * P3)


OFFSET_HASHES = np.array(
    [dx * P1 + dy * P2 + dz * P3
     for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
    dtype=np.int64)   # [27]
