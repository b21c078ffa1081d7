"""Fixed-K radius neighbor search on a hashed grid (the KD-tree
replacement).

Support points are bucketed into cells of side ``radius`` (all neighbors
of a query live in its 27 surrounding cells), laid out as a cell table of
``[cap, 3]`` blocks in ascending hash order.  A query gathers its 27
blocks, tests the exact distance and keeps the K nearest.  Cells holding
more than ``cap`` points keep an evenly spaced subset (not the first
``cap``), as in the JAX package; the thinning arithmetic runs in int64, so
``rank * cap`` cannot overflow.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ghicp_tpu_torch.core.types import PointCloud
from ghicp_tpu_torch.preprocess.hashing import (IMAX, OFFSET_HASHES,
                                                cell_hash, wrap32)


class NeighborList(NamedTuple):
    idx: torch.Tensor     # [Nq, K] indices into the support
    valid: torch.Tensor   # [Nq, K] bool
    dist2: torch.Tensor   # [Nq, K] squared distances (inf where invalid)


class HashGrid(NamedTuple):
    """Support cloud sorted by cell hash (the baselines' nearest-neighbor
    grid)."""
    sorted_keys: torch.Tensor  # [N] int32 cell hashes, ascending
    order: torch.Tensor        # [N] permutation into the original support
    xyz: torch.Tensor          # [N, 3] support coordinates (original order)
    mask: torch.Tensor         # [N] support validity (original order)
    min_xyz: torch.Tensor      # [3] grid origin
    cell: float


def _point_hash(xyz: torch.Tensor, min_xyz: torch.Tensor,
                cell: float) -> torch.Tensor:
    """[N] int32 cell hashes with the JAX package's int32 wrap-around
    (summed in int64 and reduced, which gives the same bits)."""
    return cell_hash(xyz, min_xyz, cell).to(torch.int32)


def offset_hashes(hashes: torch.Tensor) -> torch.Tensor:
    """[..., 27] int32 hashes of the 27 cells around each int32 hash (the
    hash is linear, so a neighbor's is the sum, wrapped)."""
    off = torch.as_tensor(OFFSET_HASHES, device=hashes.device)
    return wrap32(hashes.to(torch.int64)[..., None] + off).to(torch.int32)


def build_grid(support: PointCloud, cell: float) -> HashGrid:
    """Hash each valid point's cell (padding takes IMAX) and sort stably
    by hash, as ``jnp.argsort`` does."""
    mn = torch.where(support.mask[:, None], support.xyz, 3e38).amin(dim=0)
    keys = torch.where(support.mask, _point_hash(support.xyz, mn, cell),
                       IMAX)
    sk, order = torch.sort(keys, stable=True)
    return HashGrid(sorted_keys=sk, order=order, xyz=support.xyz,
                    mask=support.mask, min_xyz=mn, cell=cell)


class CellTable(NamedTuple):
    hashes: torch.Tensor  # [M] ascending cell hashes; IMAX padding
    xyz: torch.Tensor     # [M, cap, 3] resident coordinates (zero padding)
    idx: torch.Tensor     # [M, cap] original support indices
    cnt: torch.Tensor     # [M] residents per cell (<= cap)
    min_xyz: torch.Tensor
    cell: float


def build_cell_table(support: PointCloud, cell: float, max_cells: int,
                     cap: int) -> CellTable:
    """Sort by cell hash, then place each point at (cell slot, rank)."""
    dev = support.xyz.device
    mn = torch.where(support.mask[:, None], support.xyz, 3e38).amin(dim=0)
    keys = torch.where(support.mask, cell_hash(support.xyz, mn, cell), IMAX)
    sk, order = torch.sort(keys, stable=True)
    n = sk.shape[0]
    ar = torch.arange(n, device=dev)
    heads = torch.ones(n, dtype=torch.bool, device=dev)
    heads[1:] = sk[1:] != sk[:-1]
    cell_id = torch.cumsum(heads.to(torch.int64), 0) - 1
    run_start = torch.cummax(torch.where(heads, ar, 0), 0).values
    rank = ar - run_start
    nxt_head = torch.ones(n, dtype=torch.bool, device=dev)
    nxt_head[:-1] = heads[1:]
    nxt = torch.flip(torch.cummin(torch.flip(
        torch.where(nxt_head, ar + 1, n), [0]), 0).values, [0])
    run_len = torch.clamp(nxt - run_start, min=1)
    over = run_len > cap
    keep = (~over) | (((rank + 1) * cap) // run_len > (rank * cap) // run_len)
    rank_k = torch.where(over, (rank * cap) // run_len, rank)
    in_table = (sk != IMAX) & (cell_id < max_cells)
    put = in_table & keep & (rank_k < cap)
    slot = torch.where(put, cell_id * cap + rank_k, max_cells * cap)
    flat = torch.zeros((max_cells * cap + 1, 3), dtype=torch.float32,
                       device=dev)
    flat[slot] = support.xyz[order]
    flat_idx = torch.zeros((max_cells * cap + 1,), dtype=torch.int64,
                           device=dev)
    flat_idx[slot] = order
    hashes = torch.full((max_cells + 1,), IMAX, dtype=torch.int64,
                        device=dev)
    hashes[torch.where(heads & in_table, cell_id, max_cells)] = sk
    cnt = torch.zeros((max_cells + 1,), dtype=torch.int64, device=dev)
    cnt.index_add_(0, torch.where(put, cell_id, max_cells),
                   torch.ones_like(cell_id))
    return CellTable(hashes=hashes[:max_cells],
                     xyz=flat[:-1].reshape(max_cells, cap, 3),
                     idx=flat_idx[:-1].reshape(max_cells, cap),
                     cnt=torch.clamp(cnt[:max_cells], max=cap),
                     min_xyz=mn, cell=cell)


def neighbor_cells(table: CellTable, hashes: torch.Tensor):
    """Table rows of the 27 cells around each hash: (cid [B, 27], exists)."""
    nh = hashes[:, None] + torch.as_tensor(OFFSET_HASHES,
                                           device=hashes.device)[None, :]
    nh = torch.remainder(nh + 2**31, 2**32) - 2**31
    M = table.hashes.shape[0]
    cid = torch.clamp(torch.searchsorted(table.hashes, nh.contiguous()),
                      max=M - 1)
    return cid, table.hashes[cid] == nh


def cell_candidates(table: CellTable, qxyz: torch.Tensor,
                    qmask: torch.Tensor):
    """Candidates of each query from its 27 cells: (cxyz [B, 27*cap, 3],
    cidx [B, 27*cap], ok [B, 27*cap]); ``ok`` covers cell existence and
    residency, not the radius test."""
    cap = table.xyz.shape[1]
    b = qxyz.shape[0]
    cid, exists = neighbor_cells(table,
                                 cell_hash(qxyz, table.min_xyz, table.cell))
    lane = torch.arange(cap, device=qxyz.device)
    ok = (exists[:, :, None]
          & (lane[None, None, :] < table.cnt[cid][:, :, None]))
    ok = ok.reshape(b, 27 * cap) & qmask[:, None]
    return (table.xyz[cid].reshape(b, 27 * cap, 3),
            table.idx[cid].reshape(b, 27 * cap), ok)


def radius_neighbors(query: PointCloud, support: PointCloud, radius: float,
                     k: int = 64, cell_cap: int = 16, chunk: int = 4096,
                     include_self: bool = True,
                     max_cells: int = 0) -> NeighborList:
    """K-capped fixed-radius neighbors of each query in the support
    (``include_self=False`` drops exact index matches)."""
    if max_cells <= 0:
        max_cells = support.capacity
    table = build_cell_table(support, cell=radius, max_cells=max_cells,
                             cap=cell_cap)
    n = query.capacity
    r2 = torch.tensor(radius * radius, dtype=torch.float32)
    outs = []
    for s in range(0, n, chunk):
        q = query.xyz[s:s + chunk]
        cxyz, cidx, ok = cell_candidates(table, q, query.mask[s:s + chunk])
        d2 = ((cxyz - q[:, None, :]) ** 2).sum(dim=-1)
        ok = ok & (d2 <= r2)
        if not include_self:
            self_idx = torch.arange(s, s + q.shape[0], device=q.device)
            ok = ok & (cidx != self_idx[:, None])
        d2 = torch.where(ok, d2, torch.inf)
        neg, sel = torch.topk(-d2, k, dim=1)
        outs.append((cidx.gather(1, sel), ok.gather(1, sel), -neg))
    return NeighborList(idx=torch.cat([o[0] for o in outs]),
                        valid=torch.cat([o[1] for o in outs]),
                        dist2=torch.cat([o[2] for o in outs]))
