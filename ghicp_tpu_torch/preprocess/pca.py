"""Neighborhood PCA: eigenvalues, curvature, normals (cell-pair sweep).

Queries are the residents of each occupied grid cell: a cell fetches its
27 neighbor blocks once, accumulates the ten raw moments of every
resident's in-radius neighbors (centred at the cell's resident mean, so
float32 stays accurate at 100 m coordinates), and the moments are
scattered back to point order before one batched 3x3 ``torch.linalg.eigh``.
Points that did not fit the table (cells over ``cell_cap``) take a
per-query fallback over the same table.

Feature definitions: curvature = l3 / (l1 + l2 + l3) with l1 >= l2 >= l3.
``torch.linalg.eigh`` returns ascending eigenvalues, so values and vectors
are flipped to the descending order the keypoint stage reads (which uses
eigenvalues and curvature only).  :func:`pca_from_neighbors` (the FPFH
normals) solves with the Jacobi ``ops/eigh3.py`` instead, whose
eigenvector signs are the JAX package's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ghicp_tpu_torch.core.types import PointCloud, bucket_size
from ghicp_tpu_torch.ops.eigh3 import eigh3
from ghicp_tpu_torch.preprocess.hashing import IMAX
from ghicp_tpu_torch.preprocess.neighbors import (CellTable, NeighborList,
                                                  build_cell_table,
                                                  cell_candidates,
                                                  neighbor_cells)

CELL_CHUNK = 256


class PCAFeatures(NamedTuple):
    eigvals: torch.Tensor      # [N, 3] descending
    principal: torch.Tensor    # [N, 3] eigenvector of l1
    normal: torch.Tensor       # [N, 3] eigenvector of l3
    curvature: torch.Tensor    # [N]
    n_neighbors: torch.Tensor  # [N]
    valid: torch.Tensor        # [N] valid & >= 3 neighbors


EIGH_BATCH = 8192    # cuSOLVER refuses batched syev of 32768 3x3 matrices


def eigh_desc(cov: torch.Tensor):
    """Batched symmetric 3x3 eigendecomposition, eigenvalues descending."""
    parts = [torch.linalg.eigh(c) for c in torch.split(cov, EIGH_BATCH)]
    vals = torch.cat([p[0] for p in parts])
    vecs = torch.cat([p[1] for p in parts])
    return vals.flip(-1), vecs.flip(-1)


def _features(cov: torch.Tensor, cnt: torch.Tensor, valid: torch.Tensor):
    vals, vecs = eigh_desc(cov)
    vals = torch.clamp(vals, min=0.0)
    total = vals.sum(dim=-1)
    curvature = torch.where(total > 0, vals[:, 2] / torch.clamp(total,
                                                              min=1e-30), 0.0)
    return PCAFeatures(eigvals=vals, principal=vecs[:, :, 0],
                       normal=vecs[:, :, 2], curvature=curvature,
                       n_neighbors=cnt.to(torch.int64), valid=valid)


def _outer6(d: torch.Tensor) -> torch.Tensor:
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return torch.stack([x * x, y * y, z * z, x * y, x * z, y * z], dim=-1)


def _cov_from6(s2: torch.Tensor) -> torch.Tensor:
    xx, yy, zz, xy, xz, yz = (s2[..., i] for i in range(6))
    return torch.stack([torch.stack([xx, xy, xz], -1),
                        torch.stack([xy, yy, yz], -1),
                        torch.stack([xz, yz, zz], -1)], -2)


def _pca_cell_pair(table: CellTable, radius: float, n_cells: int,
                   capacity: int) -> PCAFeatures:
    cap = table.xyz.shape[1]
    dev = table.xyz.device
    r2 = torch.tensor(radius * radius, dtype=torch.float32)
    lane = torch.arange(cap, device=dev)
    m_all = torch.zeros((capacity + 1, 10), dtype=torch.float32, device=dev)
    res_all = torch.zeros((capacity + 1,), dtype=torch.bool, device=dev)
    for s in range(0, n_cells, CELL_CHUNK):
        e = min(s + CELL_CHUNK, n_cells)
        b = e - s
        qxyz = table.xyz[s:e]                                 # [B, cap, 3]
        qok = lane[None, :] < table.cnt[s:e][:, None]
        cid, exists = neighbor_cells(table, table.hashes[s:e])
        cand = table.xyz[cid].reshape(b, 27 * cap, 3)
        cok = (exists[:, :, None]
               & (lane[None, None, :] < table.cnt[cid][:, :, None])
               ).reshape(b, 27 * cap)
        qokf = qok.to(torch.float32)
        center = ((qxyz * qokf[..., None]).sum(dim=1)
                  / torch.clamp(qokf.sum(dim=1), min=1.0)[:, None])
        q = (qxyz - center[:, None, :]) * qokf[..., None]
        c = torch.where(cok[..., None], cand - center[:, None, :], 0.0)
        q2 = (q * q).sum(dim=-1)
        c2 = (c * c).sum(dim=-1)
        d2 = q2[:, :, None] + c2[:, None, :] - 2.0 * torch.bmm(
            q, c.transpose(1, 2))
        w = (cok[:, None, :] & (d2 <= r2)).to(torch.float32)
        feats = torch.cat([c, _outer6(c), cok.to(torch.float32)[..., None]],
                          dim=-1)
        m = torch.bmm(w, feats).reshape(b * cap, 10)
        resident = qok.reshape(b * cap)
        tgt = torch.where(resident, table.idx[s:e].reshape(b * cap),
                          capacity)
        m_all[tgt] = m
        res_all[tgt] = resident
    m_p, valid_p = m_all[:capacity], res_all[:capacity]
    cnt = torch.clamp(m_p[:, 9], min=1.0)
    s1 = m_p[:, 0:3] / cnt[:, None]
    s2 = m_p[:, 3:9] / cnt[:, None]
    cov = _cov_from6(s2) - s1[:, :, None] * s1[:, None, :]
    return _features(cov, m_p[:, 9], valid_p & (m_p[:, 9] >= 3))


def _pca_query(table: CellTable, qxyz: torch.Tensor, qmask: torch.Tensor,
               radius: float, chunk: int = 1024) -> PCAFeatures:
    """Per-query PCA over the cell table, ``chunk`` queries a block (the
    spill fallback, and every point under ``cell_pair=False``)."""
    r2 = torch.tensor(radius * radius, dtype=torch.float32)
    covs, cnts = [], []
    for s in range(0, qxyz.shape[0], chunk):
        q = qxyz[s:s + chunk]
        cxyz, _, ok = cell_candidates(table, q, qmask[s:s + chunk])
        d = cxyz - q[:, None, :]
        w = (ok & ((d * d).sum(dim=-1) <= r2)).to(torch.float32)
        cnt = w.sum(dim=1)
        denom = torch.clamp(cnt, min=1.0)
        dw = d * w[..., None]
        s1 = dw.sum(dim=1) / denom[:, None]
        s2 = torch.einsum("bci,bcj->bij", dw, d) / denom[:, None, None]
        covs.append(s2 - s1[:, :, None] * s1[:, None, :])
        cnts.append(cnt)
    cnt = torch.cat(cnts)
    return _features(torch.cat(covs), cnt, qmask & (cnt >= 3))


def pca_features(cloud: PointCloud, radius: float, k: int = 128,
                 cell_cap: int = 64, chunk: int = 4096, max_cells: int = 0,
                 cell_pair: bool = True) -> PCAFeatures:
    """Per-point PCA features over a fixed-radius (cap-thinned)
    neighborhood.  The default path is the cell-pair sweep plus the
    per-query spill fallback; ``cell_pair=False`` runs the per-query path
    over every point, ``chunk`` queries a block.  Both read the same cell
    table (``cell_cap`` residents a cell, ``max_cells`` cells; 0: the
    capacity).  ``k`` is the JAX package's argument of the same name,
    which neither package's paths read."""
    if max_cells <= 0:
        max_cells = cloud.capacity
    table = build_cell_table(cloud, cell=radius, max_cells=max_cells,
                             cap=cell_cap)
    if not cell_pair:
        return _pca_query(table, cloud.xyz, cloud.mask, radius, chunk)
    n_cells = int((table.hashes != IMAX).sum())
    feats = _pca_cell_pair(table, radius, max(n_cells, 1), cloud.capacity)
    spill = cloud.mask & ~(feats.n_neighbors > 0)
    n_spill = int(spill.sum())
    if n_spill == 0:
        return feats
    cap_s = bucket_size(n_spill, min_size=256)
    sel = torch.sort((~spill).to(torch.int8), stable=True).indices[:cap_s]
    smask = spill[sel]
    sp = _pca_query(table, cloud.xyz[sel], smask, radius)

    def merge(base, upd):
        base = base.clone()
        m = smask.reshape(smask.shape + (1,) * (upd.ndim - 1))
        base[sel] = torch.where(m, upd, base[sel])
        return base

    return PCAFeatures(*(merge(b, u) for b, u in zip(feats, sp)))


def pca_features_pair(cloud_a: PointCloud, cloud_b: PointCloud,
                      radius: float, cell_cap: int = 64, max_cells: int = 0):
    """PCA features of both clouds of a pair."""
    return (pca_features(cloud_a, radius, cell_cap=cell_cap,
                         max_cells=max_cells),
            pca_features(cloud_b, radius, cell_cap=cell_cap,
                         max_cells=max_cells))


def neighborhood_covariance(xyz: torch.Tensor, nb: NeighborList):
    """(cov [N, 3, 3], mean [N, 3], count [N]): the plain covariance of
    each point's listed neighbors."""
    npts = xyz[nb.idx]                                  # [N, K, 3]
    w = nb.valid.to(torch.float32)
    cnt = w.sum(dim=1)
    denom = torch.clamp(cnt, min=1.0)
    mean = (npts * w[..., None]).sum(dim=1) / denom[:, None]
    dm = npts - mean[:, None, :]
    cov = torch.einsum("nki,nkj->nij", dm * w[..., None], dm)
    return cov / denom[:, None, None], mean, cnt


def pca_from_neighbors(cloud: PointCloud, nb: NeighborList) -> PCAFeatures:
    """PCA features from a neighbor list, solved by the Jacobi
    :func:`~ghicp_tpu_torch.ops.eigh3.eigh3` (the JAX package's solver and
    eigenvector signs, which the FPFH angles depend on)."""
    cov, _, cnt = neighborhood_covariance(cloud.xyz, nb)
    vals, vecs = eigh3(cov)
    vals = torch.clamp(vals, min=0.0)
    total = vals.sum(dim=-1)
    curvature = torch.where(total > 0, vals[:, 2] / torch.clamp(total,
                                                              min=1e-30), 0.0)
    return PCAFeatures(eigvals=vals, principal=vecs[:, :, 0],
                       normal=vecs[:, :, 2], curvature=curvature,
                       n_neighbors=cnt.to(torch.int64),
                       valid=cloud.mask & (cnt >= 3))
