"""Curvature keypoints: stability pruning, non-max suppression, sub-voxel
refinement.

* ``prune_unstable`` keeps points with l2/l1 < t, l3/l2 < t and more than
  ``min_neighbors`` neighbors.
* ``non_max_suppression`` is the parallel fixed point of greedy
  suppression by curvature: each round every alive candidate that beats
  (curvature desc, index asc) every alive candidate within the radius is
  selected and suppresses its neighbors.  Up to 8192 candidates the exact
  O(N^2) fixed point runs; above, the K-capped neighbor-list (gather) path.
  (The JAX package routes (8192, 131072] to its ``nms_pallas`` kernel;
  that band takes the gather path here until the kernel is ported.)
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ghicp_tpu_torch.core.config import GHICPConfig
from ghicp_tpu_torch.core.types import (PointCloud, bucket_size,
                                        stable_live_first)
from ghicp_tpu_torch.preprocess.neighbors import radius_neighbors
from ghicp_tpu_torch.preprocess.pca import PCAFeatures, pca_features

NMS_BRUTE_MAX_N = 8192
_NEG = -3.0e38
_BIG = 2**30


class KeypointResult(NamedTuple):
    mask: torch.Tensor        # [N] selected keypoints
    candidates: torch.Tensor  # [N] survived stability pruning
    rounds: int


def prune_unstable(feats: PCAFeatures, ratio_max: float,
                   min_neighbors: int) -> torch.Tensor:
    l1 = torch.clamp(feats.eigvals[:, 0], min=1e-30)
    l2 = torch.clamp(feats.eigvals[:, 1], min=1e-30)
    ratio1 = feats.eigvals[:, 1] / l1
    ratio2 = feats.eigvals[:, 2] / l2
    return (feats.valid & (ratio1 < ratio_max) & (ratio2 < ratio_max)
            & (feats.n_neighbors > min_neighbors))


def nms_bruteforce(xyz, curv, cand, radius: float, max_rounds: int = 128):
    """Exact-radius fixed point over all pairs (small candidate sets)."""
    N = curv.shape[0]
    idx = torch.arange(N, device=xyz.device)
    d2 = ((xyz[:, None, :] - xyz[None, :, :]) ** 2).sum(dim=-1)
    r2 = torch.tensor(radius, dtype=torch.float32) ** 2
    within = (d2 <= r2) & (idx[:, None] != idx[None, :])
    del d2
    alive, sel, rounds = cand.clone(), torch.zeros_like(cand), 0
    while rounds < max_rounds and bool(alive.any()):
        m = within & alive[None, :]
        cj = torch.where(m, curv[None, :], _NEG)
        maxc = cj.amax(dim=1)
        idmin = torch.where(m & (cj == maxc[:, None]), idx[None, :],
                            _BIG).amin(dim=1)
        wins = alive & ((curv > maxc) | ((curv == maxc) & (idx < idmin)))
        sel = sel | wins
        supp = (within & wins[None, :]).any(dim=1)
        alive = alive & ~wins & ~supp
        rounds += 1
    return sel, rounds


def non_max_suppression(cloud: PointCloud, curvature, candidates,
                        radius: float, k: int = 96, cell_cap: int = 32,
                        chunk: int = 4096, max_rounds: int = 128):
    """Parallel greedy-equivalent NMS.  Returns (selected mask, rounds)."""
    n = cloud.capacity
    if n <= NMS_BRUTE_MAX_N:
        return nms_bruteforce(cloud.xyz, curvature, candidates & cloud.mask,
                              radius, max_rounds)
    cand_cloud = PointCloud(xyz=cloud.xyz, mask=candidates)
    nb = radius_neighbors(cand_cloud, cand_cloud, radius=radius, k=k,
                          cell_cap=cell_cap, chunk=chunk, include_self=False)
    idxf = torch.arange(n, device=curvature.device, dtype=torch.float32)
    nb_curv_all = torch.where(nb.valid, curvature[nb.idx], -torch.inf)
    nb_idxf_all = torch.where(nb.valid, idxf[nb.idx], torch.inf)
    alive, selected, rounds = candidates.clone(), torch.zeros_like(
        candidates), 0
    while rounds < max_rounds and bool(alive.any()):
        nb_alive = alive[nb.idx] & nb.valid
        nb_curv = torch.where(nb_alive, nb_curv_all, -torch.inf)
        nb_idxf = torch.where(nb_alive, nb_idxf_all, torch.inf)
        max_curv = nb_curv.amax(dim=1)
        at_max = nb_alive & (nb_curv == max_curv[:, None])
        min_idx = torch.where(at_max, nb_idxf, torch.inf).amin(dim=1)
        wins = alive & ((curvature > max_curv)
                        | ((curvature == max_curv) & (idxf < min_idx)))
        selected = selected | wins
        suppressed = (wins[nb.idx] & nb.valid).any(dim=1)
        alive = alive & ~wins & ~suppressed
        rounds += 1
    return selected, rounds


def refine_positions(kp_xyz, kp_mask, cand_cloud: PointCloud,
                     cand_curvature, radius: float, k: int = 48,
                     cell_cap: int = 32, chunk: int = 2048):
    """Curvature-weighted mean shift of each keypoint over the surviving
    candidates within ``radius`` (sub-voxel localization)."""
    query = PointCloud(xyz=kp_xyz, mask=kp_mask)
    nb = radius_neighbors(query, cand_cloud, radius=radius, k=k,
                          cell_cap=cell_cap, chunk=min(chunk,
                                                       kp_xyz.shape[0]))
    w = torch.where(nb.valid, torch.clamp(cand_curvature[nb.idx], min=0.0),
                    0.0)
    wsum = torch.clamp(w.sum(dim=1), min=1e-12)
    centroid = torch.einsum("nk,nkd->nd", w,
                            cand_cloud.xyz[nb.idx]) / wsum[:, None]
    ok = kp_mask & (nb.valid.sum(dim=1) > 0)
    return torch.where(ok[:, None], centroid, kp_xyz)


def detect_keypoints(cloud: PointCloud, config: GHICPConfig,
                     feats: PCAFeatures | None = None) -> KeypointResult:
    """PCA -> stability pruning -> NMS over the compacted candidates."""
    if feats is None:
        feats = pca_features(cloud, radius=config.neighborhood_radius,
                             cell_cap=config.pca_cell_cap,
                             max_cells=config.pca_max_cells)
    candidates = prune_unstable(feats, config.unstable_ratio_threshold,
                                config.min_neighbors)
    if config.min_curvature > 0.0:
        candidates = candidates & (feats.curvature >= config.min_curvature)
    n = cloud.capacity
    count = int(candidates.sum())
    if count == 0:
        return KeypointResult(mask=torch.zeros_like(candidates),
                              candidates=candidates, rounds=0)
    cap = bucket_size(count, min_size=256)
    sel = stable_live_first(candidates)[:cap]
    cmask = candidates[sel]
    compact = PointCloud(xyz=cloud.xyz[sel], mask=cmask)
    sel_c, rounds = non_max_suppression(
        compact, feats.curvature[sel], cmask, radius=config.non_max_radius,
        k=config.nms_k, cell_cap=config.nms_cell_cap, chunk=min(1024, cap))
    mask = torch.zeros((n,), dtype=torch.bool, device=cloud.xyz.device)
    mask[sel] = sel_c & cmask
    return KeypointResult(mask=mask, candidates=candidates, rounds=rounds)


def compact_candidates(cloud: PointCloud, feats: PCAFeatures, candidates):
    """Compacted pruning survivors and their curvature (for refinement)."""
    count = int(candidates.sum())
    cap = bucket_size(max(count, 1), min_size=256)
    sel = stable_live_first(candidates)[:cap]
    cmask = candidates[sel]
    return (PointCloud(xyz=cloud.xyz[sel], mask=cmask),
            torch.where(cmask, feats.curvature[sel], 0.0))
