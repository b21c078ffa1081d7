"""Curvature keypoints: stability pruning, non-max suppression, sub-voxel
refinement.

* ``prune_unstable`` keeps points with l2/l1 < t, l3/l2 < t and more than
  ``min_neighbors`` neighbors.
* ``refine_positions`` (centroid) and ``refine_positions_corner``
  (tangent-plane intersection) move a keypoint below the voxel size;
  ``adaptive_detect`` re-tunes the stability ratio until the keypoint
  count lands in [keypoints_min, keypoints_max].
* ``non_max_suppression`` is the parallel fixed point of greedy
  suppression by curvature: each round every alive candidate that beats
  (curvature desc, index asc) every alive candidate within the radius is
  selected and suppresses its neighbors.  The dispatch is the JAX
  package's: up to 8192 slots the exact O(N^2) fixed point; in (8192,
  131072] (256-aligned) the exact-radius fixed point of kernel K4
  (:func:`ghicp_tpu_torch.ops.nms_kernel.nms_exact`); above, the K-capped
  neighbor-list (gather) path.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ghicp_tpu_torch.core.config import GHICPConfig
from ghicp_tpu_torch.core.types import (PointCloud, bucket_size,
                                        stable_live_first)
from ghicp_tpu_torch.ops.nms_kernel import TS as NMS_TILE
from ghicp_tpu_torch.ops.nms_kernel import nms_exact
from ghicp_tpu_torch.preprocess.neighbors import radius_neighbors
from ghicp_tpu_torch.preprocess.pca import PCAFeatures, pca_features

NMS_BRUTE_MAX_N = 8192
NMS_KERNEL_MAX_N = 131072
_NEG = -3.0e38
_BIG = 2**30


class KeypointResult(NamedTuple):
    mask: torch.Tensor        # [N] selected keypoints
    candidates: torch.Tensor  # [N] survived stability pruning
    rounds: int
    bucket: int = 0           # slots of the compacted candidate bucket
    path: str = ""            # NMS path it took (:func:`nms_path`)


def nms_path(n: int) -> str:
    """The NMS path for ``n`` slots: "brute", "kernel" (K4) or "gather"."""
    if n <= NMS_BRUTE_MAX_N:
        return "brute"
    if n % NMS_TILE == 0 and n <= NMS_KERNEL_MAX_N:
        return "kernel"
    return "gather"


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
    path = nms_path(n)
    if path == "brute":
        return nms_bruteforce(cloud.xyz, curvature, candidates & cloud.mask,
                              radius, max_rounds)
    if path == "kernel":
        return nms_exact(cloud.xyz, curvature, candidates & cloud.mask,
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


CORNER_CHUNK = 2048   # keypoints a corner solve batch (3x3 solves, float32)


def refine_positions_corner(kp_xyz, kp_mask, cloud: PointCloud,
                            feats: PCAFeatures, radius: float, k: int = 96,
                            cell_cap: int = 32, chunk: int = 2048,
                            anchor: float = 0.05):
    """Plane-intersection keypoint localization: x* = argmin_x sum_i w_i
    (n_i^T (x - p_i))^2 + lam |x - kp|^2 over the surface neighbours p_i
    within ``radius`` with PCA normals n_i (the least-squares intersection
    of the local tangent planes: a 3-plane corner's vertex; on a crease
    the anchor pins the along-edge direction, on a flat surface the
    keypoint).  Weights: planarity (l2 - l3) / l1, divided by the weight
    pointing the same way ((n_i . n_j)^8), so each plane direction counts
    about once; three re-anchored solves x <- (A + lam I)^-1 (b + lam x)
    in float32, batched CORNER_CHUNK keypoints at a time; a keypoint never
    leaves its query ball.  Normals enter squared, so their signs do not
    matter."""
    query = PointCloud(xyz=kp_xyz, mask=kp_mask)
    nb = radius_neighbors(query, cloud, radius=radius, k=k,
                          cell_cap=cell_cap,
                          chunk=min(chunk, kp_xyz.shape[0]))
    out = []
    eye = torch.eye(3, dtype=torch.float32, device=kp_xyz.device)
    for s in range(0, kp_xyz.shape[0], CORNER_CHUNK):
        sl = slice(s, s + CORNER_CHUNK)
        idx, valid, kp = nb.idx[sl], nb.valid[sl], kp_xyz[sl]
        n = feats.normal[idx]                           # [s, K, 3]
        p = cloud.xyz[idx]
        ev = feats.eigvals[idx]
        planarity = (ev[..., 1] - ev[..., 2]) / torch.clamp(ev[..., 0],
                                                            min=1e-30)
        w = torch.where(valid & feats.valid[idx],
                        torch.clamp(planarity, 0.0, 1.0), 0.0)
        sim = torch.einsum("ski,sli->skl", n, n) ** 2   # [s, K, K]
        dens = torch.einsum("skl,sl->sk", sim ** 4, w)
        del sim
        w = w / torch.clamp(dens, min=1e-6)
        A = torch.einsum("sk,ski,skj->sij", w, n, n)
        ndp = (n * p).sum(dim=-1)
        b = torch.einsum("sk,sk,ski->si", w, ndp, n)
        lam = anchor * torch.clamp(A.diagonal(dim1=-2, dim2=-1).sum(-1),
                                   min=1e-6)[:, None]
        A = A + lam[..., None] * eye
        x = kp
        for _ in range(3):
            x = torch.linalg.solve(A, b + lam * x)
        d = x - kp
        dist = torch.linalg.norm(d, dim=-1, keepdim=True)
        x = kp + d * torch.clamp(radius / torch.clamp(dist, min=1e-12),
                                 max=1.0)
        ok = kp_mask[sl] & (w.sum(dim=1) > 1e-6)
        out.append(torch.where(ok[:, None], x, kp))
    return torch.cat(out)


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
    return KeypointResult(mask=mask, candidates=candidates, rounds=rounds,
                          bucket=cap, path=nms_path(cap))


def compact_candidates(cloud: PointCloud, feats: PCAFeatures, candidates):
    """Compacted pruning survivors and their curvature (for refinement)."""
    count = int(candidates.sum())
    cap = bucket_size(max(count, 1), min_size=256)
    sel = stable_live_first(candidates)[:cap]
    cmask = candidates[sel]
    return (PointCloud(xyz=cloud.xyz[sel], mask=cmask),
            torch.where(cmask, feats.curvature[sel], 0.0))


def adaptive_detect(cloud: PointCloud, config: GHICPConfig) -> KeypointResult:
    """Adaptive threshold re-tuning (the reference's
    keypointDetectionBasedOnCurvature_adaptive, keypoint_detect.hpp:53-111,
    a host loop): above ``keypoints_max`` keypoints the stability ratio
    drops by 0.05 and prune + NMS (over the whole cloud) run again, until
    the count lands in [keypoints_min, keypoints_max], a count below the
    band raises the ratio once by 0.025 and stops, or the ratio falls
    under 0.65."""
    feats = pca_features(cloud, radius=config.neighborhood_radius,
                         cell_cap=config.pca_cell_cap,
                         max_cells=config.pca_max_cells)
    ratio = config.unstable_ratio_threshold
    result = detect_keypoints(cloud, config, feats)
    count = int(result.mask.sum())
    if count <= config.keypoints_max:
        return result
    finish = False
    while ((count < config.keypoints_min or count > config.keypoints_max)
           and not finish and ratio >= 0.65):
        if count < config.keypoints_min:
            ratio += 0.025
            finish = True
        else:
            ratio -= 0.05
        candidates = prune_unstable(feats, ratio, config.min_neighbors)
        selected, rounds = non_max_suppression(
            cloud, feats.curvature, candidates,
            radius=config.non_max_radius, k=config.nms_k,
            cell_cap=config.nms_cell_cap, chunk=1024)
        result = KeypointResult(mask=selected, candidates=candidates,
                                rounds=rounds, bucket=cloud.capacity,
                                path=nms_path(cloud.capacity))
        count = int(selected.sum())
    return result
