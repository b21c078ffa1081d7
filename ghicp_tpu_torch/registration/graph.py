"""Multi-pair (station-graph) registration, with every feature and matching.

The port of the JAX package's ``registration/graph.py``:

* every station cloud is preprocessed and its features computed once
  (:class:`Station`, :func:`build_station`): BSC with the full variant set
  so it can act as source or target of any pair, FPFH histograms over the
  downsampled cloud gathered at the keypoints, RoPS moments at the
  keypoints, or none; keypoints are padded to one capacity shared by all
  stations;
* each requested pair runs the GH-ICP engine on the cached keypoints and
  the pair's feature matrix (:func:`station_pair_fd`: Hamming distances,
  similarities or zeros), after a RANSAC coarse pose
  (:func:`_coarse_init_pair`; none for feature "none"):
  sequentially through :func:`ghicp_register` on the kernel lane, or all
  pairs at once through :func:`ghicp_register_batched` (the XLA lane, its
  auction bidding through kernel K6);
* global station poses come from a maximum spanning tree over pair quality
  (the final IoU of each registration), chaining pairwise transforms from
  station 0.

Neither mode runs a final one-to-one matching, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ghicp_tpu_torch.core import transform as tf
from ghicp_tpu_torch.core.config import FeatureType, GHICPConfig
from ghicp_tpu_torch.core.device import resolve_device
from ghicp_tpu_torch.core.types import (PointCloud, cloud_bounds,
                                        compact_device)
from ghicp_tpu_torch.features.bsc import extract_bsc
from ghicp_tpu_torch.features.fpfh import (fpfh_features,
                                           fpfh_similarity_matrix)
from ghicp_tpu_torch.features.hamming import min_hamming_fd
from ghicp_tpu_torch.features.rops import (rops_features,
                                           rops_similarity_matrix)
from ghicp_tpu_torch.matching.ransac import ransac_coarse_align
from ghicp_tpu_torch.preprocess.keypoints import (compact_candidates,
                                                  detect_keypoints,
                                                  refine_positions)
from ghicp_tpu_torch.preprocess.pca import pca_features
from ghicp_tpu_torch.preprocess.voxel import voxel_downsample
from ghicp_tpu_torch.registration.ghicp import (MULT_FEATURES, GHICPResult,
                                                IterationMetrics,
                                                ghicp_register,
                                                ghicp_register_batched)
from ghicp_tpu_torch.registration.pipeline import _keypoint_arrays


@dataclasses.dataclass
class Station:
    """One preprocessed scan: keypoints and their features."""

    index: int
    kp_xyz: torch.Tensor        # [cap, 3]
    kp_mask: torch.Tensor       # [cap]
    bsc_packed: Optional[torch.Tensor]  # [V, cap, W] (BSC only)
    n_keypoints: int
    bbx_magnitude: float
    desc: Optional[torch.Tensor] = None    # [cap, D] FPFH histograms or
                                           # RoPS moments
    frames: Optional[torch.Tensor] = None  # [cap, 3, 3] BSC local frames
                                           # (RANSAC pose hypotheses)


@dataclasses.dataclass
class PairResult:
    source: int
    target: int
    transform: np.ndarray       # [4, 4] source -> target
    result: GHICPResult

    @property
    def quality(self) -> float:
        """Final IoU: the spanning tree's edge weight."""
        it = max(int(self.result.iterations) - 1, 0)
        return float(self.result.metrics.iou[it])


def build_station(pts: np.ndarray, index: int, config: GHICPConfig,
                  capacity: int, device=None) -> Station:
    """Voxel downsample, PCA, curvature keypoints with exact NMS, refined
    positions and the features of ``config.feature`` of one station cloud:
    BSC (all variants, with its local frames), FPFH (over the downsampled
    cloud with k = max(fpfh_k, 24), gathered at the keypoints), RoPS (at
    the keypoints) or none."""
    dev = resolve_device(device)
    cloud = PointCloud.from_points(pts, device=dev)
    dcloud = compact_device(voxel_downsample(cloud, config.voxel_size))
    bbx = float(cloud_bounds(dcloud).magnitude)
    pca = pca_features(dcloud, radius=config.neighborhood_radius,
                       cell_cap=config.pca_cell_cap,
                       max_cells=config.pca_max_cells)
    res = detect_keypoints(dcloud, config, pca)
    kp_idx, kp_mask, nk = _keypoint_arrays(res.mask.cpu().numpy(), capacity,
                                           dev)
    kp_xyz = dcloud.xyz[kp_idx]
    if config.refine_keypoints:
        rr = config.refine_radius or 3.0 * config.voxel_size
        cc, curv = compact_candidates(dcloud, pca, res.candidates)
        kp_xyz = refine_positions(kp_xyz, kp_mask, cc, curv, radius=rr)
    packed = desc = frames = None
    if config.feature == FeatureType.BSC:
        feats = extract_bsc(dcloud, kp_xyz, kp_mask, config,
                            num_variants=config.bsc_num_variants)
        packed, frames = feats.packed, feats.frames
    elif config.feature == FeatureType.FPFH:
        radius = config.fpfh_radius or 3.0 * config.voxel_size
        desc = fpfh_features(dcloud, radius, max(config.fpfh_k, 24))[0][
            kp_idx]
    elif config.feature == FeatureType.ROPS:
        desc = rops_features(
            dcloud, kp_xyz, kp_mask,
            radius=config.rops_radius or float(config.non_max_radius),
            neighbor_k=config.rops_neighbor_k,
            n_rotations=config.rops_rotations, n_bins=config.rops_bins).desc
    return Station(index=index, kp_xyz=kp_xyz, kp_mask=kp_mask,
                   bsc_packed=packed, n_keypoints=nk, bbx_magnitude=bbx,
                   desc=desc, frames=frames)


def station_pair_fd(s: Station, t: Station, config: GHICPConfig):
    """The [cap, cap] feature matrix of a station pair: the min-Hamming
    distance for BSC (the target side uses its variant 0 only), the
    similarity for FPFH / RoPS, zeros for none."""
    if config.feature == FeatureType.BSC:
        return min_hamming_fd(s.bsc_packed, t.bsc_packed[:1],
                              config.bsc_total_bits)
    if config.feature == FeatureType.FPFH:
        return fpfh_similarity_matrix(s.desc, t.desc)
    if config.feature == FeatureType.ROPS:
        return rops_similarity_matrix(s.desc, t.desc)
    cap = s.kp_xyz.shape[0]
    return torch.zeros((cap, cap), dtype=torch.float32,
                       device=s.kp_xyz.device)


def _coarse_init_pair(s: Station, t: Station, fd, config: GHICPConfig):
    """RANSAC coarse pose for a station pair: (T0 or None, it_shift); no
    RANSAC for feature "none", a similarity turned into a distance
    (1 - FD) for FPFH / RoPS."""
    if config.coarse_init != "ransac" or config.feature == FeatureType.NONE:
        return None, 0.0
    fd_dist = 1.0 - fd if config.feature in MULT_FEATURES else fd
    tau = config.ransac_tau or 3.0 * config.voxel_size
    rr = ransac_coarse_align(s.kp_xyz, s.kp_mask, t.kp_xyz, t.kp_mask,
                             fd_dist, tau=tau,
                             n_hyp=config.ransac_hypotheses,
                             frames_s=s.frames, frames_t=t.frames)
    if rr.inliers >= config.ransac_min_inliers:
        # skip the feature-dominant schedule phase (W_FD from e^-3)
        return rr.transform, 3.0 * config.weight_changing_rate
    return None, 0.0


def _pair_result(res: GHICPResult, k: int) -> GHICPResult:
    """Pair ``k`` of a batched result, as a single-pair result."""
    return GHICPResult(
        transform=res.transform[k], iterations=int(res.iterations[k]),
        converged=bool(res.converged[k]), success=bool(res.success[k]),
        final_rmse=float(res.final_rmse[k]),
        metrics=IterationMetrics(*(x[k] for x in res.metrics)),
        matches=res.matches[k])


def register_graph(clouds: Sequence[np.ndarray],
                   pairs: Sequence[Tuple[int, int]], config: GHICPConfig,
                   keypoint_capacity: Optional[int] = None,
                   batched: bool = False, device=None
                   ) -> Tuple[List[PairResult], List[np.ndarray]]:
    """Register every (source, target) pair; return the pair results and
    the global poses (one [4, 4] a station, station 0 the root).

    ``batched=True`` stacks all pairs on a leading axis and runs one
    engine over them (:func:`ghicp_register_batched`); pairs whose RANSAC
    found no consensus start from the identity with the shared schedule
    offset."""
    dev = resolve_device(device)
    cap = keypoint_capacity or config.keypoint_capacity or 2048
    stations = [build_station(p, i, config, cap, dev)
                for i, p in enumerate(clouds)]
    results: List[PairResult] = []
    if batched:
        st_s = [stations[si] for si, _ in pairs]
        st_t = [stations[ti] for _, ti in pairs]
        fds = [station_pair_fd(s, t, config) for s, t in zip(st_s, st_t)]
        inits = [_coarse_init_pair(s, t, f, config)
                 for s, t, f in zip(st_s, st_t, fds)]
        fd = torch.stack(fds)
        del fds
        T0b, shift = None, 0.0
        if any(T0 is not None for T0, _ in inits):
            shift = max(sh for _, sh in inits)
            T0b = torch.stack([T0 if T0 is not None else tf.identity(dev)
                               for T0, _ in inits])
        with torch.profiler.record_function("graph.engine"):
            res = ghicp_register_batched(
                torch.stack([s.kp_xyz for s in st_s]),
                torch.stack([s.kp_mask for s in st_s]),
                torch.stack([t.kp_xyz for t in st_t]),
                torch.stack([t.kp_mask for t in st_t]), fd,
                [s.bbx_magnitude for s in st_s], config,
                init_transform=T0b, it_shift=shift, device=dev)
        for k, (si, ti) in enumerate(pairs):
            rk = _pair_result(res, k)
            results.append(PairResult(source=si, target=ti,
                                      transform=rk.transform.cpu().numpy(),
                                      result=rk))
    else:
        for si, ti in pairs:
            s, t = stations[si], stations[ti]
            fd = station_pair_fd(s, t, config)
            T0, it_shift = _coarse_init_pair(s, t, fd, config)
            res = ghicp_register(s.kp_xyz, s.kp_mask, t.kp_xyz, t.kp_mask,
                                 fd, s.bbx_magnitude, config,
                                 init_transform=T0, it_shift=it_shift,
                                 device=dev)
            results.append(PairResult(source=si, target=ti,
                                      transform=res.transform.cpu().numpy(),
                                      result=res))
    return results, _poses_from_mst(len(clouds), results)


def _poses_from_mst(n: int, results: List[PairResult]) -> List[np.ndarray]:
    """Chain pairwise transforms along a maximum-quality spanning tree
    (Prim's algorithm from station 0).  Pose i maps station i's frame into
    station 0's; a station the tree does not reach keeps the identity."""
    edges: Dict[int, List[Tuple[float, int, np.ndarray]]] = {
        i: [] for i in range(n)}
    for r in results:
        T = r.transform                 # maps source -> target
        edges[r.source].append((r.quality, r.target, np.linalg.inv(T)))
        edges[r.target].append((r.quality, r.source, T))
    poses: List[Optional[np.ndarray]] = [None] * n
    poses[0] = np.eye(4, dtype=np.float32)
    visited = {0}
    heap = [(-q, 0, nbr, T) for (q, nbr, T) in edges[0]]
    heapq.heapify(heap)
    while heap and len(visited) < n:
        _, frm, to, T_to_frm = heapq.heappop(heap)
        if to in visited:
            continue
        # T_to_frm maps the `to` frame into the `frm` frame
        poses[to] = (poses[frm] @ T_to_frm).astype(np.float32)
        visited.add(to)
        for (q, nbr, T) in edges[to]:
            if nbr not in visited:
                heapq.heappush(heap, (-q, to, nbr, T))
    return [np.eye(4, dtype=np.float32) if p is None else p for p in poses]
