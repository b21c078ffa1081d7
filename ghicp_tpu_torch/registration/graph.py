"""Multi-pair (station-graph) registration, BSC + KM.

The port of the JAX package's ``registration/graph.py``:

* every station cloud is preprocessed and BSC-encoded once
  (:class:`Station`, :func:`build_station`), with the full variant set so
  it can act as source or target of any pair; keypoints are padded to one
  capacity shared by all stations;
* each requested pair runs the GH-ICP engine on the cached keypoints and
  features, after a RANSAC coarse pose (:func:`_coarse_init_pair`):
  sequentially through :func:`ghicp_register` on the kernel lane, or all
  pairs at once through :func:`ghicp_register_batched` (the XLA lane, its
  auction bidding through kernel K6);
* global station poses come from a maximum spanning tree over pair quality
  (the final IoU of each registration), chaining pairwise transforms from
  station 0.

Neither mode runs a final one-to-one matching, as in the JAX package.
FPFH and RoPS stations are not ported yet.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ghicp_tpu_torch.core import transform as tf
from ghicp_tpu_torch.core.config import (CorrespondenceType, FeatureType,
                                         GHICPConfig)
from ghicp_tpu_torch.core.device import resolve_device
from ghicp_tpu_torch.core.types import (PointCloud, cloud_bounds,
                                        compact_device)
from ghicp_tpu_torch.features.bsc import extract_bsc
from ghicp_tpu_torch.features.hamming import min_hamming_fd
from ghicp_tpu_torch.matching.ransac import ransac_coarse_align
from ghicp_tpu_torch.preprocess.keypoints import (compact_candidates,
                                                  detect_keypoints,
                                                  refine_positions)
from ghicp_tpu_torch.preprocess.pca import pca_features
from ghicp_tpu_torch.preprocess.voxel import voxel_downsample
from ghicp_tpu_torch.registration.ghicp import (GHICPResult,
                                                IterationMetrics,
                                                ghicp_register,
                                                ghicp_register_batched)
from ghicp_tpu_torch.registration.pipeline import _keypoint_arrays


@dataclasses.dataclass
class Station:
    """One preprocessed scan: keypoints and their BSC features."""

    index: int
    kp_xyz: torch.Tensor        # [cap, 3]
    kp_mask: torch.Tensor       # [cap]
    bsc_packed: torch.Tensor    # [V, cap, W]
    n_keypoints: int
    bbx_magnitude: float
    frames: torch.Tensor        # [cap, 3, 3] BSC local frames


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


def _check_supported(config: GHICPConfig) -> None:
    if (config.feature != FeatureType.BSC
            or config.correspondence != CorrespondenceType.KM):
        raise NotImplementedError(
            "the port's station graphs run BSC + KM only (FPFH and RoPS "
            "stations are not ported yet)")


def build_station(pts: np.ndarray, index: int, config: GHICPConfig,
                  capacity: int, device=None) -> Station:
    """Voxel downsample, PCA, curvature keypoints with exact NMS, refined
    positions and BSC features (all variants) of one station cloud."""
    _check_supported(config)
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
    feats = extract_bsc(dcloud, kp_xyz, kp_mask, config,
                        num_variants=config.bsc_num_variants)
    return Station(index=index, kp_xyz=kp_xyz, kp_mask=kp_mask,
                   bsc_packed=feats.packed, n_keypoints=nk,
                   bbx_magnitude=bbx, frames=feats.frames)


def station_pair_fd(s: Station, t: Station, config: GHICPConfig):
    """The [cap, cap] min-Hamming feature distance of a station pair (the
    target side uses its variant 0 only)."""
    return min_hamming_fd(s.bsc_packed, t.bsc_packed[:1],
                          config.bsc_total_bits)


def _coarse_init_pair(s: Station, t: Station, fd, config: GHICPConfig):
    """RANSAC coarse pose for a station pair: (T0 or None, it_shift)."""
    if config.coarse_init != "ransac":
        return None, 0.0
    tau = config.ransac_tau or 3.0 * config.voxel_size
    rr = ransac_coarse_align(s.kp_xyz, s.kp_mask, t.kp_xyz, t.kp_mask, fd,
                             tau=tau, n_hyp=config.ransac_hypotheses,
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
    _check_supported(config)
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
