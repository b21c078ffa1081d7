"""End-to-end pair registration: voxel downsample -> curvature keypoints
(+ sub-voxel refinement) -> features -> FD -> RANSAC coarse pose -> GH-ICP
engine -> one-to-one final matching.

Between stages the padded clouds are compacted into power-of-two buckets.
KM (auction), NN or reciprocal-NN matching with one of four features: BSC
(FD the Hamming distance), FPFH (histograms over the whole downsampled
cloud, FD their |Pearson| similarity), RoPS (descriptors at the keypoints,
FD the similarity of the whitened descriptors) or none (classic ICP on the
distances alone: a zero FD); on two lanes: the dense lane builds the
[cap, cap] FD matrix; the streaming lane (``streaming_cost`` "on", or
"auto" above ``streaming_threshold`` keypoints) keeps the packed bits or
the standardized descriptor rows as factors (for none: no factors at all)
and never builds an [S, T] tensor.  RANSAC draws its candidates from the
features (1 - FD for a similarity); only BSC gives it local frames;
feature none has no coarse init (start it with ``initial_transform``).
The options the port does not carry yet raise ``NotImplementedError``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from ghicp_tpu_torch.core.config import FeatureType, GHICPConfig
from ghicp_tpu_torch.core.device import resolve_device
from ghicp_tpu_torch.core.types import (PointCloud, bucket_size,
                                        cloud_bounds, compact_device)
from ghicp_tpu_torch.features.bsc import extract_bsc
from ghicp_tpu_torch.features.fpfh import (fpfh_features,
                                           fpfh_similarity_matrix)
from ghicp_tpu_torch.features.hamming import min_hamming_fd
from ghicp_tpu_torch.features.rops import (rops_features,
                                           rops_similarity_matrix)
from ghicp_tpu_torch.matching.ransac import ransac_coarse_align
from ghicp_tpu_torch.ops.stream_kernel import (NoFeatures,
                                               make_desc_features,
                                               make_stream_features,
                                               stream_feature_candidates,
                                               subset_rows)
from ghicp_tpu_torch.preprocess.keypoints import (compact_candidates,
                                                  detect_keypoints,
                                                  refine_positions)
from ghicp_tpu_torch.preprocess.pca import pca_features_pair
from ghicp_tpu_torch.preprocess.voxel import voxel_downsample
from ghicp_tpu_torch.registration.ghicp import (MULT_FEATURES, GHICPResult,
                                                ghicp_register_chunked)


@dataclasses.dataclass
class RegistrationOutput:
    transform: np.ndarray          # [4, 4] source -> target
    result: GHICPResult
    n_source_down: int
    n_target_down: int
    n_source_keypoints: int
    n_target_keypoints: int
    timings: Dict[str, float]
    # refined keypoints (valid rows, input frames); source rows in the
    # engine's Morton row order, so result.matches indexes them directly
    keypoints_source: Optional[np.ndarray] = None
    keypoints_target: Optional[np.ndarray] = None
    # per cloud: candidate bucket, NMS path and rounds of the keypoint stage
    nms: Optional[tuple] = None
    streaming: bool = False        # the engine ran the streaming lane

    @property
    def success(self) -> bool:
        return bool(self.result.success)

    @property
    def final_rmse(self) -> float:
        return float(self.result.final_rmse)


def _keypoint_arrays(mask: np.ndarray, capacity: int, device):
    """(indices [capacity], mask [capacity], count) of the set mask bits."""
    idx = np.nonzero(mask)[0]
    n = len(idx)
    out = np.zeros(capacity, np.int64)
    out[:min(n, capacity)] = idx[:capacity]
    m = np.zeros(capacity, bool)
    m[:min(n, capacity)] = True
    return (torch.as_tensor(out, device=device),
            torch.as_tensor(m, device=device), n)


def _spread3(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of ``v`` so consecutive bits are 3 apart."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _morton_order_rows(xyz: torch.Tensor, mask: torch.Tensor):
    """Spatial (Morton) order of keypoint rows, masked rows last: rows that
    contest the same targets land in the same auction tile."""
    mn = torch.where(mask[:, None], xyz, 3e38).amin(dim=0)
    mx = torch.where(mask[:, None], xyz, -3e38).amax(dim=0)
    q = torch.clamp((mx - mn).amax(), min=1e-6) / 1023.0
    ig = torch.clamp((xyz - mn[None, :]) / q, 0.0, 1023.0).to(torch.int64)
    code = (_spread3(ig[:, 0]) | (_spread3(ig[:, 1]) << 1)
            | (_spread3(ig[:, 2]) << 2))
    code = torch.where(mask, code, 2**31 - 1)
    return torch.sort(code, stable=True).indices


def _check_supported(config: GHICPConfig) -> None:
    if config.adaptive_keypoints:
        raise NotImplementedError("adaptive_keypoints is not ported yet")
    if config.identity_hypotheses > 1:
        raise NotImplementedError("identity_hypotheses > 1 is not ported yet")
    if config.refine_keypoints and config.refine_method != "centroid":
        raise NotImplementedError("only refine_method='centroid' is ported")
    if config.bsc_offsets > 1:
        raise NotImplementedError("bsc_offsets > 1 is not ported yet")


@contextlib.contextmanager
def _stage(name: str, timings: Dict[str, float], dev: torch.device):
    """Time one pipeline stage (device work included) under a profiler
    label ``pipeline.<name>``."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(f"pipeline.{name}"):
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    timings[name] = time.perf_counter() - t0


def register_pair(source_pts: np.ndarray, target_pts: np.ndarray,
                  config: GHICPConfig,
                  keypoint_capacity: Optional[int] = None,
                  initial_transform: Optional[np.ndarray] = None,
                  iteration_callback=None, device=None) -> RegistrationOutput:
    """Register ``source`` onto ``target`` (raw [n, 3] arrays) on
    ``device`` (the card by default; ``"cpu"`` runs the plain versions)."""
    dev = resolve_device(device)
    _check_supported(config)
    timings: Dict[str, float] = {}
    with _stage("downsample", timings, dev):
        cs = PointCloud.from_points(source_pts, device=dev)
        ct = PointCloud.from_points(target_pts, device=dev)
        vs = voxel_downsample(cs, config.voxel_size)
        vt = voxel_downsample(ct, config.voxel_size)
        n_vs, n_vt = (int(x) for x in torch.stack([vs.mask.sum(),
                                                   vt.mask.sum()]).cpu())
        # one shared bucket for both clouds
        cap_d = max(bucket_size(n_vs), bucket_size(n_vt))
        ds = compact_device(vs, capacity=cap_d)
        dt = compact_device(vt, capacity=cap_d)
        bbx = float(cloud_bounds(ds).magnitude)

    with _stage("keypoints", timings, dev):
        fs_pca, ft_pca = pca_features_pair(
            ds, dt, radius=config.neighborhood_radius,
            cell_cap=config.pca_cell_cap, max_cells=config.pca_max_cells)
        rs = detect_keypoints(ds, config, fs_pca)
        rt = detect_keypoints(dt, config, ft_pca)
        mask_s_np, mask_t_np = rs.mask.cpu().numpy(), rt.mask.cpu().numpy()
        nks, nkt = int(mask_s_np.sum()), int(mask_t_np.sum())
        cap = keypoint_capacity or config.keypoint_capacity or bucket_size(
            max(nks, nkt, 1))
        use_stream = (config.streaming_cost == "on"
                      or (config.streaming_cost == "auto"
                          and cap > config.streaming_threshold))
        kp_s_idx, kp_s_mask, _ = _keypoint_arrays(mask_s_np, cap, dev)
        kp_t_idx, kp_t_mask, _ = _keypoint_arrays(mask_t_np, cap, dev)
        so = _morton_order_rows(ds.xyz[kp_s_idx], kp_s_mask)
        kp_s_idx, kp_s_mask = kp_s_idx[so], kp_s_mask[so]
        kp_s = ds.xyz[kp_s_idx]
        kp_t = dt.xyz[kp_t_idx]
        if config.refine_keypoints:
            rr = config.refine_radius or 3.0 * config.voxel_size
            cc_s, curv_s = compact_candidates(ds, fs_pca, rs.candidates)
            cc_t, curv_t = compact_candidates(dt, ft_pca, rt.candidates)
            kp_s = refine_positions(kp_s, kp_s_mask, cc_s, curv_s, radius=rr)
            kp_t = refine_positions(kp_t, kp_t_mask, cc_t, curv_t, radius=rr)

    mult = config.feature in MULT_FEATURES
    frames_s = frames_t = fd = stream = None
    with _stage("features", timings, dev):
        if config.feature == FeatureType.BSC:
            fs = extract_bsc(ds, kp_s, kp_s_mask, config,
                             num_variants=config.bsc_num_variants)
            ft = extract_bsc(dt, kp_t, kp_t_mask, config, num_variants=1)
            frames_s, frames_t = fs.frames, ft.frames
            if use_stream:
                stream = make_stream_features(fs.packed, ft.packed)
            else:
                fd = min_hamming_fd(fs.packed, ft.packed, fs.n_bits)
        elif config.feature == FeatureType.NONE:
            if use_stream:
                stream = NoFeatures(n_rows=cap)
            else:
                fd = torch.zeros((cap, cap), dtype=torch.float32, device=dev)
        elif config.feature == FeatureType.FPFH:
            radius = config.fpfh_radius or 3.0 * config.voxel_size
            k = max(config.fpfh_k, 24)
            desc_s = fpfh_features(ds, radius, k)[0][kp_s_idx]
            desc_t = fpfh_features(dt, radius, k)[0][kp_t_idx]
            if use_stream:
                stream = make_desc_features(desc_s, desc_t, "rows")
            else:
                fd = fpfh_similarity_matrix(desc_s, desc_t)
        else:
            kw = dict(radius=config.rops_radius or config.non_max_radius,
                      neighbor_k=config.rops_neighbor_k,
                      n_rotations=config.rops_rotations,
                      n_bins=config.rops_bins)
            desc_s = rops_features(ds, kp_s, kp_s_mask, **kw).desc
            desc_t = rops_features(dt, kp_t, kp_t_mask, **kw).desc
            if use_stream:
                stream = make_desc_features(desc_s, desc_t, "dims")
            else:
                fd = rops_similarity_matrix(desc_s, desc_t)

    T0 = None if initial_transform is None else torch.as_tensor(
        np.asarray(initial_transform, np.float32), device=dev)
    it_shift = 0.0
    if (T0 is None and config.coarse_init == "ransac"
            and config.feature != FeatureType.NONE):
        with _stage("coarse_init", timings, dev):
            tau = config.ransac_tau or 3.0 * config.voxel_size
            if use_stream:
                # candidates from one factor scan, over source rows strided
                # down to ransac_max_rows (the Morton order makes the
                # stride spatially uniform)
                rsel = torch.arange(0, cap, -(-cap // config.ransac_max_rows),
                                    device=dev)
                cand, cand_ok = stream_feature_candidates(
                    subset_rows(stream, rsel), kp_s_mask[rsel], kp_t_mask,
                    mult_blend=mult)
                rr_ = ransac_coarse_align(
                    kp_s[rsel], kp_s_mask[rsel], kp_t, kp_t_mask, None,
                    tau=tau, n_hyp=config.ransac_hypotheses,
                    frames_s=None if frames_s is None else frames_s[rsel],
                    frames_t=frames_t, cand=cand, cand_ok=cand_ok)
            else:
                # a similarity turns into a distance (smaller = closer)
                rr_ = ransac_coarse_align(kp_s, kp_s_mask, kp_t, kp_t_mask,
                                          1.0 - fd if mult else fd, tau=tau,
                                          n_hyp=config.ransac_hypotheses,
                                          n_cand=config.ransac_candidates,
                                          frames_s=frames_s,
                                          frames_t=frames_t)
            if rr_.inliers >= config.ransac_min_inliers:
                T0 = rr_.transform
                # skip the feature-dominant schedule phase (W_FD from e^-3)
                it_shift = 3.0 * config.weight_changing_rate

    with _stage("register", timings, dev):
        result = ghicp_register_chunked(
            kp_s, kp_s_mask, kp_t, kp_t_mask, fd, bbx, config,
            init_transform=T0, it_shift=it_shift, device=dev,
            iteration_callback=iteration_callback, stream=stream)
    return RegistrationOutput(
        transform=result.transform.cpu().numpy(), result=result,
        n_source_down=n_vs, n_target_down=n_vt,
        n_source_keypoints=nks, n_target_keypoints=nkt, timings=timings,
        keypoints_source=kp_s.cpu().numpy()[:min(nks, cap)],
        keypoints_target=kp_t.cpu().numpy()[:min(nkt, cap)],
        nms=tuple(dict(bucket=r.bucket, path=r.path, rounds=int(r.rounds))
                  for r in (rs, rt)),
        streaming=use_stream)


def transform_error(T_est: np.ndarray, T_gt: np.ndarray):
    """(rotation error in degrees, translation error in meters)."""
    dR = T_est[:3, :3] @ T_gt[:3, :3].T
    c = np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0)
    return (float(np.degrees(np.arccos(c))),
            float(np.linalg.norm(T_est[:3, 3] - T_gt[:3, 3])))
