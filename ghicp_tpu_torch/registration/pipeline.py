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
feature none has no coarse init (start it with ``initial_transform``,
or with ``identity_hypotheses > 1`` from schedule-shifted identity starts
picked by geometric consensus, RANSAC as the fallback).  Options:
adaptive keypoint counts, corner refinement, localization-aware BSC
(``bsc_offsets``: source encodings at small offsets stacked on the
variant axis) and 4-DoF (yaw-only) estimation.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ghicp_tpu_torch.core import trace
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
from ghicp_tpu_torch.preprocess.keypoints import (adaptive_detect,
                                                  compact_candidates,
                                                  detect_keypoints,
                                                  refine_positions,
                                                  refine_positions_corner)
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

    def final_correspondences(self) -> np.ndarray:
        """The final matched pairs as [M, 8] float64 rows (src_row,
        tgt_col, registered source xyz, target xyz): the last iteration's
        ``Corres.txt`` (km.cpp:144-162)."""
        matches = np.asarray(torch.as_tensor(self.result.matches).cpu())[
            :len(self.keypoints_source)]
        rows = np.nonzero(matches >= 0)[0]
        cols = matches[rows]
        sp = self.keypoints_source[rows]
        sp = sp @ self.transform[:3, :3].T + self.transform[:3, 3]
        tp = self.keypoints_target[cols]
        return np.concatenate([rows[:, None].astype(np.float64),
                               cols[:, None].astype(np.float64),
                               sp.astype(np.float64),
                               tp.astype(np.float64)], axis=1)

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


# localization-aware BSC: the source re-encoded at up to six offsets of
# bsc_offset_delta (or half the voxel) along the axes
BSC_OFFSETS = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
               (0, 0, -1))


def offset_encodings(ds: PointCloud, kp_s, kp_s_mask, fs,
                     config: GHICPConfig):
    """``fs`` with the source keypoints' BSC re-encoded at the first
    ``bsc_offsets - 1`` offsets, the packed words stacked on the variant
    axis ([bsc_offsets * V, S, W]): the min-over-variants Hamming FD then
    searches over the detector's localization error.  The frames stay the
    unshifted encoding's; the target stays single."""
    delta = config.bsc_offset_delta or 0.5 * config.voxel_size
    offs = torch.tensor(BSC_OFFSETS, dtype=torch.float32,
                        device=kp_s.device) * delta
    packs = [fs.packed]
    for o in offs[:config.bsc_offsets - 1]:
        packs.append(extract_bsc(ds, kp_s + o, kp_s_mask, config,
                                 num_variants=config.bsc_num_variants).packed)
    return fs._replace(packed=torch.cat(packs, dim=0))


def consensus_score(T, kp_sub, mask_sub, kp_t, mask_t, tau: float) -> int:
    """Source keypoints (the strided subset ``kp_sub``) with a target
    keypoint within ``tau`` under ``T``: the identity hypotheses' selector.
    The cross term is a float32 product (no TF32: at 25 m coordinates a
    reduced-precision cross term reads noise at the sub-voxel tau)."""
    p = kp_sub @ T[:3, :3].T + T[:3, 3]
    d2 = ((p * p).sum(dim=1)[:, None] + (kp_t * kp_t).sum(dim=1)[None, :]
          - 2.0 * torch.matmul(p, kp_t.T))
    d2 = torch.where(mask_t[None, :], d2, torch.inf).amin(dim=1)
    return int(((d2 < tau * tau) & mask_sub).sum())


def _refine(ds, dt, kp_s, kp_s_mask, kp_t, kp_t_mask, fs_pca, ft_pca, rs, rt,
            config: GHICPConfig):
    """Both clouds' keypoints refined below the voxel size: (kp_s, kp_t)."""
    rr = config.refine_radius or 3.0 * config.voxel_size
    if config.refine_method == "corner":
        return (refine_positions_corner(kp_s, kp_s_mask, ds, fs_pca,
                                        radius=rr),
                refine_positions_corner(kp_t, kp_t_mask, dt, ft_pca,
                                        radius=rr))
    cc_s, curv_s = compact_candidates(ds, fs_pca, rs.candidates)
    cc_t, curv_t = compact_candidates(dt, ft_pca, rt.candidates)
    return (refine_positions(kp_s, kp_s_mask, cc_s, curv_s, radius=rr),
            refine_positions(kp_t, kp_t_mask, cc_t, curv_t, radius=rr))


def register_pair(source_pts: np.ndarray, target_pts: np.ndarray,
                  config: GHICPConfig,
                  keypoint_capacity: Optional[int] = None,
                  initial_transform: Optional[np.ndarray] = None,
                  profile_dir: Optional[str] = None,
                  iteration_callback=None,
                  overhead_out: Optional[dict] = None, *,
                  device=None) -> RegistrationOutput:
    """Register ``source`` onto ``target`` (raw [n, 3] arrays) on
    ``device`` (the card by default; ``"cpu"`` runs the plain versions).

    ``profile_dir`` runs the call under ``torch.profiler`` (the host, and
    the card's kernels when it runs there) and writes a Chrome trace
    (``*.pt.trace.json``) into that directory; the stages and their
    parts (the keys of ``timings`` below of at most two names) show as
    ``pipeline.<path>`` ranges.
    ``iteration_callback(it, kps, matches)`` is called every
    ``config.engine_chunk`` engine iterations and at the loop's end;
    ``overhead_out`` (a dict) receives the engine's ``dispatch_overhead``
    (:func:`ghicp_register_chunked`).

    ``timings`` of the output: host seconds by dotted path
    (:mod:`ghicp_tpu_torch.core.trace`).  The stages ``downsample``,
    ``keypoints``, ``features``, ``coarse_init`` (absent without RANSAC)
    and ``register`` each include their device work (synchronised at the
    stage's end).  Under them: ``<path>.wait``, the host waiting on the
    card (its reads of device values and the stage's closing
    synchronisation); ``keypoints.pca`` / ``.detect`` / ``.slots`` /
    ``.refine``; ``features.describe`` / ``.fd``; ``register.solve`` (every
    engine iteration's matching solve; on the streaming lane with
    ``.sweep``, ``.compact`` and ``.resolve``), ``register.estimate`` (the
    matched statistics, the estimator and the convergence test) and
    ``register.final`` (the one-to-one final matching).  A path sums every
    visit; a path's children never sum to more than it."""
    dev = resolve_device(device)
    if profile_dir is not None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            out = register_pair(source_pts, target_pts, config,
                                keypoint_capacity, initial_transform, None,
                                iteration_callback, overhead_out, device=dev)
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            profile_dir,
            f"register_pair.{os.getpid()}.{time.time_ns()}.pt.trace.json"))
        return out
    timings: Dict[str, float] = {}
    with trace.record(timings):
        return _register(source_pts, target_pts, config, keypoint_capacity,
                         initial_transform, iteration_callback, overhead_out,
                         dev, timings)


def _register(source_pts, target_pts, config: GHICPConfig, keypoint_capacity,
              initial_transform, iteration_callback, overhead_out,
              dev: torch.device, timings: Dict[str, float]
              ) -> RegistrationOutput:
    """:func:`register_pair`'s stages, under the active trace record
    ``timings``."""
    with trace.stage("downsample", dev):
        cs = PointCloud.from_points(source_pts, device=dev)
        ct = PointCloud.from_points(target_pts, device=dev)
        vs = voxel_downsample(cs, config.voxel_size)
        vt = voxel_downsample(ct, config.voxel_size)
        with trace.wait():
            counts = torch.stack([vs.mask.sum(), vt.mask.sum()]).cpu()
        n_vs, n_vt = (int(x) for x in counts)
        # one shared bucket for both clouds
        cap_d = max(bucket_size(n_vs), bucket_size(n_vt))
        ds = compact_device(vs, capacity=cap_d)
        dt = compact_device(vt, capacity=cap_d)
        bbx = trace.read(float, cloud_bounds(ds).magnitude)

    with trace.stage("keypoints", dev):
        fs_pca = ft_pca = None
        if config.adaptive_keypoints:
            # (no refinement below: the JAX package's adaptive path keeps
            # its PCA to itself)
            with trace.span("detect"):
                rs = adaptive_detect(ds, config)
                rt = adaptive_detect(dt, config)
        else:
            with trace.span("pca"):
                fs_pca, ft_pca = pca_features_pair(
                    ds, dt, radius=config.neighborhood_radius,
                    cell_cap=config.pca_cell_cap,
                    max_cells=config.pca_max_cells)
            with trace.span("detect"):
                rs = detect_keypoints(ds, config, fs_pca)
                rt = detect_keypoints(dt, config, ft_pca)
        with trace.wait():
            mask_s_np, mask_t_np = rs.mask.cpu().numpy(), rt.mask.cpu().numpy()
        nks, nkt = int(mask_s_np.sum()), int(mask_t_np.sum())
        cap = keypoint_capacity or config.keypoint_capacity or bucket_size(
            max(nks, nkt, 1))
        use_stream = (config.streaming_cost == "on"
                      or (config.streaming_cost == "auto"
                          and cap > config.streaming_threshold))
        # the keypoint slots, the source rows in Morton order
        with trace.span("slots"):
            kp_s_idx, kp_s_mask, _ = _keypoint_arrays(mask_s_np, cap, dev)
            kp_t_idx, kp_t_mask, _ = _keypoint_arrays(mask_t_np, cap, dev)
            so = _morton_order_rows(ds.xyz[kp_s_idx], kp_s_mask)
            kp_s_idx, kp_s_mask = kp_s_idx[so], kp_s_mask[so]
            kp_s = ds.xyz[kp_s_idx]
            kp_t = dt.xyz[kp_t_idx]
        if config.refine_keypoints and fs_pca is not None:
            with trace.span("refine"):
                kp_s, kp_t = _refine(ds, dt, kp_s, kp_s_mask, kp_t, kp_t_mask,
                                     fs_pca, ft_pca, rs, rt, config)

    mult = config.feature in MULT_FEATURES
    frames_s = frames_t = fd = stream = None
    with trace.stage("features", dev):
        with trace.span("describe"):
            if config.feature == FeatureType.BSC:
                fs = extract_bsc(ds, kp_s, kp_s_mask, config,
                                 num_variants=config.bsc_num_variants)
                if config.bsc_offsets > 1:
                    fs = offset_encodings(ds, kp_s, kp_s_mask, fs, config)
                ft = extract_bsc(dt, kp_t, kp_t_mask, config, num_variants=1)
                frames_s, frames_t = fs.frames, ft.frames
            elif config.feature == FeatureType.FPFH:
                radius = config.fpfh_radius or 3.0 * config.voxel_size
                k = max(config.fpfh_k, 24)
                desc_s = fpfh_features(ds, radius, k)[0][kp_s_idx]
                desc_t = fpfh_features(dt, radius, k)[0][kp_t_idx]
            elif config.feature == FeatureType.ROPS:
                kw = dict(radius=config.rops_radius or config.non_max_radius,
                          neighbor_k=config.rops_neighbor_k,
                          n_rotations=config.rops_rotations,
                          n_bins=config.rops_bins)
                desc_s = rops_features(ds, kp_s, kp_s_mask, **kw).desc
                desc_t = rops_features(dt, kp_t, kp_t_mask, **kw).desc
        with trace.span("fd"):
            if config.feature == FeatureType.BSC:
                if use_stream:
                    stream = make_stream_features(fs.packed, ft.packed,
                                                  fs.n_bits)
                else:
                    fd = min_hamming_fd(fs.packed, ft.packed, fs.n_bits)
            elif config.feature == FeatureType.NONE:
                if use_stream:
                    stream = NoFeatures(n_rows=cap)
                else:
                    fd = torch.zeros((cap, cap), dtype=torch.float32,
                                     device=dev)
            elif use_stream:
                stream = make_desc_features(
                    desc_s, desc_t,
                    "rows" if config.feature == FeatureType.FPFH else "dims")
            elif config.feature == FeatureType.FPFH:
                fd = fpfh_similarity_matrix(desc_s, desc_t)
            else:
                fd = rops_similarity_matrix(desc_s, desc_t)

    T0 = None if initial_transform is None else torch.as_tensor(
        np.asarray(initial_transform, np.float32), device=dev)
    it_shift = 0.0
    if (T0 is None and config.coarse_init == "ransac"
            and config.feature != FeatureType.NONE):
        with trace.stage("coarse_init", dev):
            tau = config.ransac_tau or 3.0 * config.voxel_size
            if use_stream:
                # candidates from one factor scan, over source rows strided
                # down to ransac_max_rows (the Morton order makes the
                # stride spatially uniform)
                rsel = torch.arange(0, cap, -(-cap // config.ransac_max_rows),
                                    device=dev)
                cand, cand_ok = stream_feature_candidates(
                    subset_rows(stream, rsel), kp_s_mask[rsel], kp_t_mask)
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

    identity = (T0 is None and config.coarse_init == "none"
                and config.identity_hypotheses > 1)
    with trace.stage("register", dev):
        if identity:
            # schedule-shifted identity starts explore distinct basins of
            # the FD-dominated early phase; the geometric consensus (rows
            # within 3 voxels of a target keypoint), not the matched RMSE,
            # picks the winner
            rate = config.weight_changing_rate
            shifts = (0.0, rate, 3.0 * rate)[:config.identity_hypotheses]
            stride = max(kp_s.shape[0] // 2048, 1)
            kp_sub, mask_sub = kp_s[::stride], kp_s_mask[::stride]
            result, best_score = None, -1
            for sh in shifts:
                cand = ghicp_register_chunked(
                    kp_s, kp_s_mask, kp_t, kp_t_mask, fd, bbx, config,
                    chunk=config.engine_chunk, init_transform=None,
                    it_shift=sh, stream=stream,
                    iteration_callback=iteration_callback,
                    overhead_out=overhead_out, device=dev)
                score = consensus_score(cand.transform, kp_sub, mask_sub,
                                        kp_t, kp_t_mask,
                                        3.0 * config.voxel_size)
                if score > best_score:
                    result, best_score = cand, score
            n_sub = int(mask_sub.sum())
        else:
            result = ghicp_register_chunked(
                kp_s, kp_s_mask, kp_t, kp_t_mask, fd, bbx, config,
                chunk=config.engine_chunk, init_transform=T0,
                it_shift=it_shift, stream=stream,
                iteration_callback=iteration_callback,
                overhead_out=overhead_out, device=dev)
    if identity and best_score < (0.55 * config.estimated_overlap
                                  * max(n_sub, 1)):
        # no hypothesis verified: the feature-guided RANSAC pipeline as
        # the last hypothesis (a correct pose scores ~0.70 of the rows at
        # full overlap, a wrong basin ~0.37)
        return register_pair(
            source_pts, target_pts,
            dataclasses.replace(config, coarse_init="ransac",
                                identity_hypotheses=1),
            keypoint_capacity, None, None, iteration_callback, overhead_out,
            device=dev)
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
