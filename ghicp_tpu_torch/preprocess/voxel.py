"""Voxel-grid downsampling: one point per voxel, as a sort by (voxel
hash, index) plus a run-head mask.  The output keeps the input's capacity;
compaction happens between stages."""
from __future__ import annotations

import torch

from ghicp_tpu_torch.core.types import PointCloud, cloud_bounds
from ghicp_tpu_torch.preprocess.hashing import IMAX, cell_hash


def voxel_keys(xyz: torch.Tensor, min_xyz: torch.Tensor,
               voxel_size: float) -> torch.Tensor:
    """[N] int32 hash key of the voxel holding each point of ``xyz``
    [N, 3] (the cell hash the neighbor tables use, at ``voxel_size``)."""
    return cell_hash(xyz, min_xyz, voxel_size).to(torch.int32)


def voxel_downsample(cloud: PointCloud, voxel_size: float,
                     mode: str = "first") -> PointCloud:
    """One point per voxel; shape-preserving (the mask shrinks), the
    points in voxel-key order.  ``mode="first"`` keeps the voxel's live
    point of lowest original index; ``"centroid"`` puts the mean of the
    voxel's live points in its place."""
    if mode not in ("first", "centroid"):
        raise ValueError(f"voxel_downsample: unknown mode {mode!r}")
    bounds = cloud_bounds(cloud)
    keys = cell_hash(cloud.xyz, bounds.min_xyz, voxel_size)
    keys = torch.where(cloud.mask, keys, IMAX)
    sk, order = torch.sort(keys, stable=True)
    head = torch.ones_like(sk, dtype=torch.bool)
    head[1:] = sk[1:] != sk[:-1]
    live = cloud.mask[order]
    xyz = cloud.xyz[order]
    mask = head & live
    if mode == "centroid":
        # a voxel's float32 coordinates span far fewer bits than float64's
        # 53, so their float64 sums are exact in any order: the card's
        # scattered adds give the host's centroids to the bit
        run = torch.cumsum(head, 0) - 1
        lf = live.to(torch.float64)[:, None]
        sums = torch.zeros(xyz.shape, dtype=torch.float64,
                           device=xyz.device).index_add_(0, run,
                                                         xyz.double() * lf)
        cnts = torch.zeros_like(lf).index_add_(0, run, lf)
        centroid = (sums / torch.clamp(cnts, min=1.0)).to(torch.float32)
        xyz = torch.where(mask[:, None], centroid[run], xyz)
    return PointCloud(xyz=xyz, mask=mask)
