"""Voxel-grid downsampling: one point (the lowest original index) per
voxel, as a sort by (voxel hash, index) plus a run-head mask.  The output
keeps the input's capacity; compaction happens between stages."""
from __future__ import annotations

import torch

from ghicp_tpu_torch.core.types import PointCloud, cloud_bounds
from ghicp_tpu_torch.preprocess.hashing import IMAX, cell_hash


def voxel_downsample(cloud: PointCloud, voxel_size: float) -> PointCloud:
    """One point per voxel; shape-preserving (the mask shrinks)."""
    bounds = cloud_bounds(cloud)
    keys = cell_hash(cloud.xyz, bounds.min_xyz, voxel_size)
    keys = torch.where(cloud.mask, keys, IMAX)
    sk, order = torch.sort(keys, stable=True)
    head = torch.ones_like(sk, dtype=torch.bool)
    head[1:] = sk[1:] != sk[:-1]
    return PointCloud(xyz=cloud.xyz[order], mask=head & cloud.mask[order])
